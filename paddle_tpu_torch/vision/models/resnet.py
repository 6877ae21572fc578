"""The ResNet family (counterpart of paddle_tpu/vision/models/resnet.py).

``ResNet(block, depth, width, num_classes, with_pool, groups,
data_format)`` with ``BasicBlock`` (18, 34) or ``BottleneckBlock`` (50,
101, 152); the ResNeXt and wide factories are the same class with other
``groups`` and ``width``. Sublayer names are the reference's (``conv1``,
``bn1``, ``layer1.0.conv1``, ``layer1.0.downsample.0``,
``layer4.2.bn3._variance``, ``fc``), so ``models.convert.load_jax_state``
carries a reference ResNet's ``functional_state()``, running statistics
included, across unchanged. Convolutions have no bias; every batch norm
keeps its running statistics as buffers (``nn/layers/norm.py``).

``data_format="NHWC"`` takes and gives channel-last tensors; the weights
are the same either way (``[out, in, kh, kw]``), and each layer moves the
channels to axis 1 as a view (channels-last memory, which cuDNN and
torch's batch norm take as they are) and back. ``with_pool=False`` leaves
out the global average pool, ``num_classes=0`` the classifier.

Weights are drawn from ``generator`` (a ``torch.Generator`` on ``device``;
seed 0 when omitted) with the reference's laws; ``device`` defaults to the
card and raises without one. ``pretrained=True`` raises: it would need a
download.
"""
from __future__ import annotations

import functools

import torch
from torch import nn as tnn

from ... import nn
from ...core.tensor import name_parameters
from ...device import resolve_device

LAYERS = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3],
          101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}


def _kw(generator, device, dtype):
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    return dict(generator=generator, device=device, dtype=dtype)


def _norm(norm_layer, data_format, kw):
    return norm_layer or functools.partial(
        nn.BatchNorm2D, data_format=data_format, device=kw["device"],
        dtype=kw["dtype"])


class BasicBlock(tnn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 groups=1, base_width=64, dilation=1, norm_layer=None,
                 data_format="NCHW", *, generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        kw = _kw(generator, device, dtype)
        norm_layer = _norm(norm_layer, data_format, kw)
        self.conv1 = nn.Conv2D(inplanes, planes, 3, stride=stride, padding=1,
                               bias_attr=False, data_format=data_format,
                               **kw)
        self.bn1 = norm_layer(planes)
        self.relu = nn.ReLU()
        self.conv2 = nn.Conv2D(planes, planes, 3, padding=1, bias_attr=False,
                               data_format=data_format, **kw)
        self.bn2 = norm_layer(planes)
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class BottleneckBlock(tnn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 groups=1, base_width=64, dilation=1, norm_layer=None,
                 data_format="NCHW", *, generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        kw = _kw(generator, device, dtype)
        norm_layer = _norm(norm_layer, data_format, kw)
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = nn.Conv2D(inplanes, width, 1, bias_attr=False,
                               data_format=data_format, **kw)
        self.bn1 = norm_layer(width)
        self.conv2 = nn.Conv2D(width, width, 3, padding=dilation,
                               stride=stride, groups=groups,
                               dilation=dilation, bias_attr=False,
                               data_format=data_format, **kw)
        self.bn2 = norm_layer(width)
        self.conv3 = nn.Conv2D(width, planes * self.expansion, 1,
                               bias_attr=False, data_format=data_format,
                               **kw)
        self.bn3 = norm_layer(planes * self.expansion)
        self.relu = nn.ReLU()
        self.downsample = downsample

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class ResNet(tnn.Module):
    def __init__(self, block, depth=50, width=64, num_classes=1000,
                 with_pool=True, groups=1, data_format="NCHW", *,
                 generator=None, device=None, dtype=torch.float32):
        super().__init__()
        self._kw = kw = _kw(generator, device, dtype)
        layers = LAYERS[depth]
        self.data_format = data_format
        self.groups = groups
        self.base_width = width
        self.num_classes = num_classes
        self.with_pool = with_pool
        self._norm_layer = _norm(None, data_format, kw)
        self.inplanes = 64
        self.dilation = 1
        self.conv1 = nn.Conv2D(3, self.inplanes, 7, stride=2, padding=3,
                               bias_attr=False, data_format=data_format,
                               **kw)
        self.bn1 = self._norm_layer(self.inplanes)
        self.relu = nn.ReLU()
        self.maxpool = nn.MaxPool2D(3, stride=2, padding=1,
                                    data_format=data_format)
        self.layer1 = self._make_layer(block, 64, layers[0])
        self.layer2 = self._make_layer(block, 128, layers[1], stride=2)
        self.layer3 = self._make_layer(block, 256, layers[2], stride=2)
        self.layer4 = self._make_layer(block, 512, layers[3], stride=2)
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D((1, 1),
                                                data_format=data_format)
        if num_classes > 0:
            self.fc = nn.Linear(512 * block.expansion, num_classes, **kw)
        del self._kw
        name_parameters(self)

    def _make_layer(self, block, planes, blocks, stride=1):
        kw = self._kw
        norm_layer = self._norm_layer
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = nn.Sequential(
                nn.Conv2D(self.inplanes, planes * block.expansion, 1,
                          stride=stride, bias_attr=False,
                          data_format=self.data_format, **kw),
                norm_layer(planes * block.expansion))
        layers = [block(self.inplanes, planes, stride, downsample,
                        self.groups, self.base_width, 1, norm_layer,
                        data_format=self.data_format, **kw)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes, groups=self.groups,
                                base_width=self.base_width,
                                norm_layer=norm_layer,
                                data_format=self.data_format, **kw))
        return nn.Sequential(*layers)

    def forward(self, x):
        x = self.relu(self.bn1(self.conv1(x)))
        x = self.maxpool(x)
        x = self.layer1(x)
        x = self.layer2(x)
        x = self.layer3(x)
        x = self.layer4(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.fc(x.flatten(1))
        return x


def _resnet(block, depth, pretrained, **kwargs):
    if pretrained:
        raise NotImplementedError(
            "pretrained=True needs a download of the reference's weights; "
            "build with random weights and load them with "
            "models.convert.load_jax_state")
    return ResNet(block, depth, **kwargs)


def resnet18(pretrained=False, **kwargs):
    return _resnet(BasicBlock, 18, pretrained, **kwargs)


def resnet34(pretrained=False, **kwargs):
    return _resnet(BasicBlock, 34, pretrained, **kwargs)


def resnet50(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 50, pretrained, **kwargs)


def resnet101(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 101, pretrained, **kwargs)


def resnet152(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 152, pretrained, **kwargs)


def _resnext(depth, groups, width, pretrained, **kwargs):
    kwargs.setdefault("groups", groups)
    kwargs.setdefault("width", width)
    return _resnet(BottleneckBlock, depth, pretrained, **kwargs)


def resnext50_32x4d(pretrained=False, **kwargs):
    return _resnext(50, 32, 4, pretrained, **kwargs)


def resnext50_64x4d(pretrained=False, **kwargs):
    return _resnext(50, 64, 4, pretrained, **kwargs)


def resnext101_32x4d(pretrained=False, **kwargs):
    return _resnext(101, 32, 4, pretrained, **kwargs)


def resnext101_64x4d(pretrained=False, **kwargs):
    return _resnext(101, 64, 4, pretrained, **kwargs)


def resnext152_32x4d(pretrained=False, **kwargs):
    return _resnext(152, 32, 4, pretrained, **kwargs)


def resnext152_64x4d(pretrained=False, **kwargs):
    return _resnext(152, 64, 4, pretrained, **kwargs)


def wide_resnet50_2(pretrained=False, **kwargs):
    kwargs.setdefault("width", 128)
    return _resnet(BottleneckBlock, 50, pretrained, **kwargs)


def wide_resnet101_2(pretrained=False, **kwargs):
    kwargs.setdefault("width", 128)
    return _resnet(BottleneckBlock, 101, pretrained, **kwargs)
