"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu for one H100.

The JAX package (``paddle_tpu``) is the reference this port is held
against; the port imports nothing from it and never imports ``jax``. It
keeps the reference's module layout, so each module here names its
counterpart there. Plain tensor work is PyTorch; every Pallas kernel of
the reference becomes a hand-written CUDA kernel for ``sm_90a`` under
``csrc/``, built at first use (``_build.py``).

Entry points run on the card unless the caller passes ``device="cpu"``
(``device.resolve_device``). The reference runs float32 matmuls at
'highest' precision, so TF32 is turned off here for both cuBLAS and
cuDNN: the two packages then compute comparable float32 numbers. Its
bfloat16 and float16 products sum in float32, so cuBLAS is also told not
to sum a bf16 or float16 GEMM's split-K partials in the narrow type, which
PyTorch allows by default (``allow_bf16_reduced_precision_reduction``,
``allow_fp16_reduced_precision_reduction``).

The training front end sits at the top, as in the reference: ``save`` /
``load`` (``framework.io``), ``Model`` / ``summary`` / ``flops``
(``hapi``), and the ``amp``, ``io``, ``metric`` and ``callbacks``
modules.
"""
import torch

from .device import resolve_device

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False

from . import amp, callbacks, hapi, io, metric  # noqa: E402
from .framework.io import load, save  # noqa: E402
from .hapi import Model, flops, summary  # noqa: E402

__all__ = ["Model", "amp", "callbacks", "flops", "hapi", "io", "load",
           "metric", "resolve_device", "save", "summary"]
