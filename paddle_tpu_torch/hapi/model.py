"""``Model``, the high-level train / eval / predict facade (counterpart of
paddle_tpu/hapi/model.py).

``prepare(optimizer, loss, metrics)``, then ``train_batch`` /
``eval_batch`` / ``predict_batch`` on one batch and ``fit`` / ``evaluate``
/ ``predict`` over a ``Dataset``, a ``DataLoader`` or any iterable of
batches, with the callbacks of ``hapi.callbacks``; ``save`` / ``load``
write and read ``<path>.pdparams`` (the network's ``state_dict``) and
``<path>.pdopt`` (the optimizer's) through ``framework.io``. A train step
is the reference's eager one: forward, loss, ``backward``, ``step``,
``clear_grad``, then the metrics on the host. Batches move to the
network's device (the device of its first parameter): a ``Dataset`` is
wrapped in a ``DataLoader`` on that device, and a batch that is not there
yet is moved. Outputs of ``predict`` come back as numpy arrays (bfloat16
and float16 ones widened to float32).

Under ``amp.auto_cast`` the caller's context reaches the network's
forward and the loss as the reference's dispatcher sees it; ``Model``
itself applies no AMP. Arguments the reference accepts and never applies
raise ``NotImplementedError`` for any value but the default ("Faults of
the reference" 19 in ROADMAP.md): ``Model``'s ``inputs`` and ``labels``,
``prepare``'s ``amp_configs``, ``load``'s ``skip_mismatch``,
``predict``'s ``callbacks`` and ``verbose`` and ``summary``'s
``input_size`` and ``dtype``.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..framework.io import load as _load
from ..framework.io import save as _save
from ..metric import Metric
from .callbacks import config_callbacks


def _refuse(what, name, value):
    raise NotImplementedError(
        "%s(%s=%r): the reference accepts it and never applies it "
        "(\"Faults of the reference\" 19 in ROADMAP.md)" % (what, name, value))


def _to_list(x):
    if x is None:
        return []
    if isinstance(x, (list, tuple)):
        return list(x)
    return [x]


def _to_tensor(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device)
    arr = np.asarray(x)
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    return torch.as_tensor(arr, device=device)


def _numpy(t):
    t = t.detach()
    if t.dtype in (torch.bfloat16, torch.float16):
        t = t.float()
    return t.cpu().numpy()


class Model:
    """Trainer facade over a network (an ``nn.Module``)."""

    def __init__(self, network, inputs=None, labels=None):
        for name, value in (("inputs", inputs), ("labels", labels)):
            if value is not None:
                _refuse("Model", name, value)
        self.network = network
        self._optimizer = None
        self._loss = None
        self._metrics = []
        self.stop_training = False

    def _device(self):
        return next(self.network.parameters()).device

    # -- setup ---------------------------------------------------------------
    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None):
        if amp_configs is not None:
            _refuse("Model.prepare", "amp_configs", amp_configs)
        self._optimizer = optimizer
        self._loss = loss
        for m in _to_list(metrics):
            if not isinstance(m, Metric):
                raise TypeError("metric must be paddle_tpu_torch.metric."
                                "Metric")
        self._metrics = _to_list(metrics)
        return self

    # -- one batch -----------------------------------------------------------
    def train_batch(self, inputs, labels=None):
        self.network.train()
        dev = self._device()
        inputs = [_to_tensor(x, dev) for x in _to_list(inputs)]
        labels = [_to_tensor(y, dev) for y in _to_list(labels)]
        outs = self.network(*inputs)
        loss = self._compute_loss(outs, labels)
        loss.backward()
        self._optimizer.step()
        self._optimizer.clear_grad()
        metrics = self._update_metrics(outs, labels)
        return self._named_outputs(loss, metrics)

    def eval_batch(self, inputs, labels=None):
        self.network.eval()
        dev = self._device()
        with torch.no_grad():
            inputs = [_to_tensor(x, dev) for x in _to_list(inputs)]
            labels = [_to_tensor(y, dev) for y in _to_list(labels)]
            outs = self.network(*inputs)
            loss = self._compute_loss(outs, labels)
        metrics = self._update_metrics(outs, labels)
        return self._named_outputs(loss, metrics)

    def predict_batch(self, inputs):
        self.network.eval()
        dev = self._device()
        with torch.no_grad():
            inputs = [_to_tensor(x, dev) for x in _to_list(inputs)]
            outs = self.network(*inputs)
        return [_numpy(o) for o in _to_list(outs)]

    def _compute_loss(self, outs, labels):
        outs_l = _to_list(outs)
        if self._loss is None:
            return outs_l[0]   # the network computed its own loss
        return self._loss(*(outs_l + labels))

    def _update_metrics(self, outs, labels):
        res = {}
        outs_l = _to_list(outs)
        for m in self._metrics:
            interm = m.compute(*(outs_l + labels))
            m.update(*_to_list(interm))
            name = m.name()
            name = name[0] if isinstance(name, (list, tuple)) else name
            res[name] = m.accumulate()
        return res

    def _named_outputs(self, loss, metrics):
        logs = {"loss": float(loss.detach())}
        logs.update(metrics)
        return logs

    # -- loops ---------------------------------------------------------------
    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1, verbose=1,
            shuffle=True, callbacks=None, num_workers=0, drop_last=False):
        train_loader = self._make_loader(train_data, batch_size, shuffle,
                                         num_workers, drop_last)
        eval_loader = (self._make_loader(eval_data, batch_size, False,
                                         num_workers, False)
                       if eval_data is not None else None)
        steps = len(train_loader) if hasattr(train_loader, "__len__") \
            else None
        cbks = config_callbacks(
            callbacks, model=self, epochs=epochs, steps=steps,
            verbose=verbose, log_freq=log_freq, save_freq=save_freq,
            save_dir=save_dir, metrics=[m.name() for m in self._metrics])
        self.stop_training = False
        cbks.on_train_begin()
        history = []
        for epoch in range(epochs):
            if self.stop_training:
                break
            cbks.on_epoch_begin(epoch)
            for m in self._metrics:
                m.reset()
            logs = {}
            for step, batch in enumerate(train_loader):
                cbks.on_train_batch_begin(step)
                ins, lbl = self._split_batch(batch)
                logs = self.train_batch(ins, lbl)
                cbks.on_train_batch_end(step, logs)
            cbks.on_epoch_end(epoch, logs)
            history.append(logs)
            if eval_loader is not None and (epoch + 1) % eval_freq == 0:
                self.evaluate(eval_loader, callbacks=cbks, _inner=True)
        cbks.on_train_end()
        return history

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=1,
                 num_workers=0, callbacks=None, _inner=False):
        loader = self._make_loader(eval_data, batch_size, False, num_workers,
                                   False)
        cbks = callbacks if _inner else config_callbacks(
            callbacks, model=self, verbose=verbose, log_freq=log_freq)
        for m in self._metrics:
            m.reset()
        cbks.on_eval_begin()
        logs, losses = {}, []
        for step, batch in enumerate(loader):
            cbks.on_eval_batch_begin(step)
            ins, lbl = self._split_batch(batch)
            logs = self.eval_batch(ins, lbl)
            losses.append(logs["loss"])
            cbks.on_eval_batch_end(step, logs)
        if losses:
            logs["loss"] = float(np.mean(losses))
        cbks.on_eval_end(logs)
        return logs

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, callbacks=None, verbose=0):
        for name, value, default in (("callbacks", callbacks, None),
                                     ("verbose", verbose, 0)):
            if value != default:
                _refuse("Model.predict", name, value)
        loader = self._make_loader(test_data, batch_size, False, num_workers,
                                   False)
        outputs = []
        for batch in loader:
            # a labelled dataset's (x, ..., y): the label is dropped
            ins, _ = self._split_batch(batch)
            outputs.append(self.predict_batch(ins))
        if not outputs:
            return []
        n_out = len(outputs[0])
        grouped = [[o[i] for o in outputs] for i in range(n_out)]
        if stack_outputs:
            grouped = [np.concatenate(g, axis=0) for g in grouped]
        return grouped

    def _make_loader(self, data, batch_size, shuffle, num_workers,
                     drop_last):
        from ..io import DataLoader, Dataset

        if data is None:
            return []
        if isinstance(data, DataLoader):
            return data
        if isinstance(data, Dataset):
            return DataLoader(data, batch_size=batch_size, shuffle=shuffle,
                              num_workers=num_workers, drop_last=drop_last,
                              device=self._device())
        return data   # an iterable of batches

    def _split_batch(self, batch, has_labels=True):
        if isinstance(batch, (list, tuple)):
            if has_labels and len(batch) >= 2:
                return list(batch[:-1]), [batch[-1]]
            return list(batch), []
        return [batch], []

    # -- persistence ---------------------------------------------------------
    def save(self, path, training=True):
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        _save(self.network.state_dict(), path + ".pdparams")
        if training and self._optimizer is not None:
            _save(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        if skip_mismatch:
            _refuse("Model.load", "skip_mismatch", skip_mismatch)
        dev = self._device()
        self.network.load_state_dict(_load(path + ".pdparams", device=dev))
        opt_path = path + ".pdopt"
        if (not reset_optimizer and self._optimizer is not None
                and os.path.exists(opt_path)):
            self._optimizer.set_state_dict(_load(opt_path, device=dev))

    # -- introspection -------------------------------------------------------
    def parameters(self, *args, **kwargs):
        return self.network.parameters(*args, **kwargs)

    def summary(self, input_size=None, dtype=None):
        """Print each parameter's name, shape and size and the total;
        returns ``{"total_params": N}``."""
        for name, value in (("input_size", input_size), ("dtype", dtype)):
            if value is not None:
                _refuse("Model.summary", name, value)
        lines, total = [], 0
        for name, p in self.network.named_parameters():
            n = p.numel()
            total += n
            lines.append("%-40s %-20s %d" % (name, list(p.shape), n))
        print("\n".join(lines) + "\nTotal params: %d" % total)
        return {"total_params": total}


def summary(net, input_size=None, dtypes=None):
    """``Model(net).summary(input_size, dtypes)`` (the reference's
    top-level ``summary``)."""
    model = net if isinstance(net, Model) else Model(net)
    return model.summary(input_size, dtypes)
