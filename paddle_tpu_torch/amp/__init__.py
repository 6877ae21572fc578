"""Automatic mixed precision (counterpart of paddle_tpu/amp/__init__.py).

``auto_cast`` (``amp_guard``) at level O1 in bfloat16 or float16, with the
reference's white and black lists, custom lists and thread-local state;
``decorate``; and ``GradScaler`` with the reference's scaling rules.

The cast point. The reference casts at its dispatcher, by the primitive's
name (``paddle_tpu/core/dispatch.py:205-209``): the Tensor arguments of a
top-level primitive call are cast down to the AMP dtype when its name is
on the white list and up to float32 when it is on the black list and the
tensor is bfloat16 or float16; primitives nested inside another see raw
arrays. The port has no dispatcher, so each port function whose reference
counterpart is a primitive of a listed name calls ``cast_inputs(name,
...)`` at its head (one thread-local read when AMP is off). Their names are
``CAST_POINTS``. A custom list that names an operation without a cast
point raises ``NotImplementedError`` when ``auto_cast`` is entered: the
port writes those operations as plain torch calls, which nothing would
cast.

O2 is not ported: the reference's O2 casts every primitive not on the
black list, the Tensor dunders (``add``, ``multiply``) of model code
included, and the port writes those as raw torch operations; an exact O2
needs the op layer of ROADMAP A.5. ``auto_cast(level="O2")`` raises.
``decorate`` (a cast of a model's parameters and buffers to the AMP
dtype, as the reference's ``Layer.to``) with O1 is the pure low-precision
path.

``GradScaler`` is not ``torch.cuda.amp.GradScaler``: it keeps the
reference's rules. It scales whenever it is enabled, bfloat16 included;
``unscale_`` writes the unscaled gradient into every parameter even when
a step is then skipped; the scale falls by ``decr_ratio`` after
``decr_every_n_nan_or_inf`` consecutive bad steps, never below 1.0, and
grows by ``incr_ratio`` after ``incr_every_n_steps`` consecutive good
ones. It finds a non-finite gradient with one reduction a gradient and a
single host sync, where the reference syncs once a parameter; the result
is the same.

Arguments the reference accepts and never applies raise
``NotImplementedError`` for any value but the default ("Faults of the
reference" in ROADMAP.md C): ``auto_cast``'s ``level`` other than O1 and
O2 (13), ``decorate``'s ``level`` other than O2, ``master_weight`` and
``save_dtype`` (14).
"""
from __future__ import annotations

import threading
from contextlib import contextmanager

import torch

from ..device import resolve_device

_state = threading.local()

# O1 lists (the reference's, paddle_tpu/amp/__init__.py:22-32)
WHITE_LIST = {
    "matmul", "mm", "bmm", "mv", "conv1d", "conv2d", "conv3d", "linear",
    "einsum", "addmm",
}
BLACK_LIST = {
    "exp", "log", "log2", "log10", "log1p", "softmax", "log_softmax",
    "cross_entropy", "nll_loss", "mean", "sum", "norm", "layer_norm",
    "rms_norm", "batch_norm_train", "batch_norm_infer", "cumsum",
    "logsumexp",
}
# the listed operations whose port functions cast their inputs
CAST_POINTS = frozenset({
    "linear", "conv1d", "conv2d", "conv3d", "softmax", "log_softmax",
    "cross_entropy", "nll_loss", "layer_norm", "rms_norm",
    "batch_norm_train", "batch_norm_infer",
})
_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           torch.bfloat16: torch.bfloat16, torch.float16: torch.float16}
_HALF = (torch.bfloat16, torch.float16)


def _amp_dtype(dtype):
    try:
        return _DTYPES[dtype]
    except (KeyError, TypeError):
        raise ValueError("amp: dtype must be bfloat16 or float16, got %r"
                         % (dtype,)) from None


def amp_state():
    """The active ``auto_cast`` state of this thread, or None."""
    return getattr(_state, "amp", None)


@contextmanager
def state_scope(state):
    """Run a block under ``state`` (an ``amp_state()`` taken earlier, or
    None), restoring this thread's own state after: a recomputed forward
    runs under the AMP state of the forward it repeats."""
    prev = amp_state()
    _state.amp = state
    try:
        yield
    finally:
        _state.amp = prev


@contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16"):
    state = None
    if enable:
        if level == "O2":
            raise NotImplementedError(
                "auto_cast(level='O2'): the reference's O2 casts every "
                "operation off the black list, the Tensor operators of "
                "model code included, which the port writes as plain torch "
                "calls; it waits for the op layer (ROADMAP.md A.5)")
        if level != "O1":
            raise NotImplementedError(
                "auto_cast(level=%r): the reference casts as at O1 for "
                "every level but O2 (\"Faults of the reference\" 13 in "
                "ROADMAP.md); pass level='O1' or enable=False" % (level,))
        custom = set(custom_white_list or ()) | set(custom_black_list or ())
        missing = sorted(custom - CAST_POINTS)
        if missing:
            raise NotImplementedError(
                "auto_cast: %s %s no cast point in the port (it casts at %s)"
                % (", ".join(missing), "has" if len(missing) == 1 else
                   "have", ", ".join(sorted(CAST_POINTS))))
        white = set(WHITE_LIST)
        black = set(BLACK_LIST)
        if custom_white_list:
            white |= set(custom_white_list)
            black -= set(custom_white_list)
        if custom_black_list:
            black |= set(custom_black_list)
            white -= set(custom_black_list)
        state = {"level": level, "dtype": _amp_dtype(dtype),
                 "white": frozenset(white), "black": frozenset(black)}
    with state_scope(state):
        yield


amp_guard = auto_cast


def cast_inputs(op_name, *tensors):
    """``tensors`` as the reference's dispatcher hands them to the
    primitive ``op_name`` under the active ``auto_cast``: each floating
    tensor cast to the AMP dtype on the white list, each bfloat16 or
    float16 one to float32 on the black list; anything else (None,
    integers, numbers) as it is. Returns a tuple."""
    st = getattr(_state, "amp", None)
    if st is None:
        return tensors
    if op_name in st["white"]:
        dt = st["dtype"]
        return tuple(t.to(dt) if isinstance(t, torch.Tensor)
                     and t.is_floating_point() and t.dtype != dt else t
                     for t in tensors)
    if op_name in st["black"]:
        return tuple(t.float() if isinstance(t, torch.Tensor)
                     and t.dtype in _HALF else t for t in tensors)
    return tensors


def decorate(models=None, optimizers=None, level="O2", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """Cast each model's parameters and buffers to ``dtype`` (the
    reference's ``Layer.to``); returns the model(s), and the optimizers
    as given when there are any. The optimizers' slots are float32
    already."""
    for name, value, default in (("level", level, "O2"),
                                 ("master_weight", master_weight, None),
                                 ("save_dtype", save_dtype, None)):
        if value != default:
            raise NotImplementedError(
                "decorate(%s=%r): the reference accepts it and never "
                "applies it (\"Faults of the reference\" 14 in ROADMAP.md)"
                % (name, value))
    if models is None:
        return None
    dt = _amp_dtype(dtype)
    single = not isinstance(models, (list, tuple))
    ms = [models] if single else list(models)
    for m in ms:
        m.to(dtype=dt)
    out = ms[0] if single else ms
    if optimizers is None:
        return out
    return out, optimizers


class GradScaler:
    """Dynamic loss scaling by the reference's rules (see the module's
    docstring)."""

    def __init__(self, enable=True, init_loss_scaling=2.0**15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=2, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False

    def is_enable(self):
        return self._enable

    def scale(self, var):
        if not self._enable:
            return var
        return var * self._scale

    @torch.no_grad()
    def unscale_(self, optimizer):
        """Multiply every gradient by ``1 / scale`` in place and note
        whether any is non-finite."""
        if not self._enable:
            return
        inv = 1.0 / self._scale
        peaks = []
        for p in optimizer._get_params():
            if p.grad is None:
                continue
            p.grad.mul_(inv)
            # NaN propagates through amax, inf stays inf
            peaks.append(p.grad.abs().amax().float())
        self._found_inf = bool(peaks) and not bool(
            torch.isfinite(torch.stack(peaks)).all())

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()
        self.update()

    def minimize(self, optimizer, scaled_loss):
        self.step(optimizer)

    def update(self):
        if not self._dynamic:
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every:
                self._scale *= self._incr_ratio
                self._good_steps = 0

    def state_dict(self):
        return {"scale": self._scale, "good_steps": self._good_steps,
                "bad_steps": self._bad_steps}

    def load_state_dict(self, sd):
        self._scale = float(sd["scale"])
        self._good_steps = int(sd["good_steps"])
        self._bad_steps = int(sd["bad_steps"])

    def get_loss_scaling(self, device=None):
        """The scale as a float32 scalar tensor on ``device`` (the card
        unless the caller asks for the CPU)."""
        return torch.tensor(self._scale, dtype=torch.float32,
                            device=resolve_device(device))


__all__ = ["auto_cast", "amp_guard", "amp_state", "cast_inputs",
           "decorate", "GradScaler", "WHITE_LIST", "BLACK_LIST",
           "CAST_POINTS"]
