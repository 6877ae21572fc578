"""Automatic mixed precision (counterpart of paddle_tpu/amp/__init__.py).

``auto_cast`` (``amp_guard``) at level O1 or O2 in bfloat16 or float16,
with the reference's white and black lists, custom lists and thread-local
state; ``decorate``; and ``GradScaler`` with the reference's scaling rules.

Where the cast happens. The reference casts at its dispatcher, by the
primitive's name (``paddle_tpu/core/dispatch.py:205-209``,
``paddle_tpu/amp/__init__.py:69-91``): the float tensor arguments of a
top-level primitive call are cast down to the AMP dtype when the name is
on the white list, or at O2 off the black list, and bfloat16 and float16
ones up to float32 when it is on the black list; ``cast`` is never cast,
and a primitive nested inside another sees its arguments as they are.
The port does the same in two places:

- **The op registry** (``core.dispatch.primitive``): every port function
  whose reference counterpart is a primitive is one, under its name
  (the ``ops`` package, ``nn.functional``, the RNN cells, ``rope_apply``),
  and calls ``_cast_call`` at entry.
- **One ``TorchFunctionMode``** (``_AmpMode``) for the raw torch calls of
  the port's model code, which the reference writes as primitives (the
  residual ``+``, rope's ``*``, ``view`` / ``reshape``, ``transpose``,
  indexing). It maps each torch function to the reference primitive's
  name (``_TORCH_NAMES``: ``add``, ``multiply``, ``reshape``,
  ``mean``, ``sum``, ``exp``, ``softmax``, ``norm`` ...); a name missing
  from the map is cast down at O2, as the reference casts every
  primitive off the black list. It casts nothing inside a primitive
  (the kernel wrappers' own calls, the float32 LSE and statistics
  buffers, an op's body), nothing in the backward, nothing that is no op
  (``Tensor.to`` / ``float`` / ``dtype`` / ``size`` / ``item``, the
  factories, in-place writes: ``_NOT_OPS``), and no integer or bool
  tensor. The mode is on inside ``auto_cast(level="O2")``, and at O1 only
  when a custom list is given (so that a custom list naming ``add`` casts
  model code's ``+`` as the reference's would); ``state_scope`` turns it
  on again for a recomputed layer's forward, which the backward runs.

The fused lm_head + cross-entropy tail (``kernels.fused_ce
.fused_mean_ce``) is a primitive of its own name, ``fused_lm_head_ce``,
off both lists: under O2 its hidden states and weight reach the kernels
in the AMP dtype. (The reference's fused tail runs only in its compiled
step and reads its inputs as they are.)

``decorate`` casts a model's parameters and buffers to the AMP dtype (the
reference's ``Layer.to``), the pure low-precision path that O2 pairs with.

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
``save_dtype`` (14). A custom list naming an operation that is neither a
primitive nor a torch function the mode maps raises
``NotImplementedError``: nothing would cast it.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager

import torch
from torch.overrides import TorchFunctionMode

from ..core import dispatch as _dispatch
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
_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           torch.bfloat16: torch.bfloat16, torch.float16: torch.float16}
_HALF = (torch.bfloat16, torch.float16)

# torch function name -> the reference primitive's name, where they differ
_TORCH_NAMES = {
    "__add__": "add", "__radd__": "add", "sub": "subtract",
    "__sub__": "subtract", "__rsub__": "subtract", "rsub": "subtract",
    "mul": "multiply", "__mul__": "multiply", "__rmul__": "multiply",
    "div": "divide", "true_divide": "divide", "__truediv__": "divide",
    "__rtruediv__": "divide", "__div__": "divide", "__rdiv__": "divide",
    "__floordiv__": "floor_divide", "__rfloordiv__": "floor_divide",
    "__mod__": "remainder", "__rmod__": "remainder", "fmod": "remainder",
    "__pow__": "pow", "__rpow__": "pow", "float_power": "pow",
    "__matmul__": "matmul", "__rmatmul__": "matmul",
    "negative": "neg", "__neg__": "neg", "__abs__": "abs",
    "absolute": "abs", "clamp": "clip", "clamp_min": "clip",
    "clamp_max": "clip",
    "eq": "equal", "__eq__": "equal", "ne": "not_equal",
    "__ne__": "not_equal", "lt": "less_than", "__lt__": "less_than",
    "le": "less_equal", "__le__": "less_equal", "gt": "greater_than",
    "__gt__": "greater_than", "ge": "greater_equal",
    "__ge__": "greater_equal",
    "view": "reshape", "view_as": "reshape", "reshape_as": "reshape",
    "permute": "transpose", "t": "transpose", "swapdims": "swapaxes",
    "movedim": "moveaxis", "cat": "concat", "concatenate": "concat",
    "__getitem__": "getitem", "index_select": "index_select",
    "linalg_vector_norm": "norm", "vector_norm": "norm",
    "matrix_norm": "norm", "linalg_matrix_norm": "norm",
    "frobenius_norm": "norm", "special_logsumexp": "logsumexp",
    "unsqueeze": "unsqueeze", "squeeze": "squeeze",
}

# torch functions that are no op of the reference: casts, metadata, the
# factories, autograd plumbing, in-place writes (a cast copy would lose
# them)
_NOT_OPS = frozenset({
    "__get__", "__set__", "to", "float", "double", "half", "bfloat16",
    "int", "long", "bool", "short", "byte", "char", "type", "type_as",
    "cpu", "cuda", "contiguous", "detach", "requires_grad_", "retain_grad",
    "register_hook", "backward", "numpy", "tolist", "item", "size", "dim",
    "numel", "nelement", "ndimension", "stride", "storage_offset",
    "is_contiguous", "is_floating_point", "is_complex", "element_size",
    "data_ptr", "untyped_storage", "storage", "get_device", "pin_memory",
    "is_pinned", "share_memory_", "record_stream",
    "__len__", "__bool__", "__int__", "__float__", "__index__",
    "__format__", "__repr__", "__str__", "__hash__", "__reduce_ex__",
    "__deepcopy__", "__setstate__", "__getstate__", "__array__",
    "__iter__", "__contains__", "__dir__", "__setitem__",
    "new_tensor", "new_empty", "new_zeros", "new_ones", "new_full",
    "zeros_like", "ones_like", "empty_like", "full_like", "rand_like",
    "randn_like", "randint_like", "empty_strided", "as_strided",
    "copy_", "set_",
})


def _amp_dtype(dtype):
    try:
        return _DTYPES[dtype]
    except (KeyError, TypeError):
        raise ValueError("amp: dtype must be bfloat16 or float16, got %r"
                         % (dtype,)) from None


def amp_state():
    """The active ``auto_cast`` state of this thread, or None."""
    return getattr(_state, "amp", None)


def _rule(st, op_name):
    """'down', 'up' or None: what ``st`` does to ``op_name``'s float
    tensor arguments."""
    if op_name in st["black"]:
        return "up"
    if op_name in st["white"] or st["level"] == "O2":
        return "down"
    return None


def _cast_tensor(t, rule, dt):
    if not isinstance(t, torch.Tensor) or not t.is_floating_point():
        return t
    if rule == "down":
        return t if t.dtype == dt else t.to(dt)
    return t.float() if t.dtype in _HALF else t


def _cast_tree(v, rule, dt):
    if isinstance(v, torch.Tensor):
        return _cast_tensor(v, rule, dt)
    if isinstance(v, (list, tuple)) and v and not isinstance(v, torch.Size):
        out = [_cast_tree(x, rule, dt) for x in v]
        return out if isinstance(v, list) else tuple(out)
    return v


def _cast_call(op_name, args, kwargs):
    """``(args, kwargs)`` of a top-level call of ``op_name`` as the
    reference's dispatcher hands them to the primitive (tensors at any
    list or tuple depth)."""
    st = getattr(_state, "amp", None)
    if st is None:
        return args, kwargs
    rule = _rule(st, op_name)
    if rule is None:
        return args, kwargs
    dt = st["dtype"]
    args = tuple(_cast_tree(a, rule, dt) for a in args)
    if kwargs:
        kwargs = {k: _cast_tree(v, rule, dt) for k, v in kwargs.items()}
    return args, kwargs


# threads inside a non-None auto_cast state; the dispatcher's cast hook is
# installed only while there is one, so a primitive call without AMP pays
# one global read
_scopes = [0]
_scopes_lock = threading.Lock()


def _count_scope(delta):
    with _scopes_lock:
        _scopes[0] += delta
        _dispatch.set_cast_hook(_cast_call if _scopes[0] else None)


def torch_op_name(func):
    """The reference primitive's name for a torch function, or None for
    one that is no op (``_NOT_OPS``, private names, in-place methods)."""
    name = getattr(func, "__name__", None)
    if name is None or name in _NOT_OPS:
        return None
    if name.startswith("__i") and name.endswith("__") and name not in (
            "__index__", "__invert__", "__int__", "__iter__"):
        return None
    if not name.startswith("__"):
        if name.startswith("_") or name.endswith("_"):
            return None
    return _TORCH_NAMES.get(name, name)


class _AmpMode(TorchFunctionMode):
    """Casts the arguments of the raw torch calls made outside any
    primitive by the thread's ``auto_cast`` state (see the module's
    docstring). ``recompute``: pushed for a recomputed forward inside
    the backward; otherwise calls made while autograd runs a node (the
    backward) pass as they are."""

    def __init__(self, recompute=False):
        super().__init__()
        self.recompute = recompute

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        st = getattr(_state, "amp", None)
        if st is None or _dispatch.in_primitive() or (
                not self.recompute
                and torch._C._current_autograd_node() is not None):
            return func(*args, **kwargs)
        name = torch_op_name(func)
        if name is not None:
            args, kwargs = _cast_call(name, args, kwargs)
        return func(*args, **kwargs)


def _mode_active():
    from torch.overrides import _get_current_function_mode_stack

    return any(isinstance(m, _AmpMode)
               for m in _get_current_function_mode_stack())


@contextmanager
def state_scope(state):
    """Run a block under ``state`` (an ``amp_state()`` taken earlier, or
    None), restoring this thread's own state after: a recomputed forward
    runs under the AMP state of the forward it repeats, the O2 mode
    included."""
    prev = amp_state()
    _state.amp = state
    if state is not None:
        _count_scope(1)
    mode = None
    try:
        if state is not None and state["mode"] and not _mode_active():
            mode = _AmpMode(
                recompute=torch._C._current_autograd_node() is not None)
            mode.__enter__()
        yield
    finally:
        if mode is not None:
            mode.__exit__(None, None, None)
        if state is not None:
            _count_scope(-1)
        _state.amp = prev


def _known_names():
    """Every name a custom list may hold: the registered primitives and
    the names the mode gives torch functions."""
    from .. import nn, ops  # noqa: F401  (registers their primitives)

    return set(_dispatch.OPS) | set(_TORCH_NAMES.values())


@contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16"):
    state = None
    if enable:
        if level not in ("O1", "O2"):
            raise NotImplementedError(
                "auto_cast(level=%r): the reference casts as at O1 for "
                "every level but O2 (\"Faults of the reference\" 13 in "
                "ROADMAP.md); pass level='O1', 'O2' or enable=False"
                % (level,))
        custom = set(custom_white_list or ()) | set(custom_black_list or ())
        missing = sorted(custom - _known_names()) if custom else []
        if missing:
            raise NotImplementedError(
                "auto_cast: %s %s no primitive in the port, so nothing "
                "would cast it" % (", ".join(missing), "has" if
                                   len(missing) == 1 else "have"))
        white = set(WHITE_LIST)
        black = set(BLACK_LIST)
        if custom_white_list:
            white |= set(custom_white_list)
            black -= set(custom_white_list)
        if custom_black_list:
            black |= set(custom_black_list)
            white -= set(custom_black_list)
        state = {"level": level, "dtype": _amp_dtype(dtype),
                 "white": frozenset(white), "black": frozenset(black),
                 "mode": level == "O2" or bool(custom)}
    with state_scope(state):
        yield


amp_guard = auto_cast


def __getattr__(name):
    if name == "CAST_POINTS":
        # the listed operations that have a primitive in the port: all
        return frozenset((WHITE_LIST | BLACK_LIST) & _known_names())
    raise AttributeError(name)


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
        with _dispatch.primitive_scope():     # array math, never cast
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


__all__ = ["auto_cast", "amp_guard", "amp_state", "decorate", "GradScaler",
           "WHITE_LIST", "BLACK_LIST", "CAST_POINTS"]
