"""The op registry (counterpart of paddle_tpu/core/dispatch.py).

``primitive(name=...)`` registers a port function as the op of the
reference's name (``OPS``: name -> function; ``WRAPPERS``: name -> the
registered callable, the ``_C_ops`` surface) and keeps the reference's
dispatch rules:

- **AMP.** At entry a top-level call hands its tensor arguments (and
  those one list or tuple deep, keyword arguments included) to the cast
  hook that ``amp`` installs, under the op's name; ``cast`` itself is
  never cast (``paddle_tpu/core/dispatch.py:205-209``).
- **Nesting.** A primitive called inside another sees its arguments as
  they are: no cast (``_in_primitive``, ``:98-108``). ``amp``'s
  ``TorchFunctionMode`` reads the same depth, so the raw torch calls in a
  primitive's body and in the kernel wrappers it calls are never cast.
- **Errors.** An error from the body leaves as the reference's typed
  error naming the op: an ``EnforceNotMet`` gets the op attached, and a
  builtin one with a typed counterpart (``enforce.BUILTIN_TO_TYPED``)
  becomes it, still caught by ``except <builtin>``.
- **Gradients.** Autograd is PyTorch's: a primitive is differentiable
  where its torch body is. One registered ``nondiff`` runs under
  ``torch.no_grad()``, as the reference records no gradient node for it.

``no_grad`` / ``enable_grad`` are torch's.
"""
from __future__ import annotations

import functools
import threading

import torch

from . import enforce as _errors

class _State(threading.local):
    depth = 0       # primitives entered on this thread


_state = _State()

OPS = {}       # op name -> the function as written
WRAPPERS = {}  # op name -> the registered callable

# the AMP cast hook, (op name, args, kwargs) -> the same, cast: installed
# by amp while some thread is inside an auto_cast scope, None otherwise
_cast_hook = None

no_grad = torch.no_grad
enable_grad = torch.enable_grad
set_grad_enabled = torch.set_grad_enabled


def set_cast_hook(fn):
    global _cast_hook
    _cast_hook = fn


def in_primitive() -> bool:
    """True inside the body of a primitive (on this thread)."""
    return _state.depth > 0


class primitive_scope:
    """Run a block as the body of a primitive: nothing in it is cast."""

    __slots__ = ()

    def __enter__(self):
        _state.depth += 1
        return self

    def __exit__(self, *exc):
        _state.depth -= 1
        return False


def _shapes(args, kwargs):
    out = []
    for v in list(args) + list(kwargs.values()):
        if isinstance(v, torch.Tensor):
            out.append(tuple(v.shape))
    return out


def _typed_error(op_name, args, kwargs, e):
    """The typed error to raise in place of ``e``, or None to re-raise
    ``e`` itself (an ``EnforceNotMet`` gets the op attached in place).
    It returns rather than raises: a frame that raised ``e`` while
    holding it would sit in ``e``'s traceback, a reference cycle that
    keeps the call's tensors alive until the cyclic collector runs
    (``torch.utils.checkpoint`` ends every recomputation with such an
    exception)."""
    if isinstance(e, _errors.EnforceNotMet):
        e.with_op(op_name)
        e.context.setdefault("input_shapes", _shapes(args, kwargs))
        return None
    typed = _errors.BUILTIN_TO_TYPED.get(type(e))
    if typed is None:
        return None
    msg = ("key %r not found" % e.args[0]
           if isinstance(e, KeyError) and e.args else str(e))
    return typed(msg, op=op_name, input_shapes=_shapes(args, kwargs))


def primitive(fn=None, *, name=None, nondiff=False):
    """Register ``fn`` as the op ``name`` (its ``__name__`` by default)."""

    def deco(raw_fn):
        op_name = name or raw_fn.__name__
        OPS[op_name] = raw_fn
        call = torch.no_grad()(raw_fn) if nondiff else raw_fn
        castable = op_name != "cast"

        @functools.wraps(raw_fn)
        def wrapper(*args, **kwargs):
            state = _state
            depth = state.depth
            hook = _cast_hook
            if hook is not None and depth == 0 and castable:
                args, kwargs = hook(op_name, args, kwargs)
            state.depth = depth + 1
            try:
                return call(*args, **kwargs)
            except Exception as e:
                typed = _typed_error(op_name, args, kwargs, e)
                if typed is None:
                    raise
                raise typed from e
            finally:
                state.depth = depth

        wrapper.op_name = op_name
        wrapper.raw_fn = raw_fn
        wrapper.nondiff = nondiff
        WRAPPERS[op_name] = wrapper
        return wrapper

    if fn is not None:
        return deco(fn)
    return deco
