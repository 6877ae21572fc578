"""Typed errors and enforce helpers (a copy of paddle_tpu/core/enforce.py).

Parity: reference PADDLE_ENFORCE macro family (phi/core/enforce.h) and
the error-code taxonomy (paddle/utils/error.h / platform/errors.h:
InvalidArgument, NotFound, OutOfRange, AlreadyExists, PermissionDenied,
ResourceExhausted, PreconditionNotMet, Unimplemented, Unavailable,
Fatal, ExecutionTimeout) plus the external-error summary formatting.

Structure (the parts the reference's enforce layer provides beyond a
message string):
- every typed error ALSO subclasses the closest Python builtin — the
  same mapping the reference's pybind translation uses — so existing
  `except ValueError` code keeps working while `except
  InvalidArgumentError` gets the structured form;
- errors carry a structured payload: `op` (attached automatically at the
  dispatch boundary, core/dispatch.py), `context` (shapes/dtypes/values)
  and `hint`;
- verbosity is gated by FLAGS_call_stack_level (reference enforce.h
  summary mode): 0 = message only, >=1 = + context payload, >=2 = +
  chained original cause;
- native (csrc) int status codes map to typed errors via raise_native —
  the ctypes boundaries' error-string channel.
"""
from __future__ import annotations

import traceback

__all__ = [
    "EnforceNotMet", "InvalidArgumentError", "InvalidTypeError",
    "NotFoundError",
    "OutOfRangeError", "AlreadyExistsError", "ResourceExhaustedError",
    "PreconditionNotMetError", "PermissionDeniedError",
    "ExecutionTimeoutError", "UnimplementedError", "UnavailableError",
    "FatalError", "ExternalError", "enforce", "enforce_eq",
    "enforce_not_none", "enforce_shape_match", "raise_native",
]


def _stack_level():
    try:
        from . import flags as _flags

        return int(_flags.get_flags().get("FLAGS_call_stack_level", 1))
    except Exception:
        return 1


class EnforceNotMet(RuntimeError):
    """Base (reference enforce.h EnforceNotMet)."""

    code = "LEGACY"

    def __init__(self, msg, hint=None, op=None, **context):
        self.raw_message = msg
        self.hint = hint
        self.op = op
        self.context = dict(context)
        super().__init__(msg)

    def with_op(self, op):
        """Attach the raising op once (dispatch does this); idempotent."""
        if self.op is None:
            self.op = op
        return self

    def __str__(self):
        level = _stack_level()
        out = "\n----------------------\nError Message Summary:\n" \
              "----------------------\n%sError: %s" % (
                  type(self).__name__.replace("Error", ""),
                  self.raw_message)
        if self.op:
            out += "\n  [Operator: %s]" % self.op
        if self.hint:
            out += "\n  [Hint: %s]" % self.hint
        if level >= 1:
            for k in sorted(self.context):
                out += "\n  [%s: %r]" % (k, self.context[k])
        if level >= 2 and self.__cause__ is not None:
            out += "\n  [Cause: %s]" % "".join(
                traceback.format_exception_only(
                    type(self.__cause__), self.__cause__)).rstrip()
        return out


class InvalidArgumentError(EnforceNotMet, ValueError):
    code = "INVALID_ARGUMENT"


class InvalidTypeError(InvalidArgumentError, TypeError):
    """INVALID_ARGUMENT raised from an op-body TypeError (jax reports
    shape/dtype mismatches as TypeError): still caught by BOTH
    `except TypeError` and `except ValueError` callers."""


class NotFoundError(EnforceNotMet, KeyError):
    code = "NOT_FOUND"

    def __str__(self):  # KeyError.__str__ would repr() the message
        return EnforceNotMet.__str__(self)


class OutOfRangeError(EnforceNotMet, IndexError):
    code = "OUT_OF_RANGE"


class AlreadyExistsError(EnforceNotMet):
    code = "ALREADY_EXISTS"


class ResourceExhaustedError(EnforceNotMet, MemoryError):
    code = "RESOURCE_EXHAUSTED"


class PreconditionNotMetError(EnforceNotMet):
    code = "PRECONDITION_NOT_MET"


class PermissionDeniedError(EnforceNotMet, PermissionError):
    code = "PERMISSION_DENIED"


class ExecutionTimeoutError(EnforceNotMet, TimeoutError):
    code = "EXECUTION_TIMEOUT"


class UnimplementedError(EnforceNotMet, NotImplementedError):
    code = "UNIMPLEMENTED"


class UnavailableError(EnforceNotMet, ConnectionError):
    code = "UNAVAILABLE"


class FatalError(EnforceNotMet):
    code = "FATAL"


class ExternalError(EnforceNotMet, OSError):
    code = "EXTERNAL"


# builtin -> typed wrapper used by the dispatch boundary to enrich
# op-body errors without changing what `except <builtin>` catches
# (op-body TypeError maps to InvalidTypeError, which subclasses BOTH
# TypeError and ValueError: jax reports shape/dtype mismatches as
# TypeError while the framework semantic is INVALID_ARGUMENT)
BUILTIN_TO_TYPED = {
    ValueError: InvalidArgumentError,
    TypeError: InvalidTypeError,
    IndexError: OutOfRangeError,
    KeyError: NotFoundError,
    NotImplementedError: UnimplementedError,
    MemoryError: ResourceExhaustedError,
    TimeoutError: ExecutionTimeoutError,
}

# native (csrc) int status -> typed error (reference: C++ Status codes
# rethrown typed at the pybind boundary)
NATIVE_STATUS = {
    -1: (NotFoundError, "object not found on the native side"),
    -2: (UnavailableError, "native service unavailable or size mismatch"),
    -3: (PreconditionNotMetError, "native-side layout precondition failed"),
    -4: (InvalidArgumentError, "argument mismatch at the native boundary"),
    -5: (ExternalError, "native-side partial IO failure"),
}


def raise_native(status, what, **context):
    """Raise the typed error mapped from a native return code."""
    cls, default_hint = NATIVE_STATUS.get(
        int(status), (ExternalError, "unrecognized native status"))
    raise cls("%s failed (native status %d)" % (what, status),
              hint=default_hint, status=int(status), **context)


def enforce(cond, msg, error_cls=InvalidArgumentError, hint=None,
            **context):
    """PADDLE_ENFORCE analog: raise a typed error when cond is false."""
    if not cond:
        raise error_cls(msg, hint=hint, **context)
    return True


def enforce_eq(a, b, msg=None, error_cls=InvalidArgumentError, **context):
    if a != b:
        raise error_cls(msg or "expected %r == %r" % (a, b),
                        lhs=a, rhs=b, **context)
    return True


def enforce_not_none(v, msg, error_cls=NotFoundError):
    if v is None:
        raise error_cls(msg)
    return v


def enforce_shape_match(shape, expected, what="tensor", **context):
    """-1/None in `expected` are wildcards (reference InferShape style)."""
    shape, expected = tuple(shape), tuple(expected)
    if len(shape) != len(expected) or any(
            e not in (-1, None) and s != e
            for s, e in zip(shape, expected)):
        raise InvalidArgumentError(
            "%s shape mismatch" % what, got_shape=shape,
            expected_shape=expected, **context)
    return True
