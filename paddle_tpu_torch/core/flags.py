"""Runtime flags (the port's own copy of paddle_tpu/core/flags.py, holding
only the flags the port reads).

Flags are process-global values, bootstrapped from ``FLAGS_*``
environment variables at import (``"1"``, ``"true"``, ``"yes"`` and
``"on"`` turn a boolean on) and settable from Python with ``set_flags``;
``get_flags(name)`` returns ``{name: value}`` as the reference does.
"""
from __future__ import annotations

import os

_DEFAULTS = {
    # route the decoder loss tail through the fused lm_head + cross-entropy
    # kernels (kernels/fused_ce.py) when the token count tiles 256
    "FLAGS_fused_lm_head_ce": False,
}

_flags = {}


def _coerce(default, raw):
    if isinstance(default, bool):
        return raw.lower() in ("1", "true", "yes", "on")
    if isinstance(default, int):
        return int(raw)
    if isinstance(default, float):
        return float(raw)
    return raw


def _bootstrap():
    for k, v in _DEFAULTS.items():
        raw = os.environ.get(k)
        _flags[k] = _coerce(v, raw) if raw is not None else v


_bootstrap()


def get_flags(name=None):
    """All flags (``name=None``), or ``{name: value}`` for one name or a
    list of names."""
    if name is None:
        return dict(_flags)
    if isinstance(name, (list, tuple)):
        return {n: _flags[n] for n in name}
    return {name: _flags[name]}


def set_flags(d):
    """Set each ``{name: value}``; a string value for a bool/int/float
    flag is coerced as the environment's would be."""
    for k, v in d.items():
        default = _DEFAULTS.get(k)
        if isinstance(default, (bool, int, float)) and isinstance(v, str):
            v = _coerce(default, v)
        _flags[k] = v
