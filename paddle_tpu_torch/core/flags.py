"""Runtime flags (the port's own copy of paddle_tpu/core/flags.py, holding
only the flags the port reads).

Flags are process-global values, bootstrapped from ``FLAGS_*``
environment variables at import (``"1"``, ``"true"``, ``"yes"`` and
``"on"`` turn a boolean on) and settable from Python with ``set_flags``;
``get_flags(name)`` returns ``{name: value}`` as the reference does and
``flag(name)`` the value alone.
"""
from __future__ import annotations

import os

_DEFAULTS = {
    # route the decoder loss tail through the fused lm_head + cross-entropy
    # kernels (kernels/fused_ce.py) when the token count tiles 256
    "FLAGS_fused_lm_head_ce": False,
    # serving tier 2, each latched by serving.Engine at construction:
    # radix prefix cache over the page pool (shared prompt heads map to
    # shared refcounted pages, copy-on-write on a partial page)
    "FLAGS_serving_prefix_cache": False,
    # prompts prefill in prefill_chunk-token rows of ONE mixed ragged
    # step beside the decode rows
    "FLAGS_serving_chunked_prefill": False,
    # int8 KV pages with per-(page, position, head) fp32 scale planes
    "FLAGS_serving_quant_kv": False,
    # weight-only int8 decode: the attention and MLP projection weights
    # quantized once at construction (block scales along the input axis);
    # the decode and mixed steps multiply through the int8-weight GEMM,
    # prefill keeps the fp32 weights
    "FLAGS_serving_quant_weights": False,
    # record/replay journal (serving/replay.py): the engine latches a
    # recorder at construction and captures each request at admission and
    # at its terminal state
    "FLAGS_serving_replay": False,
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


def flag(name, default=None):
    """The value of one flag (``default`` for an unknown name)."""
    return _flags.get(name, default)


def set_flags(d):
    """Set each ``{name: value}``; a string value for a bool/int/float
    flag is coerced as the environment's would be."""
    for k, v in d.items():
        default = _DEFAULTS.get(k)
        if isinstance(default, (bool, int, float)) and isinstance(v, str):
            v = _coerce(default, v)
        _flags[k] = v
