"""``F.scaled_dot_product_attention`` takes the reference's parameters in
the reference's order: ``(query, key, value, attn_mask=None,
dropout_p=0.0, is_causal=False, scale=None, training=True)``.

A reference-style positional call must mean the same in both packages
(with the old port order ``(q, k, v, is_causal, scale)`` the ``0.0`` of
``dropout_p`` became the scale and attention went uniform). A non-zero
``dropout_p`` is accepted and, as in the reference, applies no dropout
(ROADMAP.md, "Faults of the reference" 5, mirrored), with or without a
mask; a positional mask is the reference's ``attn_mask``. The port runs
its plain
path on the CPU; tolerances are the existing SDPA tests'
(``test_torch_kernels.py``: rtol 1e-4 / atol 1e-5 in float32).
"""
import inspect

import numpy as np
import pytest
import torch

from paddle_tpu.nn import functional as jax_F
from paddle_tpu_torch.nn import functional as F

TOL = dict(rtol=1e-4, atol=1e-5)


def _qkv(seed, b=2, n=24, h=4, h_kv=4, d=16):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, n, h, d).astype(np.float32),
            rng.randn(b, n, h_kv, d).astype(np.float32),
            rng.randn(b, n, h_kv, d).astype(np.float32))


def _jax(*args, **kw):
    out = jax_F.scaled_dot_product_attention(*args, **kw)
    return np.asarray(getattr(out, "_value", out))


def _port(q, k, v, *args, **kw):
    t = [torch.from_numpy(a) for a in (q, k, v)]
    return F.scaled_dot_product_attention(*t, *args, **kw).numpy()


def test_parameter_names_and_order_match_the_reference():
    def params(fn):
        return [(p.name, p.default)
                for p in inspect.signature(fn).parameters.values()
                if not p.name.startswith("_")]

    ref = jax_F.scaled_dot_product_attention
    ref = getattr(ref, "__wrapped__", ref)
    assert params(F.scaled_dot_product_attention) == params(ref)


@pytest.mark.parametrize("causal", [True, False])
def test_positional_reference_call_agrees(causal):
    q, k, v = _qkv(0)
    want = _jax(q, k, v, None, 0.0, causal)
    got = _port(q, k, v, None, 0.0, causal)
    np.testing.assert_allclose(got, want, **TOL)


def test_positional_scale_agrees():
    q, k, v = _qkv(1)
    want = _jax(q, k, v, None, 0.0, True, 0.3)
    got = _port(q, k, v, None, 0.0, True, 0.3)
    np.testing.assert_allclose(got, want, **TOL)
    # the scale really is the seventh parameter: 0.3 is not the default
    default = _port(q, k, v, None, 0.0, True)
    assert not np.allclose(got, default, **TOL)


def test_unported_mask_and_dropout_raise():
    q, k, v = _qkv(2)
    mask = np.random.RandomState(3).rand(q.shape[1], k.shape[1]) < 0.5
    mask[:, 0] = True
    # the mask is ported: positionally, it is the reference's attn_mask
    np.testing.assert_allclose(_port(q, k, v, torch.from_numpy(mask)),
                               _jax(q, k, v, mask), **TOL)
    # a positional dropout_p is the reference's too, and neither package
    # applies it (fault 5, mirrored): no longer an error
    np.testing.assert_allclose(_port(q, k, v, torch.from_numpy(mask), 0.1),
                               _jax(q, k, v, mask, 0.1), **TOL)
    np.testing.assert_allclose(_port(q, k, v, None, 0.1),
                               _jax(q, k, v, None, 0.1), **TOL)
    np.testing.assert_allclose(_port(q, k, v, dropout_p=0.5, training=False),
                               _jax(q, k, v), **TOL)
