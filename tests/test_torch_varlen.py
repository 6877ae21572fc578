"""The port's segment-id (packed, variable-length) attention against the
JAX package's, on the same numbers.

On the CPU the flash wrappers of paddle_tpu_torch run their plain PyTorch
versions (the segmented CUDA kernels run only on the card, where
chip_smoke.py phases 3d and 6d hold them against these same plain
versions). Here the plain versions are held against the reference: its
Pallas forward and dq/dk/dv kernels in interpret mode (tileable N), its
dense ``_reference_attention`` and that function's VJP (any N), and its
``F.variable_length_attention``; inputs are numpy arrays from a seed.

Tolerances, float32: outputs and LSE rtol 1e-4 / atol 1e-5 (XLA's CPU
exp is approximate to ~1e-5 relative and the two sides sum in another
order); gradients rtol 1e-4 / atol 1e-4, sums of up to N such products
(the same limits as tests/test_torch_kernels.py). The port's own
properties (all-zero ids, GQA, no cross-segment gradient) hold exactly or
to 1e-6, where the arithmetic is the same on both sides.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.nn.functional as jF
from paddle_tpu.core.tensor import Tensor as JaxTensor
from paddle_tpu.kernels.flash_attention import (
    _flash_core,
    _flash_fwd_bhnd,
    _reference_attention,
    flash_attention as jax_flash_attention,
)
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.kernels.flash_attention import (
    FlashAttention,
    flash_attention,
    flash_attention_backward,
)
from paddle_tpu_torch.nn import functional as F

TOL = dict(rtol=1e-4, atol=1e-5)
BWD_TOL = dict(rtol=1e-4, atol=1e-4)
EXACT = dict(rtol=1e-6, atol=1e-6)


def _qkv(seed, b, n, h, hkv, d):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, n, h, d).astype(np.float32),
            rng.randn(b, n, hkv, d).astype(np.float32),
            rng.randn(b, n, hkv, d).astype(np.float32),
            rng.randn(b, n, h, d).astype(np.float32))


def _packed(lens_per_row, n):
    """Sorted ids: row r packs documents of lengths lens_per_row[r] (the
    rest of the row is one more segment)."""
    segs = np.zeros((len(lens_per_row), n), np.int32)
    for r, lens in enumerate(lens_per_row):
        off = 0
        for i, length in enumerate(lens):
            segs[r, off:off + length] = i
            off += length
        segs[r, off:] = len(lens)
    return segs


def _shuffled(seed, b, n, groups=4):
    """Non-monotonic ids: every position draws one of ``groups`` ids."""
    return np.random.RandomState(seed).randint(
        0, groups, (b, n)).astype(np.int32) * 7 - 3


def _scattered(b, n):
    """Packed documents whose ids are not monotonic and repeat: documents
    far apart with one id see each other."""
    docs = _packed([[37, 90, 70], [100, 5, 151]][:b], n)
    table = np.array([[3, 1, 3, 0], [1, 4, 0, 1]][:b], np.int32)
    return table[np.arange(b)[:, None], docs]


# segments starting mid-tile (the Pallas blocks and the kernels' tiles are
# 128 / 64 rows), shuffled ids, and scattered document ids
IDS = {
    "packed": lambda b, n: _packed([[37, 90, 70], [100, 5, 151]][:b], n),
    "shuffled": lambda b, n: _shuffled(11, b, n),
    "scattered": _scattered,
}


def _fold(x):
    b, n, h, d = x.shape
    return jnp.swapaxes(jnp.asarray(x), 1, 2).reshape(b * h, n, d)


def _unfold(x, b, h):
    x = np.asarray(x)
    return np.swapaxes(x.reshape(b, h, x.shape[1], x.shape[2]), 1, 2)


def _fold_segs(segs, h):
    b, n = segs.shape
    return jnp.broadcast_to(jnp.asarray(segs)[:, None, :],
                            (b, h, n)).reshape(b * h, n)


def _port(q, k, v, g, causal, segs):
    """The port's plain forward and backward on numpy inputs."""
    q, k, v, g = (torch.from_numpy(x) for x in (q, k, v, g))
    segs = torch.from_numpy(segs)
    out, lse = flash_attention(q, k, v, causal=causal, segment_ids=segs)
    grads = flash_attention_backward(q, k, v, out, lse, g, causal=causal,
                                     segment_ids=segs)
    return out.numpy(), lse.numpy(), [x.numpy() for x in grads]


class TestAgainstPallasInterpret:
    @pytest.mark.parametrize("ids", sorted(IDS))
    @pytest.mark.parametrize("causal", [True, False])
    def test_forward_lse_and_gradients(self, causal, ids):
        """B = 2, N = 256, H = 2, D = 64, blocks 128/128: the reference's
        segmented Pallas forward (O and LSE) and its dq/dk/dv kernels
        (``jax.vjp`` of ``_flash_core``) in interpret mode."""
        b, n, h, d = 2, 256, 2, 64
        q, k, v, g = _qkv(0, b, n, h, h, d)
        segs = IDS[ids](b, n)
        scale = 1.0 / math.sqrt(d)
        out, lse, grads = _port(q, k, v, g, causal, segs)

        want = jax_flash_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=causal,
                                   block_q=128, block_k=128, interpret=True,
                                   segment_ids=jnp.asarray(segs))
        np.testing.assert_allclose(out, np.asarray(want), **TOL)
        fsegs = _fold_segs(segs, h)
        _, want_lse = _flash_fwd_bhnd(_fold(q), _fold(k), _fold(v), scale,
                                      causal, 128, 128, True, segs=fsegs)
        np.testing.assert_allclose(lse, np.asarray(want_lse)[:, 0], **TOL)
        _, vjp = jax.vjp(
            lambda a, b_, c: _flash_core(a, b_, c, fsegs, scale, causal,
                                         128, 128, True),
            _fold(q), _fold(k), _fold(v))
        for got, ref in zip(grads, vjp(_fold(g))):
            np.testing.assert_allclose(got, _unfold(ref, b, h), **BWD_TOL)


class TestAgainstDenseReference:
    @pytest.mark.parametrize("ids", sorted(IDS))
    @pytest.mark.parametrize("causal", [True, False])
    def test_untileable_length(self, causal, ids):
        """N = 100 is not tileable: the reference takes its dense
        ``_reference_attention``; forward and its VJP."""
        b, n, h, d = 2, 100, 2, 32
        q, k, v, g = _qkv(1, b, n, h, h, d)
        segs = IDS[ids](b, n)
        scale = 1.0 / math.sqrt(d)
        out, _, grads = _port(q, k, v, g, causal, segs)
        want = jax_flash_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=causal,
                                   segment_ids=jnp.asarray(segs))
        np.testing.assert_allclose(out, np.asarray(want), **TOL)
        fsegs = _fold_segs(segs, h)
        _, vjp = jax.vjp(
            lambda a, b_, c: _reference_attention(a, b_, c, scale, causal,
                                                  segs=fsegs),
            _fold(q), _fold(k), _fold(v))
        for got, ref in zip(grads, vjp(_fold(g))):
            np.testing.assert_allclose(got, _unfold(ref, b, h), **BWD_TOL)

    def test_segment_starting_mid_tile_without_causal(self):
        """Non-causal, a segment starting at row 70: in the kernels' first
        64-key tile rows of segment 1 see only masked scores, which the
        next tile's rescale must erase (the reference's finite NEG_INF)."""
        b, n, h, d = 1, 160, 2, 16
        q, k, v, g = _qkv(2, b, n, h, h, d)
        segs = _packed([[70]], n)
        out, lse, grads = _port(q, k, v, g, False, segs)
        assert np.isfinite(out).all() and np.isfinite(lse).all()
        want = jax_flash_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=False,
                                   segment_ids=jnp.asarray(segs))
        np.testing.assert_allclose(out, np.asarray(want), **TOL)
        # rows of segment 1 equal attention over segment 1 alone
        alone, _ = flash_attention(*(torch.from_numpy(x[:, 70:])
                                     for x in (q, k, v)))
        np.testing.assert_allclose(out[:, 70:], alone.numpy(), **EXACT)


class TestVariableLengthAttention:
    @pytest.mark.parametrize("seq_lens", [
        [60, 100, 96],              # 1-D, fills N: every batch row
        [50, 70],                   # 1-D, a tail of 136 padded tokens
        [[30, 200, 26], [128, 100, 28]],   # 2-D, one row per element
        [[30, 200], [128, 100]],    # 2-D with tails
    ], ids=["1d", "1d_tail", "2d", "2d_tail"])
    @pytest.mark.parametrize("causal", [True, False])
    def test_seq_lens_match_reference(self, seq_lens, causal):
        b, n, h, d = 2, 256, 2, 64
        q, k, v, _ = _qkv(3, b, n, h, h, d)
        got = F.variable_length_attention(
            *(torch.from_numpy(x) for x in (q, k, v)), seq_lens=seq_lens,
            is_causal=causal)
        want = jF.variable_length_attention(
            *(JaxTensor(jnp.asarray(x)) for x in (q, k, v)),
            seq_lens=seq_lens, is_causal=causal)
        np.testing.assert_allclose(got.numpy(), np.asarray(want._value),
                                   **TOL)

    def test_segment_ids_match_reference_with_gradients(self):
        b, n, h, d = 2, 100, 2, 32
        q, k, v, g = _qkv(4, b, n, h, h, d)
        segs = _shuffled(5, b, n)
        leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
        out = F.variable_length_attention(*leaves, segment_ids=segs)
        out.backward(torch.from_numpy(g))

        def jfn(a, b_, c):
            return jF.variable_length_attention.raw_fn(
                a, b_, c, segment_ids=jnp.asarray(segs))
        want, vjp = jax.vjp(jfn, *(jnp.asarray(x) for x in (q, k, v)))
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                                   **TOL)
        for leaf, ref in zip(leaves, vjp(jnp.asarray(g))):
            np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(ref),
                                       **BWD_TOL)

    def test_seq_lens_rule(self):
        segs = F.attention.segment_ids_from_lens([3, 2], 8)
        np.testing.assert_array_equal(segs, [[0, 0, 0, 1, 1, 2, 2, 2]])
        segs = F.attention.segment_ids_from_lens([[1, 4], [5, 3]], 8)
        np.testing.assert_array_equal(segs, [[0, 1, 1, 1, 1, 2, 2, 2],
                                             [0, 0, 0, 0, 0, 1, 1, 1]])

    def test_errors_match_reference(self):
        x = torch.zeros(1, 8, 2, 16)
        with pytest.raises(ValueError, match="need seq_lens or segment_ids"):
            F.variable_length_attention(x, x, x)
        with pytest.raises(ValueError, match="need seq_lens or segment_ids"):
            jF.variable_length_attention(*(JaxTensor(jnp.zeros(
                (1, 8, 2, 16))) for _ in range(3)))
        msg = r"segment_ids requires q_len == kv_len \(packed batches\)"
        kv = torch.zeros(1, 12, 2, 16)
        with pytest.raises(ValueError, match=msg):
            F.variable_length_attention(x, kv, kv, seq_lens=[4, 4])
        with pytest.raises(ValueError, match=msg):
            jax_flash_attention(jnp.zeros((1, 8, 2, 16)),
                                jnp.zeros((1, 12, 2, 16)),
                                jnp.zeros((1, 12, 2, 16)),
                                segment_ids=jnp.zeros((1, 8), jnp.int32))


class TestPortProperties:
    def test_no_cross_segment_gradient(self):
        """A loss over segment 0's outputs gives segment 1's keys and
        values exactly zero gradient, and segment 0's none either way
        (the reference's tests/test_ring_attention.py check)."""
        b, n, h, d = 1, 96, 2, 16
        q, k, v, _ = _qkv(6, b, n, h, h, d)
        segs = _packed([[40]], n)
        for causal in (False, True):
            leaves = [torch.from_numpy(x).requires_grad_()
                      for x in (q, k, v)]
            out = FlashAttention.apply(*leaves, causal, None, segs)
            (out[:, :40] ** 2).sum().backward()
            dq, dk, dv = (x.grad for x in leaves)
            assert not dk[:, 40:].any() and not dv[:, 40:].any()
            assert not dq[:, 40:].any()
            assert dv[:, :40].abs().max() > 0

    @pytest.mark.parametrize("causal", [True, False])
    def test_gradcheck_float64(self, causal):
        rng = np.random.RandomState(7)

        def leaf(*shape):
            return torch.tensor(rng.randn(*shape), dtype=torch.float64,
                                requires_grad=True)

        q, k, v = leaf(1, 7, 2, 4), leaf(1, 7, 1, 4), leaf(1, 7, 1, 4)
        segs = torch.tensor([[2, 2, 0, 2, 5, 5, 0]])
        assert torch.autograd.gradcheck(
            lambda a, b_, c: FlashAttention.apply(a, b_, c, causal, None,
                                                  segs), (q, k, v))

    @pytest.mark.parametrize("causal", [True, False])
    def test_gqa_equals_repeated_kv(self, causal):
        b, n, h, hkv, d = 2, 40, 4, 2, 16
        q, k, v, g = _qkv(8, b, n, h, hkv, d)
        segs = _shuffled(9, b, n, groups=3)
        out, lse, (dq, dk, dv) = _port(q, k, v, g, causal, segs)
        kr, vr = (np.repeat(x, h // hkv, axis=2) for x in (k, v))
        rout, rlse, (rdq, rdk, rdv) = _port(q, kr, vr, g, causal, segs)
        np.testing.assert_allclose(out, rout, **EXACT)
        np.testing.assert_allclose(lse, rlse, **EXACT)
        np.testing.assert_allclose(dq, rdq, **EXACT)
        for got, ref in ((dk, rdk), (dv, rdv)):
            np.testing.assert_allclose(
                got, ref.reshape(b, n, hkv, h // hkv, d).sum(3), **EXACT)

    @pytest.mark.parametrize("causal", [True, False])
    def test_all_zero_ids_equal_the_unsegmented_result(self, causal):
        q, k, v, g = (torch.from_numpy(x) for x in _qkv(10, 2, 50, 2, 2, 16))
        zeros = torch.zeros(2, 50, dtype=torch.int64)
        out, lse = flash_attention(q, k, v, causal)
        sout, slse = flash_attention(q, k, v, causal, segment_ids=zeros)
        assert torch.equal(out, sout) and torch.equal(lse, slse)
        grads = flash_attention_backward(q, k, v, out, lse, g, causal)
        sgrads = flash_attention_backward(q, k, v, out, lse, g, causal,
                                          segment_ids=zeros)
        for a, b_ in zip(grads, sgrads):
            assert torch.equal(a, b_)

    def test_bad_ids_raise(self):
        x = torch.zeros(2, 8, 2, 16)
        with pytest.raises(ValueError, match="not \\[B, N\\]"):
            flash_attention(x, x, x, segment_ids=torch.zeros(1, 8))
        with pytest.raises(ValueError, match="integers"):
            flash_attention(x, x, x, segment_ids=torch.zeros(2, 8))
        with pytest.raises(ValueError, match="segment_ids on meta"):
            flash_attention(x, x, x, segment_ids=torch.zeros(
                2, 8, dtype=torch.int32, device="meta"))

    def test_cuda_tensor_without_a_card_raises(self, monkeypatch):
        """Tensors on a CUDA device take the kernel path or raise; the
        plain version is never their fallback."""
        class CudaTensor(torch.Tensor):
            @property
            def device(self):
                return torch.device("cuda", 0)

        def no_plain(*args, **kwargs):
            raise AssertionError("the plain version ran for CUDA tensors")

        monkeypatch.setattr(fa, "flash_attention_reference", no_plain)
        x = torch.zeros(1, 8, 2, 64).as_subclass(CudaTensor)
        before = (fa.launches, fa.segmented_fwd_launches)
        with pytest.raises((RuntimeError, AssertionError),
                           match="CUDA|cuda|nvcc") as err:
            F.variable_length_attention(x, x, x, seq_lens=[3, 5])
        assert "plain version ran" not in str(err.value)
        assert (fa.launches, fa.segmented_fwd_launches) == before
