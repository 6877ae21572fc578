"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU each wrapper of paddle_tpu_torch runs its plain PyTorch
version (the CUDA kernels run only on the card, where chip_smoke.py holds
them against these same plain versions). Here the plain versions are
held against the reference: the Pallas kernels in interpret mode and
their jnp fallbacks, on the same numpy inputs.

float32 tolerance rtol 1e-4 / atol 1e-5: XLA's CPU transcendentals (exp)
are fast approximations good to ~1e-5 relative, and the two sides sum in
different orders. The backward's gradients are sums of up to N products
of such terms; they are held to rtol 1e-4 / atol 1e-4 (BWD_TOL), tighter
than the reference's own Pallas-vs-dense check (rtol 5e-3 / atol 5e-4).
"""
import math
import os
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels.flash_attention import (
    _flash_core,
    _flash_fwd_bhnd,
    _reference_attention,
    flash_attention as jax_flash_attention,
)
from paddle_tpu.serving.kernels.paged_attention import (
    paged_attention_kernel,
    paged_attention_reference as jax_paged_reference,
)
from paddle_tpu_torch import _build
from paddle_tpu_torch.kernels.flash_attention import (
    FlashAttention,
    flash_attention,
    flash_attention_backward,
)
from paddle_tpu_torch.serving.kernels.paged_attention import paged_attention

TOL = dict(rtol=1e-4, atol=1e-5)
BWD_TOL = dict(rtol=1e-4, atol=1e-4)


def _qkv(seed, b, n, h, hkv, d):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, n, h, d).astype(np.float32),
            rng.randn(b, n, hkv, d).astype(np.float32),
            rng.randn(b, n, hkv, d).astype(np.float32))


def _fold(x):
    b, n, h, d = x.shape
    return jnp.swapaxes(jnp.asarray(x), 1, 2).reshape(b * h, n, d)


class TestFlashAttention:
    @pytest.mark.parametrize("causal", [True, False])
    def test_matches_pallas_interpret_with_lse(self, causal):
        """Tileable shape (N=128, D=64): the reference runs its Pallas
        forward in interpret mode; O and the LSE must agree."""
        q, k, v = _qkv(0, 2, 128, 2, 2, 64)
        scale = 1.0 / math.sqrt(64)
        out, lse = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), causal=causal)
        ref = jax_flash_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=causal,
                                  interpret=True)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
        ref_o, ref_lse = _flash_fwd_bhnd(_fold(q), _fold(k), _fold(v), scale,
                                         causal, 128, 128, True)
        np.testing.assert_allclose(
            out.transpose(1, 2).reshape(4, 128, 64).numpy(),
            np.asarray(ref_o), **TOL)
        np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse)[:, 0],
                                   **TOL)

    @pytest.mark.parametrize("n,h,hkv", [(40, 4, 4), (40, 4, 2), (8, 2, 1)])
    def test_ragged_and_gqa_match_reference_path(self, n, h, hkv):
        """Lengths the Pallas kernel cannot tile take the reference's
        _reference_attention path; the port takes every length, and GQA
        k/v directly (the reference repeats kv heads first)."""
        q, k, v = _qkv(1, 1, n, h, hkv, 16)
        out, _ = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), causal=True)
        rep = h // hkv
        ref = jax_flash_attention(jnp.asarray(q),
                                  jnp.repeat(jnp.asarray(k), rep, axis=2),
                                  jnp.repeat(jnp.asarray(v), rep, axis=2),
                                  causal=True)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)

    def test_rejects_devices_without_a_path(self):
        q = torch.zeros(1, 8, 2, 64)
        with pytest.raises(ValueError):
            flash_attention(q.to("meta"), q.to("meta"), q.to("meta"))
        with pytest.raises(ValueError):
            flash_attention(q, q, q[:, :, :1].expand(1, 8, 3, 64))


def _port_grads(q, k, v, g, causal):
    """The port's plain forward then plain backward on numpy inputs."""
    q, k, v, g = (torch.from_numpy(x) for x in (q, k, v, g))
    out, lse = flash_attention(q, k, v, causal=causal)
    return [x.numpy() for x in flash_attention_backward(
        q, k, v, out, lse, g, causal=causal)]


def _unfold(x, b, h):
    """[B*H, N, D] -> [B, N, H, D]"""
    x = np.asarray(x)
    return np.swapaxes(x.reshape(b, h, x.shape[1], x.shape[2]), 1, 2)


class TestFlashAttentionBackward:
    @pytest.mark.parametrize("causal", [False, True])
    def test_matches_pallas_backward_interpret(self, causal):
        """The reference's Pallas dq/dk/dv kernels in interpret mode
        (B*H = 2, N = 256, D = 64, blocks 64/128: multi-block
        accumulation and causal block skipping) on the same inputs."""
        q, k, v = _qkv(3, 1, 256, 2, 2, 64)
        g = np.random.RandomState(4).randn(*q.shape).astype(np.float32)
        scale = 1.0 / math.sqrt(64)
        _, vjp = jax.vjp(
            lambda a, b_, c: _flash_core(a, b_, c, None, scale, causal, 64,
                                         128, True),
            _fold(q), _fold(k), _fold(v))
        want = [_unfold(x, 1, 2) for x in vjp(_fold(g))]
        for got, ref in zip(_port_grads(q, k, v, g, causal), want):
            np.testing.assert_allclose(got, ref, **BWD_TOL)

    @pytest.mark.parametrize("n,n_kv,h,hkv", [(40, 40, 4, 4),
                                              (40, 40, 4, 2),
                                              (128, 256, 2, 2)],
                             ids=["ragged", "gqa", "cross_length"])
    def test_matches_reference_vjp(self, n, n_kv, h, hkv):
        """Shapes the Pallas kernel does not take (ragged N = 40) or takes
        only after the model repeats kv heads (GQA), and start-aligned
        causal with N_kv > N: the reference's dense _reference_attention
        VJP, kv heads repeated on the JAX side and their dk/dv summed per
        group."""
        rng = np.random.RandomState(5)
        d, rep = 32, h // hkv
        q = rng.randn(1, n, h, d).astype(np.float32)
        k = rng.randn(1, n_kv, hkv, d).astype(np.float32)
        v = rng.randn(1, n_kv, hkv, d).astype(np.float32)
        g = rng.randn(1, n, h, d).astype(np.float32)
        scale = 1.0 / math.sqrt(d)
        _, vjp = jax.vjp(
            lambda a, b_, c: _reference_attention(a, b_, c, scale, True),
            _fold(q), _fold(np.repeat(k, rep, axis=2)),
            _fold(np.repeat(v, rep, axis=2)))
        jdq, jdk, jdv = (_unfold(x, 1, h) for x in vjp(_fold(g)))
        jdk = jdk.reshape(1, n_kv, hkv, rep, d).sum(3)
        jdv = jdv.reshape(1, n_kv, hkv, rep, d).sum(3)
        dq, dk, dv = _port_grads(q, k, v, g, True)
        for got, ref in ((dq, jdq), (dk, jdk), (dv, jdv)):
            np.testing.assert_allclose(got, ref, **BWD_TOL)
        if n_kv > n:   # keys no query reaches get exactly zero gradients
            assert not dk[:, n:].any() and not dv[:, n:].any()

    @pytest.mark.parametrize("causal,n,n_kv,hkv", [(True, 5, 5, 1),
                                                   (False, 4, 6, 2),
                                                   (True, 3, 7, 2)])
    def test_gradcheck_float64(self, causal, n, n_kv, hkv):
        """The autograd function's backward (the plain backward on the
        CPU) against finite differences of its forward, in float64."""
        rng = np.random.RandomState(6)

        def leaf(*shape):
            return torch.tensor(rng.randn(*shape), dtype=torch.float64,
                                requires_grad=True)

        q, k, v = leaf(1, n, 2, 4), leaf(1, n_kv, hkv, 4), leaf(1, n_kv,
                                                                hkv, 4)
        assert torch.autograd.gradcheck(
            lambda a, b_, c: FlashAttention.apply(a, b_, c, causal, None),
            (q, k, v))

    def test_bfloat16_rounding_points(self):
        """bf16 inputs: ds rounds to bf16 before ds.K / ds^T.Q and p
        before p^T.dO, as in the reference, so the bf16 gradients stay
        within bf16 rounding of the float32 ones (computed from the same
        bf16-representable inputs)."""
        q, k, v = (torch.from_numpy(x).bfloat16()
                   for x in _qkv(7, 1, 64, 2, 2, 32))
        g = torch.randn(q.shape, generator=torch.Generator().manual_seed(8)
                        ).bfloat16()
        out, lse = flash_attention(q, k, v, causal=True)
        grads = flash_attention_backward(q, k, v, out, lse, g, causal=True)
        f32 = flash_attention_backward(q.float(), k.float(), v.float(),
                                       out.float(), lse, g.float(),
                                       causal=True)
        for got, ref in zip(grads, f32):
            assert got.dtype == torch.bfloat16
            scale = float(ref.abs().max())
            np.testing.assert_allclose(got.float().numpy(), ref.numpy(),
                                       rtol=2e-2, atol=2e-2 * scale)

    def test_rejects_bad_shapes_and_devices(self):
        q = torch.zeros(1, 8, 2, 64)
        lse = torch.zeros(2, 8)
        with pytest.raises(ValueError, match="lse"):
            flash_attention_backward(q, q, q, q, lse[:1], q)
        with pytest.raises(ValueError, match="shape"):
            flash_attention_backward(q, q, q, q[:, :4], lse, q)
        with pytest.raises(ValueError, match="CUDA device"):
            meta = q.to("meta")
            flash_attention_backward(meta, meta, meta, meta,
                                     lse.to("meta"), meta)


def _random_paged(seed, s, h, hkv, d, bs, nb, mb, lens):
    """Histories scattered over shuffled pool pages, trash-padded tables,
    and live data in the trash page (it must never be read)."""
    rng = np.random.RandomState(seed)
    q = rng.randn(s, h, d).astype(np.float32)
    kp = rng.randn(nb, bs, hkv, d).astype(np.float32)
    vp = rng.randn(nb, bs, hkv, d).astype(np.float32)
    free = list(rng.permutation(np.arange(1, nb)))
    bt = np.zeros((s, mb), np.int32)
    for i, n in enumerate(lens):
        for j in range(-(-n // bs)):
            bt[i, j] = free.pop()
    return q, kp, vp, bt, np.asarray(lens, np.int32)


class TestPagedAttention:
    @pytest.mark.parametrize("h,hkv", [(4, 4), (8, 2)])
    def test_matches_pallas_interpret_and_reference(self, h, hkv):
        lens = [9, 0, 16, 3, 31]
        q, kp, vp, bt, sl = _random_paged(2, 5, h, hkv, 16, 8, 24, 4, lens)
        out = paged_attention(*(torch.from_numpy(x)
                                for x in (q, kp, vp, bt, sl))).numpy()
        kern = np.asarray(paged_attention_kernel(
            jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), bt, sl,
            interpret=True))
        ref = np.asarray(jax_paged_reference(
            jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), bt, sl))
        live = sl > 0
        np.testing.assert_allclose(out[live], kern[live], **TOL)
        np.testing.assert_allclose(out[live], ref[live], **TOL)
        # idle slots: the plain version averages trash but stays finite
        assert np.isfinite(out).all()

    def test_rejects_bad_shapes_and_devices(self):
        q, kp, vp, bt, sl = (torch.from_numpy(x) for x in _random_paged(
            3, 2, 4, 2, 16, 4, 8, 2, [5, 0]))
        with pytest.raises(ValueError):
            paged_attention(q, kp, vp, bt, sl[:1])
        with pytest.raises(ValueError):
            paged_attention(q[:, :3], kp, vp, bt, sl)
        with pytest.raises(ValueError):
            paged_attention(*(x.to("meta") for x in (q, kp, vp, bt, sl)))


class TestBuild:
    """The builder's bookkeeping, with a stand-in for nvcc (the real
    compiler exists only on the machine with the card)."""

    @pytest.fixture
    def fake_tree(self, tmp_path, monkeypatch):
        csrc = tmp_path / "csrc"
        csrc.mkdir()
        nvcc = tmp_path / "nvcc.py"
        nvcc.write_text(textwrap.dedent("""\
            import sys
            args = sys.argv[1:]
            if "FAIL" in open(args[-1]).read():
                sys.exit("error: refused")
            open(args[args.index("-o") + 1], "w").write("lib")
            print("ptxas info    : Used 32 registers")
            """))
        # the command becomes: python nvcc.py -o <out> <source>
        monkeypatch.setattr(_build, "CSRC", csrc)
        monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
        monkeypatch.setattr(_build, "_nvcc", lambda: sys.executable)
        monkeypatch.setattr(_build, "NVCC_FLAGS", (str(nvcc),))
        return csrc

    def test_builds_in_parallel_and_rebuilds_on_edit(self, fake_tree):
        (fake_tree / "a.cu").write_text("// a")
        (fake_tree / "b.cu").write_text("// b")
        paths = _build.build(("a", "b"))
        assert all(p.exists() for p in paths.values())
        assert "registers" in (paths["a"].parent
                               / (paths["a"].name + ".log")).read_text()
        mtime = os.path.getmtime(paths["a"])
        assert _build.build(("a",))["a"] == paths["a"]
        assert os.path.getmtime(paths["a"]) == mtime     # not rebuilt
        (fake_tree / "a.cu").write_text("// a, edited")
        assert _build.build(("a",))["a"] != paths["a"]

    def test_rebuilds_when_a_listed_header_changes(self, fake_tree,
                                                   monkeypatch):
        (fake_tree / "a.cu").write_text('#include "h.cuh"')
        (fake_tree / "b.cu").write_text("// b")
        (fake_tree / "h.cuh").write_text("// h")
        monkeypatch.setattr(_build, "HEADERS", {"a": ("h.cuh",)})
        first = _build.build(("a", "b"))
        (fake_tree / "h.cuh").write_text("// h, edited")
        second = _build.build(("a", "b"))
        assert second["a"] != first["a"] and second["a"].exists()
        assert second["b"] == first["b"]     # b does not list the header

    def test_failed_build_raises_with_the_log(self, fake_tree):
        (fake_tree / "bad.cu").write_text("FAIL")
        with pytest.raises(RuntimeError, match="refused"):
            _build.build(("bad",))
        assert not _build.library_path("bad").exists()
