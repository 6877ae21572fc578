"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU each wrapper of paddle_tpu_torch runs its plain PyTorch
version (the CUDA kernels run only on the card, where chip_smoke.py holds
them against these same plain versions). Here the plain versions are
held against the reference: the Pallas kernels in interpret mode and
their jnp fallbacks, on the same numpy inputs.

float32 tolerance rtol 1e-4 / atol 1e-5: XLA's CPU transcendentals (exp)
are fast approximations good to ~1e-5 relative, and the two sides sum in
different orders.
"""
import math
import os
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels.flash_attention import (
    _flash_fwd_bhnd,
    flash_attention as jax_flash_attention,
)
from paddle_tpu.serving.kernels.paged_attention import (
    paged_attention_kernel,
    paged_attention_reference as jax_paged_reference,
)
from paddle_tpu_torch import _build
from paddle_tpu_torch.kernels.flash_attention import flash_attention
from paddle_tpu_torch.serving.kernels.paged_attention import paged_attention

TOL = dict(rtol=1e-4, atol=1e-5)


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

    def test_failed_build_raises_with_the_log(self, fake_tree):
        (fake_tree / "bad.cu").write_text("FAIL")
        with pytest.raises(RuntimeError, match="refused"):
            _build.build(("bad",))
        assert not _build.library_path("bad").exists()
