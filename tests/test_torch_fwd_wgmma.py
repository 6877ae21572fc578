"""The host side of the redesigned flash-attention forward, and its plain
version against the JAX Pallas forward in bf16.

The kernels run only on the card (chip_smoke.py holds them against their
plain version there): bf16 on wgmma with TMA loads, float32 on the CUDA
cores. What surrounds them is Python and C text that the CPU can check:
the dispatch of every bf16 launch to the wgmma kernel, the build's header
list, the TMA alignment rule the wrapper applies to the operands a fused
QKV Llama hands over, and the plain version the kernels are held against.

bf16 tolerance of O (atol 2e-2, rtol 1e-2, as chip_smoke.py's): the
plain version rounds the normalised probabilities p / l to bf16 before
P.V, the reference rounds the unnormalised p and divides by l in fp32
afterwards. Both roundings are relative (2^-9 of each probability), so
the two outputs differ by at most ~2^-8 of sum(p |v|) / l <= max|v| ~ 4,
plus one bf16 rounding of the output each (2^-9 relative): a few bf16
ulps of |out| <~ 4, within 2e-2. The LSE never leaves float32 on either
side (bf16 products are exact in fp32), so it is held to 1e-4.
"""
import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels.flash_attention import _flash_fwd_bhnd
from paddle_tpu_torch import _build
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

CSRC = Path(_build.CSRC)
BF16_TOL = dict(atol=2e-2, rtol=1e-2)
LSE_TOL = dict(atol=1e-4, rtol=1e-4)


def _entry(source):
    text = (CSRC / (source + ".cu")).read_text()
    return text, text[text.index('extern "C" {'):]


class TestDispatch:
    def test_every_bf16_branch_launches_the_wgmma_kernel(self):
        text, entry = _entry("flash_attention")
        branches = re.findall(
            r"dtype == (\d) && head_dim == (\d+)\)\s*return (\S+)<", entry)
        assert sorted(branches) == sorted(
            [("0", d, "launch_f32") for d in ("256", "128", "64")]
            + [(code, d, "tc::launch") for code in ("1", "3")
               for d in ("256", "128", "64")])
        # tc::launch starts flash_fwd_wgmma_kernel and nothing else
        tc = text[text.index("namespace tc {"):text.index("}  // namespace tc")]
        assert re.findall(r"auto kernel = (\w+)<", tc) == [
            "flash_fwd_wgmma_kernel"]
        # no bf16 instantiation of the CUDA-core kernel is left
        assert "<__nv_bfloat16" not in text.replace("__nv_bfloat162", "")
        assert "template <typename T" not in text
        # an edit to the wgmma header rebuilds the forward
        assert "wgmma_bf16.cuh" in _build.HEADERS["flash_attention"]

    def test_float32_kernel_stays_off_the_tensor_cores(self):
        text, _ = _entry("flash_attention")
        f32 = text[text.index("// -- float32: CUDA cores"):
                   text.index("// -- bf16: wgmma + TMA")]
        assert "wgmma" not in f32 and "mma" not in f32.replace("fmaf", "")

    @pytest.mark.parametrize("source", _build.SOURCES)
    def test_headers_list_every_csrc_include(self, source):
        """A source's quoted includes are exactly its ``HEADERS`` entry,
        so an edit to a header rebuilds every library that includes it."""
        text = (CSRC / (source + ".cu")).read_text()
        included = set(re.findall(r'#include "([^"]+)"', text))
        assert included == set(_build.HEADERS.get(source, ()))


def _fused_llama_operands(head_dim, kv_heads):
    """q, k, v as a bf16 fused-QKV Llama hands them to the flash forward
    (captured from one forward pass on the CPU)."""
    heads = 4
    cfg = LlamaConfig(vocab_size=64, hidden_size=heads * head_dim,
                      intermediate_size=64, num_hidden_layers=1,
                      num_attention_heads=heads,
                      num_key_value_heads=kv_heads, dtype="bfloat16",
                      fuse_attention_qkv=True, fuse_mlp=True)
    model = LlamaForCausalLM(cfg, device="cpu")
    seen = []
    real = fa.flash_attention

    def spy(q, k, v, *args, **kw):
        seen.append((q, k, v))
        return real(q, k, v, *args, **kw)

    fa.flash_attention = spy
    try:
        with torch.no_grad():
            model(torch.arange(24).reshape(2, 12) % 64)
    finally:
        fa.flash_attention = real
    assert len(seen) == 1
    return seen[0]


class TestForwardTmaRule:
    @pytest.mark.parametrize("head_dim", fa.HEAD_DIMS)
    @pytest.mark.parametrize("kv_heads", [4, 2, 1])
    def test_fused_qkv_views_pass_untouched(self, head_dim, kv_heads):
        q, k, v = _fused_llama_operands(head_dim, kv_heads)
        assert not v.is_contiguous()   # a strided view of the projection
        before = fa.tma_copies
        out = fa._tma_operands(q, k, v)
        assert fa.tma_copies == before
        assert all(a is b for a, b in zip(out, (q, k, v)))

    @pytest.mark.parametrize("which", [0, 1, 2])
    def test_one_misaligned_operand_is_copied_and_counted(self, which):
        xs = [torch.randn(2, 16, 4, 64).bfloat16() for _ in range(3)]
        # heads D + 4 elements apart: 136 bytes, not a multiple of 16
        xs[which] = torch.randn(2, 16, 4, 68).bfloat16()[..., :64]
        before = fa.tma_copies
        out = fa._tma_operands(*xs)
        assert fa.tma_copies == before + 1
        for i, (x, y) in enumerate(zip(xs, out)):
            assert (y is x) == (i != which)
            assert fa.tma_aligned(y) and torch.equal(x, y)

    def test_cpu_forward_takes_the_plain_path_without_copies(self):
        x = torch.randn(1, 16, 2, 68).bfloat16()[..., :64]
        before = fa.tma_copies
        out, lse = fa.flash_attention(x, x, x, causal=True)
        want, want_lse = fa.flash_attention_reference(
            x.contiguous(), x.contiguous(), x.contiguous(), causal=True)
        assert fa.tma_copies == before
        assert torch.equal(out, want) and torch.equal(lse, want_lse)


def _fold(x):
    """[B, N, H, D] -> [B*H, N, D] bf16 for the Pallas kernel."""
    b, n, h, d = x.shape
    return jnp.swapaxes(jnp.asarray(x), 1, 2).reshape(b * h, n, d).astype(
        jnp.bfloat16)


def _packed_ids(b, n):
    """Each row packs documents of 16-60 tokens (some across a tile)."""
    rng = np.random.RandomState(3)
    ids = np.zeros((b, n), np.int32)
    for r in range(b):
        off, doc = 0, 0
        while off < n:
            length = min(int(rng.randint(16, 61)), n - off)
            ids[r, off:off + length] = doc
            off, doc = off + length, doc + 1
    return ids


class TestBf16PlainAgainstPallas:
    @pytest.mark.parametrize("segmented", [False, True])
    @pytest.mark.parametrize("causal", [True, False])
    @pytest.mark.parametrize("d", fa.HEAD_DIMS)
    def test_out_and_lse(self, d, causal, segmented):
        """B = 2, N = 128, H = 2: the port's plain forward on bf16 inputs
        against the reference's Pallas forward (``_flash_fwd_bhnd``,
        blocks 64/64, interpret mode) on the same bf16 values."""
        b, n, h = 2, 128, 2
        rng = np.random.RandomState(d + 2 * causal + segmented)
        q, k, v = (rng.randn(b, n, h, d).astype(np.float32)
                   for _ in range(3))
        tq, tk, tv = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
        ids = _packed_ids(b, n) if segmented else None
        out, lse = fa.flash_attention(
            tq, tk, tv, causal=causal,
            segment_ids=None if ids is None else torch.from_numpy(ids))
        assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
        segs = None if ids is None else jnp.asarray(
            np.repeat(ids[:, None], h, axis=1).reshape(b * h, n))
        want, want_lse = _flash_fwd_bhnd(
            _fold(q), _fold(k), _fold(v), 1.0 / math.sqrt(d), causal, 64, 64,
            True, segs=segs)
        want = np.swapaxes(np.asarray(want.astype(jnp.float32)).reshape(
            b, h, n, d), 1, 2)
        np.testing.assert_allclose(out.float().numpy(), want, **BF16_TOL)
        np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse)[:, 0],
                                   **LSE_TOL)
