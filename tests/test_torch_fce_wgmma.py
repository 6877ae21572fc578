"""The host side of the fused lm_head + CE kernels on wgmma, and their
arithmetic against the JAX Pallas kernels.

The bf16 kernels (the forward's logits and the backward's dl, dh and dW,
one ``wgmma`` main loop with TMA loads in ``csrc/fused_ce.cu``) run only on
the card, where chip_smoke.py holds them against the plain version. What
surrounds them is Python and C text the CPU can check: the ctypes
signatures against the C entry points, the dispatch of every bf16 launch
to the wgmma kernels, the build's header list, the forward's split count
and the vocab chunk plan the wrapper walks, the forward's per-tile
partials and their combine, and the plain backward the kernels are held
against.

Tolerances. float32: dh and dW sum T or V products in another order than
the Pallas kernels' vocab tiles, rtol 1e-4, atol 1e-7 (as
``test_torch_fused_ce.py``). bfloat16: dl is rounded to bf16 at the same
point on both sides, but a p one float32 ulp apart can round to the
neighbouring bf16 (2^-8 relative) in a few elements, and dh and dW are
rounded to bf16 themselves: atol 1e-2 x max|grad|, rtol 1e-2. The chunked
walk in float32 against the plain version: 1e-5 relative, 1e-6 x
max|grad| absolute (the same products, summed chunk by chunk). The
forward's partials and combine against the Pallas forward, both dtypes:
the same float32 logits (bf16 inputs are exact in float32) summed over
256-column tiles in exp2 where Pallas sums 1024-column blocks in exp;
loss and lse are ~7 (ulp 4.8e-7), so rtol 1e-5 and atol 1e-5.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels.fused_ce import _pallas_bwd, _pallas_fwd
from paddle_tpu_torch import _build
from paddle_tpu_torch.kernels import fused_ce as fc
from test_torch_bwd_wgmma import _c_entry_points

CSRC = Path(_build.CSRC)
T, H = 512, 64
F32_GRAD = dict(rtol=1e-4, atol=1e-7)
BF16_GRAD = dict(rtol=1e-2, scale=1e-2)


def _source():
    text = (CSRC / "fused_ce.cu").read_text()
    return text, text[text.index('extern "C" {'):]


class TestHostSide:
    def test_ctypes_signatures_match_the_c_entry_points(self):
        found = _c_entry_points("fused_ce")
        assert set(fc._SIGNATURES) <= set(found)
        for name, argtypes in fc._SIGNATURES.items():
            assert found[name] == len(argtypes), name

    def test_bf16_backward_dispatches_only_to_the_wgmma_kernels(self):
        text, entry = _source()
        # every bf16 branch of the four entry points goes to tc::
        bf16 = re.findall(r"if \(dtype == 1\)\s*return (\S+)\(", entry)
        assert sorted(bf16) == ["tc::launch_dh", "tc::launch_dl",
                                "tc::launch_dw", "tc::launch_fwd"]
        # each tc launcher starts its wgmma kernel, and only those call the
        # shared main loop
        tc = text[text.index("namespace tc {"):
                  text.index("}  // namespace tc")]
        assert sorted(re.findall(r"launch\((\w+),", tc)) == [
            "fce_bwd_dh_wgmma", "fce_bwd_dl_wgmma", "fce_bwd_dw_wgmma",
            "fce_fwd_wgmma"]
        assert len(re.findall(r"\bgemm<(?:true|false)", tc)) == 4
        assert "tma_load_2d" in tc and "wgmma_ss<" in tc
        # the CUDA-core backward takes float32 only: no bf16 instantiation
        simt = text[text.index("// -- backward, float32"):
                    text.index("// -- bf16, forward and backward")]
        for kernel in ("fce_bwd_dl", "fce_bwd_dh", "fce_bwd_dw"):
            assert re.search(r"%s\(const float\* __restrict__" % kernel, simt)
        assert "template" not in simt and "bf16" not in simt
        assert not re.search(r"bwd_d[lhw]<\w", text)   # no <bf16> or <T>

    def test_bf16_forward_runs_only_on_the_wgmma_main_loop(self):
        text, _ = _source()
        # tc::launch_fwd starts fce_fwd_wgmma, then the combine
        body = text[text.index("cudaError_t launch_fwd("):]
        body = body[:body.index("\n}\n")]
        assert re.findall(r"launch\((\w+),", body) == ["fce_fwd_wgmma"]
        assert body.index("launch(fce_fwd_wgmma") < body.index("combine(")
        # fce_fwd_wgmma is h . W on gemm<false, true>: A = h K-major, B = W
        # MN-major, the dl product's operand form
        kernel = text[text.index("fce_fwd_wgmma(const __grid_constant__"):]
        kernel = kernel[:kernel.index("\n}\n")]
        assert re.findall(r"gemm<(\w+), (\w+)>", kernel) == [
            ("false", "true")]
        assert "FwdEpilogue" in kernel
        # the CUDA-core forward takes float32 only; the bf16 path has no
        # mma.sync operand (Operand<bf16>) and no block tile product is
        # left (the float32 kernels run on csrc/f32_gemm.cuh)
        simt = text[text.index("// -- forward, float32"):
                    text.index("// -- backward, float32")]
        assert re.search(r"fce_fwd_partial\(const float\* __restrict__", simt)
        assert "template" not in simt and "bf16" not in simt
        assert not re.search(r"\btile_product\b", text)
        assert "block_mma" not in text and "Operand<bf16>" not in text
        assert "Operand<" not in text
        assert not re.search(r"\bfwd<\w", text)

    def test_build_hashes_the_wgmma_header(self):
        assert "wgmma_bf16.cuh" in _build.HEADERS["fused_ce"]
        text, _ = _source()
        assert '#include "wgmma_bf16.cuh"' in text

    def test_kernel_names_keep_the_profile_prefix(self):
        text, _ = _source()
        kernels = re.findall(
            r"__global__ void (?:__launch_bounds__\([^)]*\)\s*)?(\w+)\(",
            text)
        # four wgmma kernels, the combine, and the float32 forward, dl, dh
        # (128- and 64-row tiles) and dW
        assert len(kernels) == 10
        assert "fce_fwd_wgmma" in kernels and "fce_bwd_dh64" in kernels
        assert all(k.startswith("fce_") for k in kernels)


def _wgmma_tile_n():
    text, _ = _source()
    return int(re.search(r"constexpr int TN = (\d+);", text).group(1))


@pytest.mark.parametrize("vocab", [2000, 32000, 40000])
def test_bf16_forward_splits_are_the_wgmma_tiles(vocab):
    """One split per TN-column tile of the bf16 product, whatever T: the
    count the C side checks (and refuses otherwise), within its float32
    bound of one split per 128 columns."""
    tn = _wgmma_tile_n()
    text, _ = _source()
    assert "if (splits != (vocab + TN - 1) / TN) return cudaErrorInvalidValue;" \
        in text
    for t_len in (1000, 8192):
        splits = fc.forward_splits(t_len, vocab, torch.bfloat16)
        assert splits == -(-vocab // tn)
        assert 1 <= splits <= -(-vocab // 128)


@pytest.mark.parametrize("vocab,chunk,last", [(2000, 480, 80),
                                              (32000, 4096, 3328),
                                              (40000, 4096, 3136)])
def test_chunk_plan_covers_the_vocab_once(vocab, chunk, last):
    plan = fc.chunk_plan(vocab)
    assert fc.chunk_columns(vocab) == chunk
    assert [c0 for c0, _ in plan] == list(range(0, vocab, chunk))
    assert sum(cw for _, cw in plan) == vocab
    assert all(cw == chunk for _, cw in plan[:-1]) and plan[-1][1] == last
    # TMA: the workspace's row stride and every chunk's first column and
    # width are multiples of 16 bytes in bf16 (dW is written in pairs)
    assert (chunk * 2) % 16 == 0
    assert all(c0 % 8 == 0 and cw % 8 == 0 for c0, cw in plan)


def _case(vocab, dtype, seed):
    """h, w in ``dtype`` and safe labels, an upstream gradient with zeros
    on ignored rows, and the Pallas forward's lse (one input for both)."""
    rng = np.random.RandomState(seed)
    h = (rng.randn(T, H) * 0.5).astype(np.float32)
    w = (rng.randn(H, vocab) * 0.1).astype(np.float32)
    labels = rng.randint(0, vocab, (T,)).astype(np.int32)
    g = (rng.rand(T) / T).astype(np.float32)
    g[::7] = 0.0
    jh, jw = jnp.asarray(h, dtype), jnp.asarray(w, dtype)
    _, lse = _pallas_fwd(jh, jw, jnp.asarray(labels), 256, 1024, True)
    return jh, jw, labels, g, np.array(lse, np.float32)


def _close(got, want, rtol, atol=0.0, scale=None):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    if scale is not None:
        atol = scale * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_backward_matches_pallas_at_a_ragged_last_chunk(dtype):
    """V = 1000: chunks of 224 columns and a last one of 104, and a vocab
    the Pallas kernels pad to their 1024-column block."""
    vocab = 1000
    assert fc.chunk_plan(vocab)[-1] == (896, 104)
    jh, jw, labels, g, lse = _case(vocab, dtype, seed=3)
    want_dh, want_dw = _pallas_bwd(jh, jw, jnp.asarray(labels),
                                   jnp.asarray(lse), jnp.asarray(g), 256,
                                   1024, True)
    tdtype = getattr(torch, dtype)
    th = torch.from_numpy(np.array(jh, np.float32)).to(tdtype)
    tw = torch.from_numpy(np.array(jw, np.float32)).to(tdtype)
    dh, dw = fc.fused_lm_head_ce_backward(
        th, tw, torch.from_numpy(labels), torch.from_numpy(lse),
        torch.from_numpy(g))
    assert dh.dtype == tdtype and dw.dtype == tdtype
    tol = F32_GRAD if dtype == "float32" else BF16_GRAD
    _close(dh, want_dh, **tol)
    _close(dw, want_dw, **tol)


@pytest.mark.parametrize("vocab", [1000, 2000])
def test_chunked_walk_equals_the_plain_backward(vocab):
    """The kernels' order in float32: per chunk, dl into a [T, chunk]
    workspace that still holds the previous chunk's columns, the dh and dW
    products reading it through an extent of cw (the tensor map's zero
    fill), dh summed over chunks. It gives the plain version's dh and dW."""
    jh, jw, labels, g, lse = _case(vocab, "float32", seed=4)
    h = torch.from_numpy(np.array(jh))
    w = torch.from_numpy(np.array(jw))
    lab = torch.from_numpy(labels).long()
    lse_t, g_t = torch.from_numpy(lse), torch.from_numpy(g)
    chunk = fc.chunk_columns(vocab)
    work = torch.full((T, chunk), 1e3)          # stale columns, never read
    dh = torch.zeros(T, H)
    dw = torch.full((H, vocab), float("nan"))   # every column written once
    for c0, cw in fc.chunk_plan(vocab):
        logits = h @ w[:, c0:c0 + cw]
        onehot = (lab[:, None] == torch.arange(c0, c0 + cw)).float()
        work[:, :cw] = (torch.exp(logits - lse_t[:, None]) - onehot) \
            * g_t[:, None]
        seen = torch.zeros_like(work)
        seen[:, :cw] = work[:, :cw]              # the map's extent is cw
        w_chunk = torch.zeros(H, chunk)
        w_chunk[:, :cw] = w[:, c0:c0 + cw]
        dh += seen @ w_chunk.T
        dw[:, c0:c0 + cw] = (h.T @ seen)[:, :cw]
    want_dh, want_dw = fc.fused_lm_head_ce_backward_reference(
        h, w, lab.int(), lse_t, g_t)
    for got, want in ((dh, want_dh), (dw, want_dw)):
        np.testing.assert_allclose(
            got.numpy(), want.numpy(), rtol=1e-5,
            atol=1e-6 * float(want.abs().max()))


LOG2E = np.float32(1.4426950408889634)


def _tile_partials(logits, labels, vocab, tn):
    """fce_fwd_wgmma's partials in plain float32: per row and TN-column
    tile, the max in the natural log, the sum of exp2((x - max) * log2 e)
    and the gold logit, over the tile's columns < V only."""
    splits = -(-vocab // tn)
    part = torch.zeros((3, splits, logits.shape[0]))
    for y in range(splits):
        x = logits[:, y * tn:min(vocab, (y + 1) * tn)]
        m = x.max(1).values
        part[0, y] = m
        part[1, y] = torch.exp2(x * LOG2E - (m * LOG2E)[:, None]).sum(1)
        cols = torch.arange(y * tn, y * tn + x.shape[1])
        part[2, y] = torch.where(cols[None] == labels[:, None], x, 0.0).sum(1)
    return part


def _combine(part):
    """fce_fwd_combine: (loss, lse), the splits taken in order."""
    m = part[0].max(0).values
    lsum = torch.zeros_like(m)
    gold = torch.zeros_like(m)
    for y in range(part.shape[1]):
        lsum += torch.exp(part[0, y] - m) * part[1, y]
        gold += part[2, y]
    lse = m + torch.log(lsum)
    return lse - gold, lse


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("vocab", [2000, 1288])
def test_forward_partials_match_pallas(vocab, dtype):
    """V = 2000 (last tile 208 wide) and 1288 (last tile 8 wide): the bf16
    forward's tile partials and the combine give the Pallas forward's loss
    and lse, and they would not with the last tile's columns past V read
    as the zeros TMA fills them with."""
    tn = _wgmma_tile_n()
    rng = np.random.RandomState(5)
    h = (rng.randn(T, H) * 0.5).astype(np.float32)
    w = (rng.randn(H, vocab) * 0.1).astype(np.float32)
    labels = rng.randint(0, vocab, (T,)).astype(np.int32)
    labels[:4] = [0, vocab - 1, tn - 1, tn]   # the edges of the tiles
    jh, jw = jnp.asarray(h, dtype), jnp.asarray(w, dtype)
    want_loss, want_lse = _pallas_fwd(jh, jw, jnp.asarray(labels), 256,
                                      1024, True)
    logits = (torch.from_numpy(np.array(jh, np.float32))
              @ torch.from_numpy(np.array(jw, np.float32)))
    lab = torch.from_numpy(labels).long()
    loss, lse = _combine(_tile_partials(logits, lab, vocab, tn))
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(loss.numpy(), np.array(want_loss), **tol)
    np.testing.assert_allclose(lse.numpy(), np.array(want_lse), **tol)
    padded = torch.cat([logits, torch.zeros(T, -vocab % tn)], 1)
    _, unmasked = _combine(_tile_partials(padded, lab, padded.shape[1], tn))
    assert not np.allclose(unmasked.numpy(), np.array(want_lse), **tol)
