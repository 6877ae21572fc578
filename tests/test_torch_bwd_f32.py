"""The float32 flash-attention backward (dq kernel 2, dk/dv kernel 3): what
the CPU can check of the CUDA-core kernels, and their plain version
against the JAX Pallas backward in interpret mode at the edges their
tiles bring.

The kernels run only on the card (chip_smoke.py holds them against the
plain version there, at every ``FLASH_BWD_CASES`` shape). Here: the
float32 section of ``csrc/flash_attention_bwd.cu`` stays on the CUDA
cores (no ``mma``/``wgmma``, no ``typename T`` left from when bf16 ran
there, no atomics), every float32 branch of both entry points launches
those kernels, the grids put the tile on ``blockIdx.y`` and every
launch's shared memory fits a CTA; a float32 CUDA tensor reaches the
kernels' C entry points or raises, never the plain version; and the
plain version agrees with ``jax.vjp`` of the reference's ``_flash_core``
(its ``_dq_kernel``/``_dkv_kernel`` in interpret mode) at N = 200 (ragged
at the 64- and 128-row tiles), D = 64 and 128, causal or not, GQA 16/4
and segment ids whose documents start mid-tile.

Tolerance rtol 1e-4 / atol 1e-4, as ``tests/test_torch_kernels.py``'s
BWD_TOL: XLA's CPU exp is good to ~1e-5 relative and the gradients sum up
to N such terms in another order.
"""
import math
import re
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from paddle_tpu.kernels.flash_attention import _flash_core
from paddle_tpu_torch import _build
from paddle_tpu_torch.kernels import flash_attention as fa

BWD_TOL = dict(rtol=1e-4, atol=1e-4)
TEXT = (Path(_build.CSRC) / "flash_attention_bwd.cu").read_text()
F32 = TEXT[TEXT.index("// -- float32: CUDA cores"):
           TEXT.index("// -- bf16: wgmma + TMA")]
ENTRY = TEXT[TEXT.index('extern "C" {'):]
# a CTA's shared memory on an H100 (the opt-in maximum)
SMEM_LIMIT = 232448


class TestSource:
    def test_float32_section_stays_off_the_tensor_cores(self):
        assert "wgmma" not in F32 and "mma" not in F32.replace("fmaf", "")
        assert "typename T" not in F32 and "round_as" not in TEXT
        assert "atomic" not in F32

    def test_every_float32_branch_launches_the_cuda_core_kernels(self):
        branches = re.findall(
            r"dtype == 0 && head_dim == (\d+)\)\s*return (\w+)<", ENTRY)
        assert sorted(branches) == sorted([
            ("256", "launch_dq_f32"), ("128", "launch_dq_f32"),
            ("64", "launch_dq_f32"), ("256", "launch_dkv_f32"),
            ("128", "launch_dkv_f32"), ("64", "launch_dkv_f32")])
        assert re.findall(r"auto kernel = (\w+)<", F32) == [
            "flash_bwd_dq_f32_kernel", "flash_bwd_dkv_f32_kernel"]

    def test_grids_put_the_tile_on_y(self):
        """blockIdx.x is batch * head, blockIdx.y the tile: the card hands
        out every head's heaviest tile before any head's next."""
        grids = re.findall(r"const dim3 grid\(([^;]*)\);", F32)
        assert grids == ["batch * a.heads, (a.n + BM - 1) / BM",
                         "batch * a.kv_heads, (a.n_kv + BK - 1) / BK"]
        assert "(gridDim.y - 1 - blockIdx.y) * BM" in F32   # dq: last first
        assert "blockIdx.y * BK" in F32                      # dk/dv: first

    @pytest.mark.parametrize("d", fa.HEAD_DIMS)
    @pytest.mark.parametrize("kernel,tiles", [
        ("dq", dict(BM=128, BN=32)), ("dq", dict(BM=64, BN=64)),
        ("dkv", dict(BK=64, BQ=64))])
    def test_shared_memory_fits_a_cta(self, kernel, tiles, d):
        """Each launch's dynamic shared memory, evaluated from the
        launcher's own expression, at every instantiation: two K/V (or
        Q/dO) stages up to D = 128; at D = 256 the one instantiation its
        launcher names (64 rows, 32-key tiles, one stage; dk/dv 64 keys,
        32-query tiles, one stage)."""
        launcher = F32[F32.index("cudaError_t launch_%s_f32" % kernel):]
        tiles = dict(tiles, STAGES=2)
        if d > 128:
            if kernel == "dq":
                body = F32[F32.index("cudaError_t launch_dq_f32("):]
                bm, bn, st = re.search(
                    r"if constexpr \(D > 128\) \{\s*return "
                    r"launch_dq_f32_tiles<D, (\d+), (\d+), (\d+)>",
                    body).groups()
                tiles = dict(BM=int(bm), BN=int(bn), STAGES=int(st))
            else:
                tiles = dict(BK=64, BQ=32, STAGES=1)
                assert ("BQ = D > 128 ? 32 : 64, STAGES = D > 128 ? 1 : 2"
                        in launcher)
        expr = re.search(r"size_t\((.*?)\) \* sizeof\(float\)", launcher,
                         re.S).group(1)
        floats = eval(" ".join(expr.split()), {}, dict(tiles, D=d))
        assert 0 < floats * 4 <= SMEM_LIMIT

    def test_args_keeps_the_bf16_kernels_layout(self):
        """The bf16 kernels take ``Args`` by value, and growing it slowed
        them on the card: the float32 kernels' copy flag is a parameter of
        their own, and ``Args`` holds the fields it held before them."""
        at = TEXT.index("struct Args {")
        body = re.sub(r"//[^\n]*", "", TEXT[at:TEXT.index("};", at)])
        fields = re.findall(r"(\w+)\s*[,;]", body)
        assert fields == ["n", "n_kv", "heads", "kv_heads", "sqb", "sqn",
                          "sqh", "skb", "skn", "skh", "svb", "svn", "svh",
                          "sob", "son", "soh", "scale", "causal", "segs"]
        kernels = re.findall(r"flash_bwd_(?:dq|dkv)_f32_kernel\(([^)]*)\)",
                             F32)
        assert len(kernels) == 2
        assert all(k.split(",")[-2:] == [" Args a", " int vec"]
                   for k in (" ".join(k.split()) for k in kernels))

    def test_forward_and_dq_share_the_query_tile_rule(self):
        """One SM-count rule picks the query rows a CTA of the float32
        forward and dq kernels: ``ptf32::query_tile_rows``."""
        fwd = (Path(_build.CSRC) / "flash_attention.cu").read_text()
        for text, launcher in ((fwd, "cudaError_t launch_f32("),
                               (F32, "cudaError_t launch_dq_f32(")):
            body = text[text.index(launcher):]
            assert "ptf32::query_tile_rows(" in body[:body.index("\n}\n")]
        assert "cudaDevAttrMultiProcessorCount" not in F32
        assert "cudaDevAttrMultiProcessorCount" not in fwd

    @pytest.mark.parametrize("batch,heads,n,rows", [
        (8, 16, 1024, 128),   # the llama1b training row
        (8, 6, 1024, 128),    # the bench row
        (1, 16, 2048, 128),   # the largest serving prefill bucket
        (1, 16, 1024, 64),    # 128 CTAs of 128 rows: SMs left idle
        (1, 16, 512, 64),
        (1, 16, 200, 64)])
    def test_query_tile_rows_on_an_h100(self, batch, heads, n, rows):
        """The rule, evaluated from the header's own expression at the
        H100's 132 SMs."""
        text = (Path(_build.CSRC) / "f32_tiles.cuh").read_text()
        cond, picks = re.search(r"\*rows = (.*?);", text).group(1) \
            .split(" ? ")
        big, small = picks.split(" : ")
        took = eval(cond.replace("/", "//"), {},
                    dict(batch_heads=batch * heads, n=n, sms=132))
        assert int(big if took else small) == rows


class _FakeLib:
    """The two C entry points: record each call, return ``err``."""

    def __init__(self, err):
        self.err, self.calls = err, []

    def pt_flash_attention_bwd_dq(self, *args):
        self.calls.append(("dq", args))
        return self.err

    def pt_flash_attention_bwd_dkv(self, *args):
        self.calls.append(("dkv", args))
        return self.err

    def pt_error_string(self, err):
        return b"launch refused"


@pytest.mark.parametrize("err", [0, 2])
def test_float32_cuda_tensors_launch_or_raise(monkeypatch, err):
    """Fake CUDA tensors (no card here) reach both C entry points with the
    float32 code, or raise the launch's error: never the plain version."""
    lib = _FakeLib(err)

    def no_plain(*args, **kwargs):
        raise AssertionError("the plain version ran for CUDA tensors")

    monkeypatch.setattr(_build, "load", lambda name, signatures: lib)
    monkeypatch.setattr(_build, "stream_handle", lambda device: None)
    monkeypatch.setattr(fa, "flash_attention_backward_reference", no_plain)
    before = (fa.dq_launches, fa.dkv_launches)
    with FakeTensorMode(), warnings.catch_warnings():
        warnings.simplefilter("ignore")   # FakeTensor.data_ptr()
        q, out, dout = (torch.empty(2, 200, 4, 128, device="cuda")
                        for _ in range(3))
        k, v = (torch.empty(2, 200, 2, 128, device="cuda") for _ in range(2))
        lse = torch.empty(8, 200, device="cuda")
        if err:
            with pytest.raises(RuntimeError, match="launch refused"):
                fa.flash_attention_backward(q, k, v, out, lse, dout, True)
        else:
            dq, dk, dv = fa.flash_attention_backward(q, k, v, out, lse,
                                                     dout, True)
            assert dq.device.type == dk.device.type == "cuda"
            assert dq.dtype == dk.dtype == dv.dtype == torch.float32
    assert [name for name, _ in lib.calls] == (["dq"] if err
                                               else ["dq", "dkv"])
    # the dtype code follows the pointers, sizes, strides, scale, causal
    for name, args in lib.calls:
        at = (7 if name == "dq" else 8) + 6 + 12 + 2
        assert args[at] == _build.DTYPE_CODES[torch.float32] == 0
    grew = 0 if err else 1
    assert (fa.dq_launches, fa.dkv_launches) == (before[0] + grew,
                                                 before[1] + grew)


def _fold(x):
    """[B, N, H, D] -> [B*H, N, D]"""
    b, n, h, d = x.shape
    return jnp.swapaxes(jnp.asarray(x), 1, 2).reshape(b * h, n, d)


def _unfold(x, b, h):
    x = np.asarray(x)
    return np.swapaxes(x.reshape(b, h, x.shape[1], x.shape[2]), 1, 2)


def _segments(starts, n):
    """[1, n] int32 ids: a new document at each of ``starts``."""
    ids = np.zeros((1, n), np.int32)
    for s in starts:
        ids[0, s:] += 1
    return ids


# (heads, kv heads, head_dim, causal, document starts or None); N = 200 is
# ragged at the kernels' 64- and 128-row tiles, and 70 and 150 start
# documents inside a tile of either size
CASES = {"d64": (2, 2, 64, True, None),
         "d128": (2, 2, 128, True, None),
         "d128_noncausal": (2, 2, 128, False, None),
         "gqa_16_4": (16, 4, 128, True, None),
         "segments_mid_tile": (2, 2, 64, True, (70, 150)),
         "segments_mid_tile_noncausal": (2, 2, 128, False, (70, 150)),
         "segments_gqa": (4, 2, 64, True, (70, 150))}
N, BLOCK = 200, 40   # the Pallas kernels tile N = 200 by 40


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_float32_backward_matches_pallas_interpret(case):
    heads, kv_heads, d, causal, starts = CASES[case]
    rep = heads // kv_heads
    rng = np.random.RandomState(13)
    q, g = (rng.randn(1, N, heads, d).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(1, N, kv_heads, d).astype(np.float32)
            for _ in range(2))
    segs = None if starts is None else _segments(starts, N)
    scale = 1.0 / math.sqrt(d)

    tq, tk, tv, tg = (torch.from_numpy(x) for x in (q, k, v, g))
    tsegs = None if segs is None else torch.from_numpy(segs)
    out, lse = fa.flash_attention(tq, tk, tv, causal, segment_ids=tsegs)
    got = fa.flash_attention_backward(tq, tk, tv, out, lse, tg, causal,
                                      segment_ids=tsegs)

    fsegs = None if segs is None else jnp.broadcast_to(
        jnp.asarray(segs)[:, None, :], (1, heads, N)).reshape(heads, N)
    _, vjp = jax.vjp(
        lambda a, b_, c: _flash_core(a, b_, c, fsegs, scale, causal, BLOCK,
                                     BLOCK, True),
        _fold(q), _fold(np.repeat(k, rep, axis=2)),
        _fold(np.repeat(v, rep, axis=2)))
    jdq, jdk, jdv = (_unfold(x, 1, heads) for x in vjp(_fold(g)))
    want = (jdq, jdk.reshape(1, N, kv_heads, rep, d).sum(3),
            jdv.reshape(1, N, kv_heads, rep, d).sum(3))
    for x, y in zip(got, want):
        assert x.dtype == torch.float32
        np.testing.assert_allclose(x.numpy(), y, **BWD_TOL)
