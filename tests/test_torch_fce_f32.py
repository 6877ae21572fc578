"""The float32 fused lm_head + CE forward (kernel 4), dl/dh (kernel 5) and
dW (kernel 6) on the f32_gemm.cuh main loop: what the CPU can check of the
CUDA-core kernels, and the arithmetic they are held to, against the JAX
Pallas kernels in interpret mode at the edges their tiles bring.

The kernels run only on the card (chip_smoke.py holds them against the
plain version there, at every ``FCE_CASES`` shape, float32 at T = 8192,
1024 and 1000 and a ragged H included). Here: the loop and the float32
kernels stay on the CUDA cores (no ``mma``/``wgmma``/TF32, no atomics),
all five float32 kernels launch the loop (dW with both operands MN-major)
and no other block tile product is left, every float32 launch's shared
memory fits a CTA (and the forward's and dW's two CTAs an SM), the build
hashes the loop's header; a float32 CUDA
tensor reaches the C entry points or raises, never the plain version; the
forward's split rule and dh's tile rule at the llama1b shapes; the
forward's per-thread walk (a running max, sum-exp and gold per row over a
thread's columns of each vocab tile, then the merges in the kernel's
fixed order) in plain float32; and the plain float32 forward and backward
against ``_pallas_fwd`` / ``_pallas_bwd`` at T = 200 (ragged at the 64-
and 128-row tiles), V = 2000 (a ragged last vocab tile and chunk), H =
1032 (a ragged last H tile, dW's rows and dh's columns) and labels in the
last tile.

Tolerances, as ``tests/test_torch_fused_ce.py``'s float32 ones: losses
rtol/atol 1e-5 (sums of exps tile by tile against whole 1024-column
blocks; XLA's CPU exp is good to ~1e-5 relative), gradients rtol 1e-4 /
atol 1e-7 (sums of T or V products in another order).
"""
import re
import warnings
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from paddle_tpu.kernels.fused_ce import _pallas_bwd, _pallas_fwd
from paddle_tpu_torch import _build
from paddle_tpu_torch.kernels import fused_ce as fc

CSRC = Path(_build.CSRC)
TEXT = (CSRC / "fused_ce.cu").read_text()
LOOP = (CSRC / "f32_gemm.cuh").read_text()
FWD = TEXT[TEXT.index("// -- forward, float32"):
           TEXT.index("// -- backward, float32")]
BWD = TEXT[TEXT.index("// -- backward, float32"):
           TEXT.index("// -- bf16, forward and backward")]
HOST = TEXT[TEXT.index("}  // namespace tc"):TEXT.index('extern "C" {')]
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-7)
SMEM_LIMIT = 232448      # a CTA's shared memory on an H100 (opt-in maximum)
SM_SMEM = 233472         # an SM's (228 KB), for CTAs resident together
H100_SMS = 132


def _code(text):
    """``text`` without its comments."""
    return re.sub(r"//[^\n]*", "", text)


def _kernel(name):
    """The body of ``__global__ void ... name(...) {...}``."""
    at = re.search(r"__global__ void (?:__launch_bounds__\([^)]*\)\s*)?%s\("
                   % name, TEXT).start()
    return TEXT[at:TEXT.index("\n}\n", at)]


class TestSource:
    def test_float32_loop_stays_on_the_cuda_cores(self):
        for text in (LOOP, FWD, BWD):
            code = _code(text).replace("fmaf", "")
            # tf32 as an instruction type or intrinsic; ptf32 names the
            # float32 headers' namespaces
            assert "mma" not in code
            assert not re.search(r"(?<![a-z])tf32", code.lower())
            assert "atomic" not in code
        # the products are fp32 FMAs on registers
        assert re.findall(r"\bfmaf\([^;]*;", _code(LOOP)) == [
            "fmaf(a[i], b[j], acc[i][j]);"]

    def test_kernels_4_and_5_launch_the_new_loop(self):
        """All five float32 kernels (4, both of 5's, its 64-row dh, 6) run
        ``ptf32gemm::gemm``; dW's Shape has both operands MN-major and the
        header stages A by its own layout; no block tile product but the
        loop is left."""
        shapes = dict(re.findall(
            r"using (\w+) = ptf32gemm::Shape<([^>]*)>;", TEXT))
        # (rows, columns, a thread's columns, A K-major, B K-major)
        assert shapes == {"Wide": "BM, BN, 16, true, false",
                          "WideT": "BM, BN, 16, true, true",
                          "WideMN": "BM, BN, 16, false, false",
                          "Narrow": "64, BN, 8, true, true"}
        assert "using SA = Stage<BM, THREADS, A_K>;" in LOOP
        assert "using SB = Stage<BN, THREADS, B_K>;" in LOOP
        for name, shape in (("fce_fwd_partial", "Wide"),
                            ("fce_bwd_dl", "Wide"), ("fce_bwd_dh", "WideT"),
                            ("fce_bwd_dh64", "Narrow"),
                            ("fce_bwd_dw", "WideMN")):
            body = _kernel(name)
            assert re.findall(r"ptf32gemm::gemm<(\w+)>", body) == [shape]
        # dW: A(m = j, k = t) = h[t][j], B(k = t, n = c) = dl[t][c], K = T
        body = " ".join(_kernel("fce_bwd_dw").split())
        assert ("gemm<WideMN>( Mat{h, hid, hid, t_len}, Mat{dl, ld_dl, cw, "
                "t_len}, blockIdx.x * BM, blockIdx.y, blockIdx.y + 1, t_len,"
                in body)
        assert "DwTile" in body and "__syncthreads" not in body
        # no other block tile product, nor the bf16 header it came from
        for gone in ("tile_product", "smem_bytes", "LDC", "C_BYTES", "ptmma",
                     "Operand<", '#include "mma_bf16.cuh"'):
            assert gone not in TEXT, gone
        assert "tile_product" not in _code(LOOP)

    def test_loop_reads_128_bit_fragments(self):
        """Every shared read of the main loop is a float4: A's rows four k
        at a time, B's four k of a column (K-major) or four columns of a k
        (N-major); no scalar shared read, and the FMAs sum k in order."""
        loop = LOOP[LOOP.index("for (int k = 0; k < BK; ++k)"):]
        loop = loop[:loop.index("if (s == steps - 1)")]
        reads = re.findall(r"\*reinterpret_cast<const float4\*>\(([^)]*)\)",
                           loop)
        assert reads == ["ak", "ak + 16", "bk + 32 * q"]
        assert not re.search(r"\b(as|bs|ak|bk)\[", _code(loop))
        assert "acc[i][j] = fmaf(a[i], b[j], acc[i][j])" in loop

    def test_kernel_arguments_stay_small(self):
        """The float32 kernels take pointers and ints by value, no struct
        (a larger by-value argument slowed the bf16 flash backward)."""
        for name in ("fce_fwd_partial", "fce_bwd_dl", "fce_bwd_dh",
                     "fce_bwd_dh64", "fce_bwd_dw"):
            params = _kernel(name)
            params = params[params.index("(", params.index(name)):
                            params.index(")", params.index(name))]
            for p in params[1:].split(","):
                assert re.match(r"\s*(const )?(float|int)\*? ", p), (name, p)

    @staticmethod
    def _shape_bytes(bm, bn, b_k, a_k=True):
        """A Shape's shared memory from the header's own expressions: each
        of two stages holds BK k of A and of B, a K-major operand's rows
        (transposed) skewed by SKEW floats a group of 4 k, an MN-major one
        as it lies."""
        bk = int(re.search(r"constexpr int BK = (\d+);", LOOP).group(1))
        skew = int(re.search(r"SKEW = (\d+), LD = ROWS \+ 3 \* SKEW;",
                             LOOP).group(1))
        assert "static constexpr int SKEW = 0, LD = ROWS;" in LOOP
        ld_a = bm + 3 * skew if a_k else bm
        ld_b = bn + 3 * skew if b_k else bn
        assert re.search(r"STAGE = A_FLOATS \+ BK \* SB::LD;", LOOP)
        assert re.search(r"A_FLOATS = BK \* SA::LD;", LOOP)
        return eval(re.search(r"SMEM_BYTES = (.*?);", LOOP).group(1),
                    {}, dict(STAGE=bk * (ld_a + ld_b)))

    def test_shared_memory_fits(self):
        """Every float32 launch's dynamic shared memory, evaluated from the
        sources' own expressions, fits a CTA; the forward's and dW's two
        CTAs (their launch bounds) fit an SM, the forward's with its static
        arrays."""
        big = self._shape_bytes(128, 128, False)       # Wide
        wide_t = self._shape_bytes(128, 128, True)     # WideT
        narrow = self._shape_bytes(64, 128, True)      # Narrow
        mn = self._shape_bytes(128, 128, False, a_k=False)   # WideMN
        state = int(re.search(r"FWD_STATE = 3 \* (\d+);", TEXT).group(1)) * 3
        fwd = big + state * 128 * 4          # 128 threads' running state
        assert re.search(r"FWD_SMEM = Wide::SMEM_BYTES \+ FWD_STATE \* "
                         r"Wide::THREADS \* 4;", TEXT)
        static = 128 * 4                     # label_s
        assert "__shared__ int label_s[BM];" in FWD
        assert len(re.findall(r"__shared__", FWD)) == 2   # and the dynamic
        for nbytes in (big, wide_t, narrow, mn, fwd + static):
            assert 0 < nbytes <= SMEM_LIMIT
        assert "fce_fwd_partial<<<" in HOST and "FWD_SMEM, s>>>" in HOST
        assert "__launch_bounds__(Wide::THREADS, 2)" in _kernel(
            "fce_fwd_partial")
        assert 2 * (fwd + static + 1024) <= SM_SMEM   # 1 KB a CTA reserved
        # dW: two stages of 16 k x 128 floats of each operand, as they lie
        # (32 KB), two CTAs an SM
        assert mn == 2 * 16 * (128 + 128) * 4
        assert ("fce_bwd_dw<<<grid_of(hid, cw), WideMN::THREADS, "
                "WideMN::SMEM_BYTES, s>>>(" in HOST)
        assert "__launch_bounds__(WideMN::THREADS, 2)" in _kernel(
            "fce_bwd_dw")
        assert "__shared__" not in _code(_kernel("fce_bwd_dw")).replace(
            "extern __shared__", "")
        assert 2 * (mn + 1024) <= SM_SMEM
        # every float32 launch above 48 KB asks for it
        for kernel, nbytes in (("fce_fwd_partial", fwd), ("fce_bwd_dl", big),
                               ("fce_bwd_dh", wide_t),
                               ("fce_bwd_dh64", narrow), ("fce_bwd_dw", mn)):
            assert nbytes <= 48 * 1024 or "allow_smem(%s," % kernel in HOST

    def test_build_hashes_the_new_header(self):
        assert "f32_gemm.cuh" in _build.HEADERS["fused_ce"]
        assert '#include "f32_gemm.cuh"' in TEXT
        includes = re.findall(r'#include "([\w.]+)"', TEXT)
        assert sorted(includes) == sorted(_build.HEADERS["fused_ce"])

    def test_dh_takes_the_query_tile_rule(self):
        body = HOST[HOST.index("cudaError_t bwd_dh("):]
        body = body[:body.index("\n}\n")]
        assert "ptf32::query_tile_rows((hid + BN - 1) / BN, t_len, &rows)" \
            in body
        assert re.findall(r"(fce_bwd_dh\w*)<<<", body) == ["fce_bwd_dh",
                                                           "fce_bwd_dh64"]


def _tile_rows(hid, t_len, sms=H100_SMS):
    """dh's rows a CTA, from ``f32_tiles.cuh``'s own expression."""
    text = (CSRC / "f32_tiles.cuh").read_text()
    cond, picks = re.search(r"\*rows = (.*?);", text).group(1).split(" ? ")
    big, small = picks.split(" : ")
    took = eval(cond.replace("/", "//"), {},
                dict(batch_heads=-(-hid // 128), n=t_len, sms=sms))
    return int(big if took else small)


@pytest.mark.parametrize("t_len,rows", [(1000, 64), (1024, 64), (8192, 128)])
def test_dh_tile_rule_on_an_h100(t_len, rows):
    """128-row tiles where their grid (token tiles x 16 column tiles at
    H = 2048) gives each of 132 SMs a CTA, else 64 rows: 128 CTAs of 128
    rows at T = 1024 would leave SMs idle."""
    assert _tile_rows(2048, t_len) == rows


def _split_cost(t_len, vocab, splits, sms=H100_SMS):
    """Tile-times of the busiest CTA slot: waves of two CTAs an SM (the
    forward's launch bounds) x the vocab tiles a CTA walks."""
    t_tiles, v_tiles = -(-t_len // 128), -(-vocab // 128)
    return -(-t_tiles * splits // (2 * sms)) * -(-v_tiles // splits)


@pytest.mark.parametrize("t_len", [1000, 1024, 8192])
@pytest.mark.parametrize("vocab", [2000, 32000, 40000])
def test_forward_splits_finish_soonest(t_len, vocab):
    """The fewest tile-times of the busiest slot, then the fewest splits;
    every split walks a tile, at most one split a tile. At T = 8192 one
    tile a CTA (61 waves of 1 against one wave of 63 at V = 32000), at
    T = 1024 one wave of 8-tile walks (the design calls measured both)."""
    splits = fc.forward_splits(t_len, vocab, torch.float32, H100_SMS)
    v_tiles = -(-vocab // 128)
    per = -(-v_tiles // splits)            # the C side's per_split
    assert 1 <= splits <= v_tiles
    assert (splits - 1) * per < v_tiles    # no empty split
    best = min(_split_cost(t_len, vocab, s) for s in range(1, v_tiles + 1))
    assert _split_cost(t_len, vocab, splits) == best
    assert all(_split_cost(t_len, vocab, s) > best for s in range(1, splits))
    want = {2000: 16, 32000: 32, 40000: 32} if t_len < 8192 else \
        {2000: 4, 32000: 250, 40000: 313}
    assert splits == want[vocab]
    # the default is the H100's count
    assert fc.forward_splits(t_len, vocab) == splits


def test_forward_splits_past_one_wave():
    """300 token tiles: more than two CTAs an SM at one split, and one
    split a CTA would take two waves, the second 14 % full; the rule's
    pick is within 1 % of the tile-times a perfect spread would take."""
    t_len, vocab = 128 * 300, 32000
    assert _split_cost(t_len, vocab, 1) == 2 * 250
    splits = fc.forward_splits(t_len, vocab, torch.float32, H100_SMS)
    ideal = 300 * 250 / (2 * H100_SMS)
    assert _split_cost(t_len, vocab, splits) <= 1.01 * ideal


# -- fake CUDA tensors: the C entry points or an error ------------------------

class _FakeLib:
    def __init__(self, err):
        self.err, self.calls = err, []

    def __getattr__(self, name):
        if not name.startswith("pt_fused_ce_"):
            raise AttributeError(name)

        def call(*args):
            self.calls.append((name, args))
            return self.err
        return call

    def pt_error_string(self, err):
        return b"launch refused"


@pytest.mark.parametrize("err", [0, 2])
def test_float32_cuda_tensors_launch_or_raise(monkeypatch, err):
    """Fake CUDA tensors (no card here) reach every C entry point with the
    float32 code and the forward's split count for the card's SMs, or
    raise the launch's error: never the plain version."""
    lib = _FakeLib(err)

    def no_plain(*args, **kwargs):
        raise AssertionError("the plain version ran for CUDA tensors")

    monkeypatch.setattr(_build, "load", lambda name, signatures: lib)
    monkeypatch.setattr(_build, "stream_handle", lambda device: None)
    monkeypatch.setattr(fc, "_sm_count", lambda device: 132)
    monkeypatch.setattr(fc, "fused_lm_head_ce_forward_reference", no_plain)
    monkeypatch.setattr(fc, "fused_lm_head_ce_backward_reference", no_plain)
    t_len, hid, vocab = 1024, 256, 2000
    before = (fc.fwd_launches, fc.dh_launches, fc.dw_launches)
    with FakeTensorMode(), warnings.catch_warnings():
        warnings.simplefilter("ignore")   # FakeTensor.data_ptr()
        h = torch.empty(t_len, hid, device="cuda")
        w = torch.empty(hid, vocab, device="cuda")
        labels = torch.zeros(t_len, dtype=torch.int32, device="cuda")
        lse, g_t = (torch.empty(t_len, device="cuda") for _ in range(2))
        if err:
            with pytest.raises(RuntimeError, match="launch refused"):
                fc.fused_lm_head_ce_forward(h, w, labels)
            with pytest.raises(RuntimeError, match="launch refused"):
                fc.fused_lm_head_ce_backward(h, w, labels, lse, g_t)
        else:
            loss, lse2 = fc.fused_lm_head_ce_forward(h, w, labels)
            dh, dw = fc.fused_lm_head_ce_backward(h, w, labels, lse, g_t)
            assert loss.device.type == dh.device.type == "cuda"
            assert dh.dtype == dw.dtype == torch.float32
    names = [name for name, _ in lib.calls]
    if err:
        assert names == ["pt_fused_ce_fwd", "pt_fused_ce_bwd_dl"]
    else:
        chunks = len(fc.chunk_plan(vocab))
        assert names == ["pt_fused_ce_fwd"] + [
            "pt_fused_ce_bwd_dl", "pt_fused_ce_bwd_dh",
            "pt_fused_ce_bwd_dw"] * chunks
    for name, args in lib.calls:
        assert args[-2] == _build.DTYPE_CODES[torch.float32] == 0
        if name == "pt_fused_ce_fwd":
            assert args[9] == fc.forward_splits(t_len, vocab, torch.float32,
                                                132) == 16
    grew = 0 if err else 1
    assert (fc.fwd_launches, fc.dh_launches, fc.dw_launches) == tuple(
        b + grew for b in before)


# -- the arithmetic, against the Pallas kernels in interpret mode -------------

T, H = 200, 64


def _case(vocab, seed, hid=H):
    rng = np.random.RandomState(seed)
    h = (rng.randn(T, hid) * 0.5).astype(np.float32)
    w = (rng.randn(hid, vocab) * 0.1).astype(np.float32)
    labels = rng.randint(0, vocab, (T,)).astype(np.int32)
    tail = vocab - (vocab - 1) % 128 - 1      # the last tile's first column
    labels[:4] = [vocab - 1, tail, tail - 1, 0]   # the last tile's edges
    g = (rng.rand(T) / T).astype(np.float32)
    g[::7] = 0.0                              # ignored rows
    return h, w, labels, g


def _pallas(h, w, labels, g):
    jh, jw, jl = jnp.asarray(h), jnp.asarray(w), jnp.asarray(labels)
    loss, lse = _pallas_fwd(jh, jw, jl, T, 1024, True)
    dh, dw = _pallas_bwd(jh, jw, jl, lse, jnp.asarray(g), T, 1024, True)
    return [np.array(x) for x in (loss, lse, dh, dw)]


@pytest.mark.parametrize("vocab,hid", [
    pytest.param(2000, H, id="2000"), pytest.param(1288, H, id="1288"),
    pytest.param(2000, 1032, id="2000-H1032")])
def test_plain_float32_matches_pallas_at_the_tile_edges(vocab, hid):
    """T = 200 (the last 128-row tile 72 deep, the last 64-row one 8),
    V = 2000 (last vocab tile 80 wide, last chunk 80) and 1288 (last tile
    8 wide), H = 1032 (the last 128-row H tile of dW and 128-column one of
    dh 8 deep), labels on the last tile's edges, ignored rows."""
    h, w, labels, g = _case(vocab, seed=11, hid=hid)
    want_loss, want_lse, want_dh, want_dw = _pallas(h, w, labels, g)
    th, tw, tl = (torch.from_numpy(x) for x in (h, w, labels))
    loss, lse = fc.fused_lm_head_ce_forward(th, tw, tl)
    np.testing.assert_allclose(loss.numpy(), want_loss, **LOSS_TOL)
    np.testing.assert_allclose(lse.numpy(), want_lse, **LOSS_TOL)
    dh, dw = fc.fused_lm_head_ce_backward(th, tw, tl, torch.from_numpy(
        want_lse), torch.from_numpy(g))
    assert dh.dtype == dw.dtype == torch.float32
    np.testing.assert_allclose(dh.numpy(), want_dh, **GRAD_TOL)
    np.testing.assert_allclose(dw.numpy(), want_dw, **GRAD_TOL)


def _thread_columns():
    """A CTA tile's 128 columns by owner: [16 threads, 8 columns], thread
    (wn, tn) owning wn * 64 + tn * 4 + (j & 3) + 32 (j >> 2)."""
    j = np.arange(8)
    cols = [[wn * 64 + tn * 4 + (j & 3) + 32 * (j >> 2) for tn in range(8)]
            for wn in range(2)]
    return torch.from_numpy(np.array(cols).reshape(16, 8))


def _merge(m, l, m2, l2):
    x = torch.maximum(m, m2)
    return x, l * torch.exp(m - x) + l2 * torch.exp(m2 - x)


def _walk_partials(logits, labels, vocab, splits):
    """fce_fwd_partial in plain float32: per split, each thread's running
    (max, sum-exp, gold) of every row over its columns of the split's
    tiles (columns >= V left out), then the merges in the kernel's order:
    the 8 column lanes by xor 1, 2, 4, then column warp 0 with 1."""
    t_len = logits.shape[0]
    v_tiles = -(-vocab // 128)
    per = -(-v_tiles // splits)
    owned = _thread_columns()
    part = torch.zeros((3, splits, t_len))
    for y in range(splits):
        m = torch.full((t_len, 16), -1e30)
        l = torch.zeros((t_len, 16))
        g = torch.zeros((t_len, 16))
        for nt in range(y * per, min(v_tiles, (y + 1) * per)):
            cols = nt * 128 + owned                        # [16, 8]
            ok = cols < vocab
            x = logits[:, cols.clamp(max=vocab - 1)]       # [T, 16, 8]
            mx = torch.where(ok, x, -1e30).amax(-1)
            new = torch.maximum(m, mx)
            s = torch.where(ok, torch.exp(x - new[..., None]), 0.0).sum(-1)
            l = l * torch.exp(m - new) + s
            m = new
            g += torch.where(ok & (cols == labels[:, None, None]), x,
                             0.0).sum(-1)
        m, l, g = (z.reshape(t_len, 2, 8) for z in (m, l, g))
        for o in (1, 2, 4):
            partner = torch.arange(8) ^ o
            m, l = _merge(m, l, m[..., partner], l[..., partner])
            g = g + g[..., partner]
        m, l, g = m[..., 0], l[..., 0], g[..., 0]
        mm, ll = _merge(m[:, 0], l[:, 0], m[:, 1], l[:, 1])
        part[0, y], part[1, y], part[2, y] = mm, ll, g[:, 0] + g[:, 1]
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


@pytest.mark.parametrize("vocab,sms", [(2000, 132), (2000, 3), (1288, 2)])
def test_forward_walk_matches_pallas(vocab, sms):
    """The per-thread walk and its merges give the Pallas forward's loss
    and lse, one tile a split (132 SMs) or several (splits walking 6, 6
    and 4 tiles at V = 2000, 3 SMs; 6 and 5 at V = 1288, 2 SMs), and
    they would not with the columns past V taken in."""
    h, w, labels, g = _case(vocab, seed=12)
    want_loss, want_lse, _, _ = _pallas(h, w, labels, g)
    logits = torch.from_numpy(h) @ torch.from_numpy(w)
    lab = torch.from_numpy(labels).long()
    splits = fc.forward_splits(T, vocab, torch.float32, sms)
    assert splits == {(2000, 132): 16, (2000, 3): 3, (1288, 2): 2}[
        (vocab, sms)]
    loss, lse = _combine(_walk_partials(logits, lab, vocab, splits))
    np.testing.assert_allclose(loss.numpy(), want_loss, **LOSS_TOL)
    np.testing.assert_allclose(lse.numpy(), want_lse, **LOSS_TOL)
    padded = torch.cat([logits, torch.zeros(T, -vocab % 128)], 1)
    _, unmasked = _combine(_walk_partials(padded, lab, padded.shape[1],
                                          splits))
    assert not np.allclose(unmasked.numpy(), want_lse, **LOSS_TOL)
