"""The int8-weight GEMM's bf16 mode on the tensor cores (``csrc/w8_gemm.cu``:
namespace ``tc``, ``mma.sync`` at M <= 32; namespace ``wg``, ``wgmma``
above), checked where the CPU can check it.

- Read from the source: the bf16 kernels multiply bf16 with fp32
  accumulators (``mma.sync`` m16n8k16; ``wgmma`` m64nBMk16 on y^T = w^T
  x^T, the weight from registers) and the fp32
  kernels with neither nor TF32; no atomics; the bf16 entry point reaches
  only those kernels; each instantiation's shared memory, evaluated from
  the source's constants, fits a block's 227 KB; the wgmma kernel's x
  tiles keep the 128-byte swizzle's 1024-byte alignment; the plan's
  constants are the source's.
- ``w8_plan_bf16``: integers from the shapes alone, a grid that covers
  every output once and every k row once, at most ``W8_MAX_CLUSTER``
  splits, at llama1b's shapes and ragged ones.
- One warp's k step of the mma.sync kernel, walked in plain numpy as the
  kernel walks it: the int8 tile read by ``ldmatrix.trans`` as 16-bit
  pairs, each word's bytes dequantized by the byte-permute selectors into
  the bf16 B fragments of an even and an odd n8 tile, the ``m16n8k16``
  fragment layouts, and the epilogue's 4 consecutive columns a lane,
  against ``x @ w``.
- The wrapper hands each C entry point its own plan (fake CUDA tensors).
"""
import re
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from paddle_tpu_torch import _build
from paddle_tpu_torch.kernels import quant

SRC = (Path(_build.CSRC) / "w8_gemm.cu").read_text()
HEADER = (Path(_build.CSRC) / "mma_bf16.cuh").read_text()
WG_HEADER = (Path(_build.CSRC) / "wgmma_bf16.cuh").read_text()
BLOCK_SMEM = 232448          # 227 KB: the most shared memory a block can use


def _section(begin, end):
    return SRC[SRC.index(begin):SRC.index(end)]


def _code(text):
    """``text`` without its // comments."""
    return re.sub(r"//[^\n]*", "", text)


TC = _section("namespace tc {", "}  // namespace tc")
WG = _section("namespace wg {", "}  // namespace wg")
FP32 = _section("namespace small {", "}  // namespace large")


def _body(name):
    """The body of the C function or template ``name`` (to its closing
    brace at column 0)."""
    m = re.search(r"\b%s\([^)]*\)\s*\{(.*?)\n\}" % name, SRC, re.S)
    return m.group(1)


def _constants(section, known=None):
    consts = dict(known or {})
    for name, expr in re.findall(r"^constexpr int (k\w+) = ([^;]+);",
                                 section, re.M):
        consts[name] = eval(expr, {}, dict(consts))
    return consts


TC_C = _constants(TC)
WG_C = _constants(WG, TC_C)


def _launched():
    """``(family, n)`` of every kernel the tensor-core dispatch (the bf16
    and float16 modes') launches, in bm order: ``("MmaKernel", MI)``,
    ``("WgmmaKernel", WG)``, each for the mode's 16-bit type ``TX``."""
    return [(f, int(v)) for f, v in re.findall(
        r"launch<(\w+)<(\d+), kVec, TX>>", _code(_body("dispatch_tc")))]


def _bm(family, v):
    return 16 * v if family == "MmaKernel" else v


def _wg_tile():
    """The wgmma kernel's threads and stages, read from its Tile."""
    tile = re.search(r"struct Tile \{.*?\n\};", WG, re.S).group(0)
    return (int(re.search(r"kThreads = (\d+);", tile).group(1)),
            int(re.search(r"kStages = (\d+);", tile).group(1)))


def test_bf16_kernels_run_bf16_products_with_fp32_accumulators():
    tc, wg = _code(TC), _code(WG)
    # mma.sync m16n8k16, B fragments from ldmatrix.trans over the int8 tile
    # (float16: the same fragments on mma_f16, .f32.f16.f16.f32)
    assert "ptmma::mma_bf16(acc[mi][h][p]" in tc
    assert "ptmma::mma_f16(acc[mi][h][p]" in tc
    assert re.search(r"float acc\[MI\]\[2\]\[2\]\[4\];", tc)
    for fn, form in (("mma_bf16", "bf16.bf16"), ("mma_f16", "f16.f16")):
        mma = HEADER[HEADER.index("void %s(" % fn):]
        mma = mma[:mma.index("\n}\n")]
        assert "mma.sync.aligned.m16n8k16.row.col.f32.%s.f32" % form in mma
        assert '"+f"(d[0])' in mma         # fp32 accumulators in and out
    assert "ldmatrix_x4_trans(r, b_row" in tc
    assert "wgmma" not in tc
    # wgmma m64nBMk16 on y^T = w^T x^T: w^T from registers (a_frags over
    # the int8 tile), x K-major (no transpose bit), fp32 accumulators
    assert re.search(r"float d\[BM / 2\];", wg)
    assert re.findall(r"ptwg::wgmma_\w+<[^>]*>", wg) == [
        "ptwg::wgmma_rs<0, TX>", "ptwg::wgmma_wait<1>", "ptwg::wgmma_wait<0>"]
    assert ("ptwg::wgmma_rs<0, TX>(d, a[s >> 1][s & 1], "
            "ptwg::desc_kslice(st, s, kBox), 1)") in " ".join(wg.split())
    for n, r in (("64", 32), ("128", 64)):
        rs = WG_HEADER[WG_HEADER.index("void wgmma_rs(float (&d)[%d]" % r):]
        rs = rs[:rs.index("\n}\n")]
        for form in ("bf16.bf16", "f16.f16"):
            assert ("wgmma.mma_async.sync.aligned.m64n%sk16.f32.%s"
                    % (n, form) in rs)
    assert "ldmatrix_x4_trans(" in wg and "tc::dequant_pairs<TX>(" in wg
    assert "fence.proxy.async.shared::cta" in wg   # cp.async x -> wgmma
    # two A register sets alternate by stage; each stays live until the
    # products that read it have ended
    assert "stage(t, a0, a1);" in wg and "stage(t + 1, a1, a0);" in wg
    assert "keep(prev);" in wg and "keep(a1);" in wg
    assert "mma_bf16(" not in wg


def test_fp32_kernels_stay_on_the_cuda_cores():
    code = _code(FP32).lower()
    for word in ("mma", "wgmma", "tf32", "ptmma", "ptwg", "bf16",
                 "bfloat16"):
        assert word not in code, word
    assert "fmaf(" in code
    # no fp32 kernel is templated on the activation type any more: the
    # 16-bit modes' kernels are the tensor-core ones alone, templated on
    # their 16-bit type TX, and instantiated for bf16 and __half only
    assert "typename TX" not in FP32 and "Act<" not in FP32
    for text in (TC, WG):
        assert "typename TX" in text and "Act<" not in text
    calls = re.findall(r"w8_gemm_tc<(\w+)>\(", SRC)
    assert sorted(calls) == ["__half", "bf16"]


def test_no_atomics():
    for text in (SRC, HEADER, WG_HEADER):
        assert re.search(r"\batomic\w*\s*\(", _code(text)) is None
        assert re.search(r"\b(atom|red)\.", _code(text)) is None  # PTX


def test_bf16_entry_reaches_only_the_tensor_core_kernels():
    # the bf16 and float16 entries share one body, each with its type
    assert "w8_gemm_tc<bf16>(" in _code(_body("pt_w8_gemm_bf16"))
    assert "w8_gemm_tc<__half>(" in _code(_body("pt_w8_gemm_f16"))
    body = _code(_body("w8_gemm_tc"))
    assert "static_cast<const TX*>(x)" in body
    assert re.findall(r"dispatch\w*<", body) == ["dispatch_tc<"] * 2
    assert _launched() == [("MmaKernel", 1), ("MmaKernel", 2),
                           ("WgmmaKernel", 64), ("WgmmaKernel", 128)]
    mma = re.search(r"struct MmaKernel \{.*?\n\};", SRC, re.S).group(0)
    assert "tc::w8_gemm_mma<MI, kVec, TX>" in mma
    wgk = re.search(r"struct WgmmaKernel \{.*?\n\};", SRC, re.S).group(0)
    assert "wg::w8_gemm_wgmma<BM, kVec, TX>" in wgk
    dispatch = _code(_body("dispatch_tc"))
    assert "F32Kernel" not in dispatch
    # the fp32 entry reaches only the CUDA-core kernels
    body = _code(_body("pt_w8_gemm"))
    assert re.findall(r"dispatch\w*<", body) == ["dispatch<"] * 2
    assert re.findall(r"launch<(\w+)<", _code(_body("dispatch"))) == \
        ["F32Kernel"] * 3


def test_bf16_shared_memory_fits_a_block():
    c, w = TC_C, WG_C
    assert c["kXLd"] * 2 % 16 == 0 and c["kQLd"] % 16 == 0
    # mma.sync tiles padded by 16 bytes a row: ldmatrix's 8 row addresses
    # hit 8 bank groups
    assert c["kXLd"] * 2 % 128 == 16 and c["kQLd"] % 128 == 16
    # wgmma's x tiles: 128-byte rows, every tile 1024-aligned
    assert w["kBox"] == 64 * 128 and c["kBK"] * c["kQLd"] % 1024 == 0
    wg_threads, wg_stages = _wg_tile()
    for family, v in _launched():
        bm = _bm(family, v)
        if family == "MmaKernel":
            smem = c["kStages"] * (bm * c["kXLd"] * 2 + c["kBK"] * c["kQLd"])
            threads = 32 * c["kWarps"]
        else:
            assert bm * 128 % 1024 == 0
            smem = wg_stages * (bm * 128 + c["kBK"] * c["kQLd"]) + 1024
            threads = wg_threads
            # two warpgroups own the 128 columns, a warp 16: 2 x 4 x 16
            assert threads == 256 == 2 * c["kBN"]
        assert smem <= BLOCK_SMEM, (family, v, smem)
        assert bm * c["kBN"] * 4 <= smem      # the split partial's tile
        assert threads <= 1024


def test_bf16_plan_constants_match_the_source():
    c = TC_C
    assert quant.W8B_BN == c["kBN"] == 32 * c["kWarps"]
    assert quant.W8B_KT == c["kBK"]
    bms = [_bm(f, v) for f, v in _launched()]
    assert bms == sorted(quant.W8B_BM) == [16, 32, 64, 128]
    entry = _code(_body("w8_gemm_tc"))
    assert sorted(map(int, re.findall(r"bm != (\d+)", entry))) == bms
    assert "tc::kBK" in entry
    assert sorted(quant.W8B_CLUSTER_CTAS) == bms
    for bm in bms:
        table = quant.W8B_CLUSTER_CTAS[bm]
        assert len(table) == quant.W8_MAX_CLUSTER
        assert all(type(v) is int and v >= c for c, v in
                   enumerate(table, 1))
    assert set(quant.W8B_ROW_COST) == set(quant.W8B_SHARE) == set(bms)
    # the C side of the cluster-occupancy query the table is read from
    proto = re.search(r"int pt_w8_bf16_cluster_ctas\(([^)]*)\)",
                      SRC).group(1)
    kinds = ["p" if "*" in a else "i" for a in proto.split(",")]
    assert kinds == ["p" if t is quant._P else "i"
                     for t in quant._SIGNATURES["pt_w8_bf16_cluster_ctas"]]


# llama1b's projections (K -> N), the fused qkv_proj and gate_up_proj, K =
# 1000 (b = 8) and 1032 (a last stage 8 rows deep), N off the vector path
PLAN_SHAPES = [(2048, 2048), (2048, 5504), (5504, 2048), (2048, 6144),
               (2048, 11008), (1000, 24), (1032, 2048), (1032, 37), (36, 24)]


@pytest.mark.parametrize("m", [1, 5, 16, 17, 33, 64, 256])
@pytest.mark.parametrize("k,n", PLAN_SHAPES,
                         ids=["%d-%d" % s for s in PLAN_SHAPES])
def test_w8_plan_bf16(m, k, n):
    plan = quant.w8_plan_bf16(m, n, k)
    assert all(type(v) is int for v in plan)
    bm, chunk, splits = plan
    assert bm == (16 if m <= 16 else 32 if m <= 32 else bm)
    assert bm in quant.W8B_BM and (m <= 32 or bm in (64, 128))
    assert bm != 128 or m > 64
    assert chunk % quant.W8B_KT == 0
    assert 1 <= splits <= quant.W8_MAX_CLUSTER
    assert splits == -(-k // chunk)
    assert splits == 1 or chunk >= quant.W8_MIN_CHUNK
    # the grid (splits, ceil(N / bn), ceil(M / bm)) covers each output once
    bn = quant.W8B_BN
    cover = np.zeros((m, n), np.int32)
    for ty in range(-(-m // bm)):
        for tx in range(-(-n // bn)):
            cover[ty * bm:(ty + 1) * bm, tx * bn:(tx + 1) * bn] += 1
    assert (cover == 1).all()
    rows = np.zeros(k, np.int32)
    for z in range(splits):
        lo, hi = z * chunk, min(k, (z + 1) * chunk)
        assert lo < hi
        rows[lo:hi] += 1
    assert (rows == 1).all()


def test_w8_plan_bf16_streams_on_every_sm_at_decode():
    """At the decode batch the weight stream is the cost, so every llama1b
    projection's grid holds at least ~the card's SMs of CTAs (its output
    tiles alone would fill 16 of 132 at N = 2048)."""
    sms = quant.W8_CLUSTER_SMS[0]        # 132 on an H100 SXM
    for k, n in PLAN_SHAPES[:5]:
        bm, chunk, splits = quant.w8_plan_bf16(16, n, k)
        ctas = splits * -(-n // quant.W8B_BN)
        assert ctas >= sms * 3 // 4, (k, n, ctas)


# -- one warp's k step, walked as the kernel walks it -----------------------

def _byte_perm(x, y, sel):
    """CUDA's __byte_perm: result byte j is byte (sel >> 4j) & 7 of y:x."""
    src = [(x >> 8 * i) & 0xFF for i in range(4)] + \
          [(y >> 8 * i) & 0xFF for i in range(4)]
    return sum(src[(sel >> 4 * j) & 7] << 8 * j for j in range(4))


def _i8f(biased, sel):
    bits = np.array([_byte_perm(biased, 0x4B000000, sel)], np.uint32)
    return bits.view(np.float32)[0] - np.float32(8388736.0)


def _bf16(v):
    return torch.tensor(np.float32(v)).to(torch.bfloat16).float().item()


def _dequant_pairs(word, s):
    """The kernel's dequant_pairs: (even lo, even hi), (odd lo, odd hi)."""
    b = word ^ 0x80808080
    even = (_bf16(_i8f(b, 0x7540) * np.float32(s[0])),
            _bf16(_i8f(b, 0x7542) * np.float32(s[0])))
    odd = (_bf16(_i8f(b, 0x7541) * np.float32(s[1])),
           _bf16(_i8f(b, 0x7543) * np.float32(s[1])))
    return even, odd


def _walk(x, q, scales):
    """y [16, 32] of one warp's k step: x [16, 16] bf16 values, q [16, 32]
    int8, scales [32] (one block)."""
    tile = q.view(np.uint8)
    y = np.zeros((16, 32), np.float64)
    # ldmatrix.x4.trans over the tile as 16-bit pairs: lanes 8i..8i+7 give
    # the rows of matrix i (k rows 8 (i & 1).., bytes 16 (i >> 1)..); lane
    # (g, t) receives, of each, 16-bit column g of rows 2t and 2t + 1
    regs = {}
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for i in range(4):
            k = 8 * (i & 1) + 2 * t
            c = 16 * (i >> 1) + 2 * g
            regs[lane, i] = (int(tile[k, c]) | int(tile[k, c + 1]) << 8
                             | int(tile[k + 1, c]) << 16
                             | int(tile[k + 1, c + 1]) << 24)
    for h in range(2):
        for p in range(2):
            # the B fragment of n8 tile (h, p), lane (g, t): b0 = rows 2t,
            # 2t + 1 and b1 = rows 2t + 8, 2t + 9 of its logical column g
            b = np.zeros((16, 8))
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                col = 16 * h + 2 * g               # the lane's scale columns
                for kh in range(2):
                    pair = _dequant_pairs(regs[lane, 2 * h + kh],
                                          (scales[col], scales[col + 1]))[p]
                    b[8 * kh + 2 * t, g], b[8 * kh + 2 * t + 1, g] = pair
            c = x @ b                               # m16n8k16, exact here
            # epilogue: lane (g, t) holds rows g, g + 8 and logical columns
            # 2t, 2t + 1, stored at 16 h + 4t + p and 16 h + 4t + 2 + p
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                for e in range(2):
                    for j in range(2):
                        y[g + 8 * e, 16 * h + 4 * t + 2 * j + p] = \
                            c[g + 8 * e, 2 * t + j]
    return y


@pytest.mark.parametrize("seed", [0, 1])
def test_fragment_walk_is_the_product(seed):
    rng = np.random.RandomState(seed)
    q = rng.randint(-127, 128, size=(16, 32)).astype(np.int8)
    q[0, :4] = (-127, 127, 0, -1)
    scales = (rng.rand(32) * 0.02 + 1e-3).astype(np.float32)
    x = torch.from_numpy(rng.randn(16, 16).astype(np.float32)).to(
        torch.bfloat16).float().numpy().astype(np.float64)
    w = quant.dequantize_int8_weight(
        torch.from_numpy(q), torch.from_numpy(scales[None, :]),
        torch.bfloat16).float().numpy().astype(np.float64)
    np.testing.assert_allclose(_walk(x, q, scales), x @ w, rtol=1e-12,
                               atol=1e-12)


def test_byte_selectors_give_exact_int8_values():
    for v in (-128, -127, -1, 0, 1, 126, 127):
        word = (v & 0xFF) | ((v + 1) & 0xFF) << 8 | ((-v) & 0xFF) << 16
        b = word ^ 0x80808080
        assert _i8f(b, 0x7540) == v
        assert _i8f(b, 0x7541) == np.int8(np.uint8((v + 1) & 0xFF))
        assert _i8f(b, 0x7542) == np.int8(np.uint8((-v) & 0xFF))
        assert _i8f(b, 0x7543) == 0


# -- the wrapper's plans -----------------------------------------------------

class _FakeLib:
    """Stands in for the built w8_gemm library: records each call's
    ``(entry, bm, chunk, splits)``."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("pt_w8_gemm"):
            raise AttributeError(name)

        def call(*args):
            self.calls.append((name,) + tuple(args[8:11]))
            return 0
        return call


@pytest.mark.parametrize("m", [1, 16, 17, 256])
def test_each_dtype_gets_its_own_plan(monkeypatch, m):
    from torch._subclasses.fake_tensor import FakeTensorMode

    lib = _FakeLib()
    monkeypatch.setattr(quant, "_lib", lib)
    monkeypatch.setattr(_build, "stream_handle", lambda device: None)
    k, n = 2048, 5504
    with FakeTensorMode(), warnings.catch_warnings():
        warnings.simplefilter("ignore")   # FakeTensor.data_ptr()
        q = torch.empty(k, n, dtype=torch.int8, device="cuda")
        s = torch.empty(k // 256, n, device="cuda")
        for dtype in (torch.float32, torch.bfloat16):
            quant.int8_weight_matmul(
                torch.empty(m, k, dtype=dtype, device="cuda"), q, s)
    assert lib.calls == [("pt_w8_gemm",) + quant.w8_plan(m, n, k),
                         ("pt_w8_gemm_bf16",) + quant.w8_plan_bf16(m, n, k)]
