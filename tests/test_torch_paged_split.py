"""The split histories of the port's paged-attention kernels, on the CPU.

The CUDA kernels (``csrc/paged_attention.cu``) cut each slot's pages into
splits chosen by ``split_plan`` from shapes alone, compute per-split
partials (O, m, l) and merge them. Their plain split-then-merge versions
(``*_split_reference``) are held here against the reference's Pallas
kernels in interpret mode and its plain versions:

- (a) the plan covers every page of every length exactly once, takes one
  split where a suffix prefill's grid fills the card (and two at the
  1024-token bucket, whose 128 CTAs do not), and takes only ints;
- (b) the split decode at lengths just below, at and above a split
  boundary, idle slots, GQA and int8 pages;
- (c) the split mixed step, with a row whose later split lies wholly past
  its horizon, decode rows (q_len 1) and rows past q_len;
- (d) one split equals the unsplit plain version.

Inputs are made with numpy from a seed and handed to both packages.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels import quant as jquant
from paddle_tpu.serving.kernels.paged_attention import (
    mixed_paged_attention_kernel,
    mixed_paged_attention_reference as jax_mixed_reference,
    paged_attention_kernel,
    paged_attention_reference as jax_paged_reference,
)
from paddle_tpu_torch.serving.kernels import paged_attention as pa

# the plain split versions against the Pallas kernels in interpret mode:
# both fp32, sums over at most a few dozen keys in another order (per
# split, then merged, vs per page online); int8 pages dequantize to the
# same fp32 values on both sides
TOL = dict(atol=1e-5, rtol=1e-5)
# int8 pages against the unquantized pools (standard normal K/V): the
# rounding error per element is <= max|vector| / 254
INT8_VS_FP32_ATOL = 0.05
# one split against the unsplit plain version: the same exponentials and
# sums up to the order of one merge step
ONE_SPLIT_TOL = dict(atol=1e-6, rtol=0)


def _pools(seed, bs, hkv, d, totals, max_blocks):
    """Histories of ``totals[s]`` tokens on shuffled pages of a pool whose
    unused pages (the trash page 0 included) hold noise that must never
    be read; block tables padded with the trash page."""
    rng = np.random.RandomState(seed)
    pages = [-(-n // bs) for n in totals]
    nb = sum(pages) + 1
    kp = rng.randn(nb, bs, hkv, d).astype(np.float32)
    vp = rng.randn(nb, bs, hkv, d).astype(np.float32)
    ids = list(rng.permutation(nb - 1) + 1)
    bt = np.zeros((len(totals), max_blocks), np.int32)
    for i, n in enumerate(pages):
        bt[i, :n] = [ids.pop() for _ in range(n)]
    return rng, kp, vp, bt


def _int8(kp, vp):
    kq, ks = jquant.quantize_int8_page(jnp.asarray(kp))
    vq, vs = jquant.quantize_int8_page(jnp.asarray(vp))
    return [np.asarray(x) for x in (kq, ks, vq, vs)]


def _t(*xs):
    return [torch.from_numpy(np.array(x)) for x in xs]


# -- (a) the plan ---------------------------------------------------------------

def _live_splits(plan, n_keys, block_size):
    """The combine kernel's count of the splits that hold keys
    ``0 .. n_keys - 1`` of a row (csrc/paged_attention.cu)."""
    pages = -(-n_keys // block_size)
    return min(plan.splits, -(-pages // plan.split_pages))


# (slots, chunk, heads, kv_heads, max_blocks, block_size, decode): the
# decode batch and the mixed step of the serving path, the suffix
# prefill, GQA, a longer table, and small tables
PLAN_SHAPES = [(16, 1, 16, 16, 128, 16, True),
               (16, 16, 16, 16, 128, 16, False),
               (1, 1024, 16, 16, 128, 16, False),
               (1, 128, 16, 16, 128, 16, False),
               (4, 16, 32, 8, 128, 16, False),
               (16, 1, 16, 16, 256, 16, True),
               (4, 1, 8, 2, 10, 4, True),
               (3, 4, 8, 2, 7, 4, False)]


@pytest.mark.parametrize("shape", PLAN_SHAPES,
                         ids=lambda s: "x".join(map(str, s[:6])) +
                         ("-decode" if s[6] else ""))
def test_plan_covers_every_page_once(shape):
    *dims, decode = shape
    plan = pa.split_plan(*dims, decode=decode)
    mb, bs = dims[4], dims[5]
    assert plan.splits * plan.split_pages >= mb > (plan.splits - 1) * \
        plan.split_pages
    for n_keys in range(mb * bs + 1):
        pages = -(-n_keys // bs)
        live = _live_splits(plan, n_keys, bs)
        assert live <= plan.splits
        covered = [p for i in range(live)
                   for p in range(i * plan.split_pages,
                                  min((i + 1) * plan.split_pages, mb))
                   if p < pages]
        assert covered == list(range(pages)), n_keys
        # each live split holds at least one of the row's keys
        assert all(i * plan.split_pages < pages for i in range(live))


@pytest.mark.parametrize("slots,chunk,heads", [(1, 2048, 16), (1, 1024, 32),
                                               (2, 1024, 16)])
def test_plan_one_split_at_a_suffix_prefill_that_fills_the_card(
        slots, chunk, heads):
    # 128-row tiles: 256 CTAs or more for the card's 132 SMs
    plan = pa.split_plan(slots, chunk, heads, heads, 128, 16)
    assert plan.kernel == "tiles" and plan.tile_rows == 128
    assert plan.splits == 1 and plan.split_pages == 128


def test_plan_at_the_suffix_prefill_shape():
    # S = 1, C = 1024, 16 heads: 8 tiles of 128 rows x 16 heads = 128 CTAs,
    # under one a SM, so the history splits in two (measured faster on the
    # card than one split of 128- or 64-row tiles)
    plan = pa.split_plan(1, 1024, 16, 16, 128, 16)
    assert plan == pa.SplitPlan("tiles", 128, 8, 64, 2)


def test_plan_splits_the_decode_batch():
    # 16 slots x 16 kv heads leave the card's CTA slots half empty: one
    # 2048-token slot must not walk its 128 pages alone
    plan = pa.split_plan(16, 1, 16, 16, 128, 16, decode=True)
    assert plan.kernel == "decode" and plan.splits > 1
    assert plan.split_pages * 16 == 256
    mixed = pa.split_plan(16, 16, 16, 16, 128, 16)
    assert mixed.kernel == "rows" and mixed.splits > 1


@pytest.mark.parametrize("bad", [torch.tensor(16), 16.0, np.int64(16), True])
def test_plan_takes_only_ints(bad):
    with pytest.raises(TypeError, match="ints"):
        pa.split_plan(bad, 1, 16, 16, 128, 16)
    with pytest.raises(TypeError, match="ints"):
        pa.split_plan(16, 1, 16, 16, bad, 16, decode=True)


def test_ctypes_signatures_match_the_c_entry_points():
    text = (Path(pa.__file__).resolve().parents[2] / "csrc" /
            "paged_attention.cu").read_text()
    block = text[text.index('extern "C" {'):]
    found = {m.group(1): len([p for p in m.group(2).split(",")
                              if p.strip()])
             for m in re.finditer(r"\bint\s+(pt_\w+)\s*\(([^)]*)\)", block)}
    for name, argtypes in pa._SIGNATURES.items():
        assert found[name] == len(argtypes), name


# -- (b) the split decode ---------------------------------------------------

# bs = 4 and 2 pages a split: 8 keys. Lengths just below, at and above
# the first and second boundaries, a one-token slot and idle slots.
DECODE_LENS = [7, 8, 9, 0, 15, 16, 17, 1, 0]


class TestSplitDecode:
    @pytest.mark.parametrize("h,hkv", [(8, 2), (4, 4)], ids=["gqa", "mha"])
    @pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
    def test_matches_pallas_interpret(self, h, hkv, int8):
        d, bs, mb = 16, 4, 6
        rng, kp, vp, bt = _pools(0, bs, hkv, d, DECODE_LENS, mb)
        q = rng.randn(len(DECODE_LENS), h, d).astype(np.float32)
        sl = np.asarray(DECODE_LENS, np.int32)
        if int8:
            kq, ks, vq, vs = _int8(kp, vp)
            jax_kw = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
            port_kw = dict(zip(("k_scale", "v_scale"), _t(ks, vs)))
            kpool, vpool = kq, vq
        else:
            jax_kw, port_kw, kpool, vpool = {}, {}, kp, vp
        kern = np.asarray(paged_attention_kernel(
            jnp.asarray(q), jnp.asarray(kpool), jnp.asarray(vpool), bt, sl,
            interpret=True, **jax_kw))
        ref = np.asarray(jax_paged_reference(
            jnp.asarray(q), jnp.asarray(kpool), jnp.asarray(vpool), bt, sl,
            **jax_kw))
        split = pa.paged_attention_split_reference(
            *_t(q, kpool, vpool, bt, sl), split_pages=2, **port_kw).numpy()
        assert np.isfinite(split).all()
        # idle slots: exact zeros, as from both kernels
        np.testing.assert_array_equal(split[sl == 0], 0.0)
        np.testing.assert_array_equal(kern[sl == 0], 0.0)
        live = sl > 0
        np.testing.assert_allclose(split[live], kern[live], **TOL)
        np.testing.assert_allclose(split[live], ref[live], **TOL)
        if int8:
            fp32 = pa.paged_attention_split_reference(
                *_t(q, kp, vp, bt, sl), split_pages=2).numpy()
            np.testing.assert_allclose(split[live], fp32[live],
                                       atol=INT8_VS_FP32_ATOL)

    @pytest.mark.parametrize("split_pages", [1, 3, 5])
    def test_any_split_matches_the_plain_version(self, split_pages):
        d, bs, mb, h, hkv = 16, 4, 6, 8, 2
        rng, kp, vp, bt = _pools(1, bs, hkv, d, DECODE_LENS, mb)
        q = rng.randn(len(DECODE_LENS), h, d).astype(np.float32)
        args = _t(q, kp, vp, bt, np.asarray(DECODE_LENS, np.int32))
        split = pa.paged_attention_split_reference(
            *args, split_pages=split_pages)
        plain = pa.paged_attention_reference(*args)
        live = args[4] > 0
        torch.testing.assert_close(split[live], plain[live], **TOL)

    def test_the_plans_own_split(self):
        # max_blocks 40 of 4 tokens: the plan's 16-page splits of 64 keys,
        # lengths around the boundaries, against the JAX reference
        d, bs, mb, h, hkv = 16, 4, 40, 8, 2
        lens = [63, 64, 65, 0, 129, 160]
        plan = pa.split_plan(len(lens), 1, h, hkv, mb, bs, decode=True)
        assert (plan.split_pages, plan.splits) == (16, 3)
        rng, kp, vp, bt = _pools(2, bs, hkv, d, lens, mb)
        q = rng.randn(len(lens), h, d).astype(np.float32)
        sl = np.asarray(lens, np.int32)
        ref = np.asarray(jax_paged_reference(
            jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), bt, sl))
        split = pa.paged_attention_split_reference(
            *_t(q, kp, vp, bt, sl)).numpy()
        live = sl > 0
        np.testing.assert_allclose(split[live], ref[live], **TOL)
        np.testing.assert_array_equal(split[~live], 0.0)


# -- (c) the split mixed step -----------------------------------------------

# C = 4, bs = 4, 2 pages (8 keys) a split. Slot 0: row 0 sees keys 0..7,
# all in split 0, while rows 1-3 reach into split 1, which is wholly past
# row 0's horizon. Slot 1 idle, slot 2 a decode row, slot 3 a chunk after
# a mid-page history with rows past q_len, slot 4 a chunk that crosses
# from split 1 into split 2.
HIST, QLEN = [7, 0, 13, 3, 14], [4, 0, 1, 2, 4]


class TestSplitMixed:
    @pytest.mark.parametrize("h,hkv", [(8, 2), (4, 4)], ids=["gqa", "mha"])
    @pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
    def test_matches_pallas_interpret(self, h, hkv, int8):
        c, d, bs, mb = 4, 16, 4, 6
        totals = [a + b for a, b in zip(HIST, QLEN)]
        rng, kp, vp, bt = _pools(3, bs, hkv, d, totals, mb)
        q = rng.randn(len(HIST), c, h, d).astype(np.float32)
        hist = np.asarray(HIST, np.int32)
        qlen = np.asarray(QLEN, np.int32)
        if int8:
            kq, ks, vq, vs = _int8(kp, vp)
            jax_kw = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
            port_kw = dict(zip(("k_scale", "v_scale"), _t(ks, vs)))
            kpool, vpool = kq, vq
        else:
            jax_kw, port_kw, kpool, vpool = {}, {}, kp, vp
        kern = np.asarray(mixed_paged_attention_kernel(
            jnp.asarray(q), jnp.asarray(kpool), jnp.asarray(vpool), bt,
            hist, qlen, interpret=True, **jax_kw))
        ref = np.asarray(jax_mixed_reference(
            jnp.asarray(q), jnp.asarray(kpool), jnp.asarray(vpool), bt,
            hist, qlen, **jax_kw))
        split = pa.mixed_paged_attention_split_reference(
            *_t(q, kpool, vpool, bt, hist, qlen), split_pages=2,
            **port_kw).numpy()
        assert np.isfinite(split).all()
        for i, n in enumerate(QLEN):
            np.testing.assert_allclose(split[i, :n], kern[i, :n], **TOL)
            np.testing.assert_allclose(split[i, :n], ref[i, :n], **TOL)
            np.testing.assert_array_equal(split[i, n:], 0.0)
        if int8:
            fp32 = pa.mixed_paged_attention_split_reference(
                *_t(q, kp, vp, bt, hist, qlen), split_pages=2).numpy()
            for i, n in enumerate(QLEN):
                np.testing.assert_allclose(split[i, :n], fp32[i, :n],
                                           atol=INT8_VS_FP32_ATOL)

    def test_a_split_past_the_rows_horizon_weighs_nothing(self):
        # slot 0, row 0 (horizon key 7) in split 1 (keys 8..15): l = 0 and
        # a merge weight of exactly 0, not exp(NEG_INF - NEG_INF) = 1
        c, h, d, bs, mb = 4, 4, 16, 4, 6
        totals = [a + b for a, b in zip(HIST, QLEN)]
        rng, kp, vp, bt = _pools(4, bs, h, d, totals, mb)
        q = rng.randn(len(HIST), c, h, d).astype(np.float32)
        k, v, m = pa._split_view(*_t(kp, vp, bt), None, None, len(HIST), h)
        logits = torch.einsum("schd,smhd->shcm", torch.from_numpy(q), k)
        ci = torch.arange(c)
        qpos = torch.tensor(HIST)[:, None] + ci[None, :]
        visible = ((torch.arange(m)[None, None, :] <= qpos[:, :, None])
                   & (ci[None, :, None] < torch.tensor(QLEN)[:, None, None]))
        visible = visible[:, None].expand_as(logits)
        _, parts, w, den = pa._split_merge(logits, visible, v, 2 * bs, 3,
                                           "shcm,smhd->shcd")
        l_row0 = parts[1][1][0, :, 0, 0]
        assert (l_row0 == 0).all() and (w[1][0, :, 0] == 0).all()
        assert (parts[1][1][0, :, 1:, 0] > 0).all()
        assert (den[0, :, 0] > 0).all()

    @pytest.mark.parametrize("split_pages", [1, 3, 5])
    def test_any_split_matches_the_plain_version(self, split_pages):
        c, h, hkv, d, bs, mb = 4, 8, 2, 16, 4, 6
        totals = [a + b for a, b in zip(HIST, QLEN)]
        rng, kp, vp, bt = _pools(5, bs, hkv, d, totals, mb)
        q = rng.randn(len(HIST), c, h, d).astype(np.float32)
        args = _t(q, kp, vp, bt, np.asarray(HIST, np.int32),
                  np.asarray(QLEN, np.int32))
        split = pa.mixed_paged_attention_split_reference(
            *args, split_pages=split_pages)
        plain = pa.mixed_paged_attention_reference(*args)
        for i, n in enumerate(QLEN):
            torch.testing.assert_close(split[i, :n], plain[i, :n], **TOL)


# -- (d) one split ---------------------------------------------------------------

class TestOneSplit:
    @pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
    def test_decode(self, int8):
        d, bs, mb, h, hkv = 16, 4, 6, 8, 2
        rng, kp, vp, bt = _pools(6, bs, hkv, d, DECODE_LENS, mb)
        q = rng.randn(len(DECODE_LENS), h, d).astype(np.float32)
        kw = {}
        if int8:
            kp, ks, vp, vs = _int8(kp, vp)
            kw = dict(zip(("k_scale", "v_scale"), _t(ks, vs)))
        args = _t(q, kp, vp, bt, np.asarray(DECODE_LENS, np.int32))
        one = pa.paged_attention_split_reference(*args, split_pages=mb, **kw)
        plain = pa.paged_attention_reference(*args, **kw)
        live = args[4] > 0
        torch.testing.assert_close(one[live], plain[live], **ONE_SPLIT_TOL)

    @pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
    def test_mixed(self, int8):
        c, h, hkv, d, bs, mb = 4, 8, 2, 16, 4, 6
        totals = [a + b for a, b in zip(HIST, QLEN)]
        rng, kp, vp, bt = _pools(7, bs, hkv, d, totals, mb)
        q = rng.randn(len(HIST), c, h, d).astype(np.float32)
        kw = {}
        if int8:
            kp, ks, vp, vs = _int8(kp, vp)
            kw = dict(zip(("k_scale", "v_scale"), _t(ks, vs)))
        args = _t(q, kp, vp, bt, np.asarray(HIST, np.int32),
                  np.asarray(QLEN, np.int32))
        one = pa.mixed_paged_attention_split_reference(*args,
                                                       split_pages=mb, **kw)
        plain = pa.mixed_paged_attention_reference(*args, **kw)
        for i, n in enumerate(QLEN):
            torch.testing.assert_close(one[i, :n], plain[i, :n],
                                       **ONE_SPLIT_TOL)

    def test_the_plans_split_of_a_short_tiles_grid(self):
        # 4 CTAs of the tiles kernel: the plan splits the 20 pages, and the
        # split version still equals the plain version
        c, h, d, bs = 64, 4, 16, 4
        mb = 20
        rng, kp, vp, bt = _pools(8, bs, h, d, [70], mb)
        plan = pa.split_plan(1, c, h, h, mb, bs)
        assert plan.kernel == "tiles" and plan.splits > 1
        q = rng.randn(1, c, h, d).astype(np.float32)
        args = _t(q, kp, vp, bt, np.asarray([6], np.int32),
                  np.asarray([64], np.int32))
        split = pa.mixed_paged_attention_split_reference(*args)
        plain = pa.mixed_paged_attention_reference(*args)
        torch.testing.assert_close(split, plain, **TOL)
