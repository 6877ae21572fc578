"""Serving tier 2 of the port, piece by piece, against the JAX package.

- the plain mixed paged attention and the int8 modes of both paged
  attention functions against the reference's Pallas kernels in
  interpret mode (the same ragged rows as tests/test_serving_prefix.py
  and tests/test_serving_quant.py);
- the int8 page codec against ``paddle_tpu.kernels.quant``;
- the refcounted allocator and the radix prefix cache: the same
  operation sequences give the same matches, refcounts and stats.

Inputs are made with numpy and handed to both packages. The port's
wrappers run their plain versions here because the tensors lie on the
CPU.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels import quant as jquant
from paddle_tpu.serving.kernels.paged_attention import (
    mixed_paged_attention_kernel,
    mixed_paged_attention_reference as jax_mixed_reference,
    paged_attention_kernel,
)
from paddle_tpu.serving.kv_cache import (
    BlockAllocator as JaxBlockAllocator,
    PagedKVCache as JaxPagedKVCache,
)
from paddle_tpu.serving.prefix_cache import (
    RadixPrefixCache as JaxRadixPrefixCache,
)
from paddle_tpu_torch.kernels import quant
from paddle_tpu_torch.serving.kernels import paged_attention as pa
from paddle_tpu_torch.serving.kv_cache import BlockAllocator, PagedKVCache
from paddle_tpu_torch.serving.prefix_cache import RadixPrefixCache

# plain PyTorch vs the Pallas kernels in interpret mode: both fp32, with
# sums over at most 32 keys in another order (one softmax over the row vs
# an online softmax over pages); int8 pages dequantize to the same fp32
# values on both sides, so the same tolerance holds
TOL = dict(atol=1e-5, rtol=1e-5)
# int8 pages against the unquantized pools (standard normal K/V): the
# rounding error per element is <= max|vector| / 254
INT8_VS_FP32_ATOL = 0.05


def _pools(seed, nb, bs, hkv, d, totals):
    """Histories of ``totals[s]`` tokens on allocated pages; the trash
    page and unused pages hold zeros, as the engine's pools do."""
    rng = np.random.RandomState(seed)
    kp = np.zeros((nb, bs, hkv, d), np.float32)
    vp = np.zeros((nb, bs, hkv, d), np.float32)
    mb = max(-(-max(totals) // bs), 1)
    bt = np.zeros((len(totals), mb), np.int32)
    alloc = JaxBlockAllocator(nb)
    for i, total in enumerate(totals):
        pages = alloc.alloc(-(-total // bs)) if total else []
        bt[i, :len(pages)] = pages
        for pos in range(total):
            kp[pages[pos // bs], pos % bs] = rng.randn(hkv, d)
            vp[pages[pos // bs], pos % bs] = rng.randn(hkv, d)
    return rng, kp, vp, bt


def _int8(kp, vp):
    kq, ks = jquant.quantize_int8_page(jnp.asarray(kp))
    vq, vs = jquant.quantize_int8_page(jnp.asarray(vp))
    return [np.asarray(x) for x in (kq, ks, vq, vs)]


def _t(*xs):
    return [torch.from_numpy(np.array(x)) for x in xs]


# the ragged rows of the reference's parity tests: a chunk row, an idle
# row, a decode row and a chunk row after a mid-page history
HIST, QLEN = [6, 0, 13, 3], [4, 0, 1, 2]


class TestMixedPagedAttention:
    @pytest.mark.parametrize("h,hkv", [(8, 2), (4, 4)])
    @pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
    def test_matches_pallas_interpret(self, h, hkv, int8):
        s, c, d, bs, nb = 4, 4, 16, 4, 32
        rng, kp, vp, bt = _pools(0, nb, bs, hkv, d,
                                 [a + b for a, b in zip(HIST, QLEN)])
        q = rng.randn(s, c, h, d).astype(np.float32)
        hist = np.asarray(HIST, np.int32)
        qlen = np.asarray(QLEN, np.int32)
        if int8:
            kq, ks, vq, vs = _int8(kp, vp)
            jax_kw = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
            kpool, vpool = kq, vq
            port_kw = dict(zip(("k_scale", "v_scale"), _t(ks, vs)))
        else:
            jax_kw, port_kw, kpool, vpool = {}, {}, kp, vp
        kern = np.asarray(mixed_paged_attention_kernel(
            jnp.asarray(q), jnp.asarray(kpool), jnp.asarray(vpool), bt,
            hist, qlen, interpret=True, **jax_kw))
        ref = np.asarray(jax_mixed_reference(
            jnp.asarray(q), jnp.asarray(kpool), jnp.asarray(vpool), bt,
            hist, qlen, **jax_kw))
        args = _t(q, kpool, vpool, bt, hist, qlen)
        plain = pa.mixed_paged_attention_reference(*args, **port_kw).numpy()
        wrapped = pa.mixed_paged_attention(*args, **port_kw).numpy()
        np.testing.assert_array_equal(wrapped, plain)
        assert np.isfinite(plain).all()
        for i in range(s):
            for j in range(QLEN[i]):
                np.testing.assert_allclose(plain[i, j], kern[i, j], **TOL)
                np.testing.assert_allclose(plain[i, j], ref[i, j], **TOL)
        if int8:
            fp32 = pa.mixed_paged_attention_reference(
                *_t(q, kp, vp, bt, hist, qlen)).numpy()
            for i in range(s):
                np.testing.assert_allclose(plain[i, :QLEN[i]],
                                           fp32[i, :QLEN[i]],
                                           atol=INT8_VS_FP32_ATOL)

    def test_bf16_queries_over_int8_pages(self):
        s, c, h, hkv, d, bs, nb = 4, 4, 8, 2, 16, 4, 32
        rng, kp, vp, bt = _pools(1, nb, bs, hkv, d,
                                 [a + b for a, b in zip(HIST, QLEN)])
        q = rng.randn(s, c, h, d).astype(np.float32)
        kq, ks, vq, vs = _int8(kp, vp)
        args = _t(q, kq, vq, bt, np.asarray(HIST, np.int32),
                  np.asarray(QLEN, np.int32))
        ks, vs = _t(ks, vs)
        f32 = pa.mixed_paged_attention(*args, k_scale=ks, v_scale=vs)
        args[0] = args[0].bfloat16()
        b16 = pa.mixed_paged_attention(*args, k_scale=ks, v_scale=vs)
        assert b16.dtype == torch.bfloat16
        for i in range(s):
            torch.testing.assert_close(b16[i, :QLEN[i]].float(),
                                       f32[i, :QLEN[i]], atol=2e-2,
                                       rtol=1e-2)

    def test_rejects_bad_inputs(self):
        s, c, h, hkv, d, bs, nb = 4, 4, 8, 2, 16, 4, 32
        rng, kp, vp, bt = _pools(2, nb, bs, hkv, d, [5, 0, 7, 3])
        q = rng.randn(s, c, h, d).astype(np.float32)
        args = _t(q, kp, vp, bt, np.zeros(s, np.int32), np.ones(s, np.int32))
        with pytest.raises(ValueError, match=r"\[S, C, H, D\]"):
            pa.mixed_paged_attention(args[0][0], *args[1:])
        with pytest.raises(ValueError, match="hist_lens"):
            pa.mixed_paged_attention(*args[:4], args[4][:2], args[5])
        with pytest.raises(ValueError, match="both k_scale and v_scale"):
            pa.mixed_paged_attention(*args, k_scale=torch.ones(nb, bs, hkv))
        with pytest.raises(ValueError, match="scales must be"):
            pa.mixed_paged_attention(*args, k_scale=torch.ones(nb, bs, 1),
                                     v_scale=torch.ones(nb, bs, 1))
        with pytest.raises(ValueError, match="CUDA device"):
            pa.mixed_paged_attention(*(x.to("meta") for x in args))


class TestPagedAttentionInt8:
    @pytest.mark.parametrize("h,hkv", [(4, 2), (4, 4)])
    def test_matches_pallas_interpret(self, h, hkv):
        s, d, bs, nb = 3, 16, 4, 16
        lens = [7, 0, 12]
        rng, kp, vp, bt = _pools(1, nb, bs, hkv, d, lens)
        kq, ks, vq, vs = _int8(kp, vp)
        q = rng.randn(s, h, d).astype(np.float32)
        sl = np.asarray(lens, np.int32)
        kern = np.asarray(paged_attention_kernel(
            jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq), bt, sl,
            k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs),
            interpret=True))
        ksc, vsc = _t(ks, vs)
        out = pa.paged_attention(*_t(q, kq, vq, bt, sl), k_scale=ksc,
                                 v_scale=vsc).numpy()
        fp32 = pa.paged_attention(*_t(q, kp, vp, bt, sl)).numpy()
        for i in (0, 2):
            np.testing.assert_allclose(out[i], kern[i], **TOL)
            np.testing.assert_allclose(out[i], fp32[i],
                                       atol=INT8_VS_FP32_ATOL)

    def test_int8_pools_need_both_scales(self):
        s, h, hkv, d, bs, nb = 2, 4, 2, 16, 4, 8
        rng, kp, vp, bt = _pools(3, nb, bs, hkv, d, [5, 3])
        kq, ks, vq, vs = _int8(kp, vp)
        q = rng.randn(s, h, d).astype(np.float32)
        args = _t(q, kq, vq, bt, np.asarray([5, 3], np.int32))
        with pytest.raises(ValueError, match="both k_scale and v_scale"):
            pa.paged_attention(*args, v_scale=_t(vs)[0])


class TestPageCodec:
    def test_matches_reference_codec(self):
        rng = np.random.RandomState(0)
        x = (rng.randn(8, 4, 2, 16) * rng.rand(8, 4, 2, 1) * 10
             ).astype(np.float32)
        x[0, 0, 0] = 0.0                          # zero-vector floor
        x[1, 2, 1, 3] = np.nan                    # poisons its vector
        x[2, 3, 0, 5] = -np.inf
        jq, js = (np.asarray(a) for a in jquant.quantize_int8_page(
            jnp.asarray(x)))
        q, s = quant.quantize_int8_page(torch.from_numpy(x))
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        assert tuple(s.shape) == x.shape[:-1]
        s = s.numpy()
        finite = np.isfinite(js)
        np.testing.assert_array_equal(np.isfinite(s), finite)
        # scales within one float32 ulp, int8 values equal
        np.testing.assert_array_less(np.abs(s[finite] - js[finite]),
                                     np.spacing(js[finite]) * 1.01)
        np.testing.assert_array_equal(q.numpy()[finite], jq[finite])
        assert s[0, 0, 0] == 1.0 and (q.numpy()[0, 0, 0] == 0).all()
        assert np.isnan(s[1, 2, 1]) and np.isnan(s[2, 3, 0])
        deq = quant.dequantize_int8_block(q, torch.from_numpy(s)).numpy()
        jdeq = np.asarray(jquant.dequantize_int8_block(jnp.asarray(jq),
                                                       jnp.asarray(js)))
        np.testing.assert_array_equal(deq[finite], jdeq[finite])
        assert (deq[0, 0, 0] == 0).all()
        assert np.isnan(deq[1, 2, 1]).all()

    def test_round_half_to_even(self):
        # 127 * (k + 0.5) / 127.5 lands on .5 boundaries after the divide
        x = torch.tensor([[0.5, 1.5, 2.5, -0.5, -2.5, 127.0]])
        q, s = quant.quantize_int8_page(x)
        assert s.item() == 1.0
        assert q.tolist() == [[0, 2, 2, 0, -2, 127]]

    def test_dequantize_only_the_axis_aware_form(self):
        q, s = quant.quantize_int8_page(torch.randn(4, 8))
        out = quant.dequantize_int8_block(q, s, torch.bfloat16)
        assert out.dtype == torch.bfloat16 and out.shape == q.shape
        with pytest.raises(ValueError, match="without its last axis"):
            quant.dequantize_int8_block(q, s[:2])


# ---------------------------------------------------------------------------
# allocator and radix cache: the same operations on both implementations
# (the cases of tests/test_serving_prefix.py)
# ---------------------------------------------------------------------------

def _caches(num_blocks=32, block_size=4):
    jax_cache = JaxPagedKVCache(num_layers=1, num_blocks=num_blocks,
                                block_size=block_size, num_kv_heads=1,
                                head_dim=8, max_slots=2,
                                max_blocks_per_slot=8)
    port_cache = PagedKVCache(num_layers=1, num_blocks=num_blocks,
                              block_size=block_size, num_kv_heads=1,
                              head_dim=8, max_slots=2, max_blocks_per_slot=8,
                              device="cpu")
    return ((jax_cache, JaxRadixPrefixCache(jax_cache)),
            (port_cache, RadixPrefixCache(port_cache)))


def _state(cache, pc):
    a = cache.allocator
    return dict(refs=dict(a._refs), free=list(a._free), stats=pc.stats(),
                cached=pc.cached_pages)


def _radix_insert_match(cache, pc):
    tokens = list(range(12))
    pages = cache.allocator.alloc(3)
    out = [pc.insert(tokens, pages, 12), pc.match(tokens + [99], limit=12),
           pc.match(tokens[:4] + [50, 51, 52, 53], limit=8)]
    # the engine's limit=len-1 leaves one suffix token: a partial match
    more = cache.allocator.alloc(2)
    pc.insert(list(range(40, 48)), more, 8)
    out.append(pc.match(list(range(40, 48)), limit=7))
    return out


def _radix_partial_longest_head(cache, pc):
    a = cache.allocator.alloc(1)
    b = cache.allocator.alloc(1)
    pc.insert([1, 2, 3, 4], a, 4)
    pc.insert([1, 2, 9, 9], b, 4)
    return [pc.match([1, 2, 3, 7, 7], limit=4),
            pc.match([1, 2, 8, 8, 8], limit=4)]     # tie: first inserted


def _radix_insert_dedup(cache, pc):
    first = cache.allocator.alloc(1)
    dup = cache.allocator.alloc(1)
    out = [pc.insert([5, 6, 7, 8], first, 4), pc.insert([5, 6, 7, 8], dup, 4),
           pc.match([5, 6, 7, 8, 9], limit=4),
           cache.allocator.refcount(dup[0])]
    cache.allocator.free(dup)
    return out


def _radix_reclaim_lru(cache, pc):
    cold = cache.allocator.alloc(2)
    hot = cache.allocator.alloc(1)
    pc.insert(list(range(8)), cold, 8)
    pc.insert([9, 9, 9, 9], hot, 4)
    cache.allocator.free(cold)
    cache.allocator.free(hot)
    pc.match(list(range(8)), limit=8)
    pc.match([9, 9, 9, 9, 0], limit=4)
    out = [pc.reclaim(1), pc.match(list(range(8)), limit=8)]
    cache.allocator.incref(hot[0])             # an adopting slot
    out += [pc.reclaim(10), pc.cached_pages]
    cache.allocator.decref(hot[0])
    pc.note_lookup(12, 8)
    return out


def _radix_clear(cache, pc):
    pages = cache.allocator.alloc(3)
    pc.insert(list(range(12)), pages, 12)
    cache.allocator.free(pages)
    return [pc.clear(), pc.cached_pages, cache.allocator.free_blocks]


def _cow_adopt_and_clone(cache, pc):
    """A slot adopts a partially matched prefix and makes it writable:
    the clone gets a fresh page and the shared one keeps the tree's
    reference."""
    cache.ensure_capacity(0, 12)
    pc.insert(list(range(12)), cache.slot_pages(0), 12)
    cache.release_slot(0)
    pages, matched = pc.match(list(range(10)) + [77, 78], limit=11)
    cache.adopt_prefix(1, pages, matched)
    out = [(pages, matched), list(cache.slot_pages(1)),
           cache.make_writable(1, matched, 12), list(cache.slot_pages(1)),
           cache.block_tables[1].tolist(), cache.cow_clones]
    cache.release_slot(1)
    return out


class TestAllocatorAndRadixCache:
    @pytest.mark.parametrize("case", [
        _radix_insert_match, _radix_partial_longest_head,
        _radix_insert_dedup, _radix_reclaim_lru, _radix_clear,
        _cow_adopt_and_clone], ids=lambda f: f.__name__.strip("_"))
    def test_same_ops_same_results(self, case):
        (jc, jpc), (tc, tpc) = _caches()
        assert case(tc, tpc) == case(jc, jpc)
        assert _state(tc, tpc) == _state(jc, jpc)

    def test_allocator_lifo_refcount_and_double_free(self):
        for alloc in (BlockAllocator(8), JaxBlockAllocator(8)):
            assert alloc.alloc(3) == [1, 2, 3]
            alloc.incref(2)
            assert alloc.decref(2) is False and alloc.refcount(2) == 1
            alloc.free([1, 2, 3])
            assert alloc.alloc(3) == [3, 2, 1]
            with pytest.raises(ValueError):
                alloc.free([5])
            with pytest.raises(ValueError):
                alloc.incref(6)

    def test_quantized_cache_geometry_and_clone_copies_scales(self):
        cache = PagedKVCache(num_layers=2, num_blocks=8, block_size=4,
                             num_kv_heads=2, head_dim=8, max_slots=2,
                             max_blocks_per_slot=4, device="cpu",
                             quantized=True)
        for p in cache.pools:
            assert p.k.dtype == torch.int8 and p.v.dtype == torch.int8
            assert tuple(p.k_scale.shape) == (8, 4, 2)
            assert p.k_scale.dtype == torch.float32
            assert not p.k.any() and not p.k_scale.any()
        cache.ensure_capacity(0, 6)
        src = cache.slot_pages(0)[1]
        for p in cache.pools:
            p.k[src] = 7
            p.k_scale[src] = 0.5
            p.v_scale[src] = 0.25
        cache.allocator.incref(src)              # shared with a tree node
        assert cache.make_writable(0, 5, 6)
        dst = cache.slot_pages(0)[1]
        assert dst != src and cache.cow_clones == 1
        for p in cache.pools:
            assert (p.k[dst] == 7).all() and (p.k_scale[dst] == 0.5).all()
            assert (p.v_scale[dst] == 0.25).all()
        fp32 = PagedKVCache(num_layers=1, num_blocks=8, block_size=4,
                            num_kv_heads=2, head_dim=8, max_slots=2,
                            max_blocks_per_slot=4, device="cpu")
        assert fp32.pools[0].k.dtype == torch.float32
        assert fp32.pools[0].k_scale is None and fp32.pools[0].v_scale is None
