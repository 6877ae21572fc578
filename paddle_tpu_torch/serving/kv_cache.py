"""Block-paged KV cache (counterpart of paddle_tpu/serving/kv_cache.py).

Each layer owns a fixed pool of ``[num_blocks, block_size, kv_heads,
head_dim]`` pages, the reference's layout. A request holds an ordered
list of page ids (its block-table row) covering positions
``0..seq_len-1`` via ``page = table[pos // block_size]``,
``offset = pos % block_size``. Pages are allocated on demand and return
to the free list when the last reference drops, so KV memory scales with
the tokens in flight.

Page 0 is the TRASH page: block-table rows are 0-padded, so writes for
pad positions (right-padded prefill, idle decode slots, mixed-step rows
past their ``q_len``) land in trash instead of a live page, and every
write stays one unconditional scatter.

Ownership is refcounted (serving tier 2): the radix prefix cache
(``prefix_cache.py``) holds one reference per cached page and every slot
adopting a cached prefix holds its own; ``release_slot`` decrefs, and a
write into a still-shared page goes through the ``make_writable``
copy-on-write guard first. With ``FLAGS_serving_prefix_cache`` off
nothing ever increfs.

Under ``FLAGS_serving_quant_kv`` the pools are int8 with fp32 scale
planes ``[num_blocks, block_size, kv_heads]`` beside them (one scale per
head_dim vector): ``_write_pages`` quantizes at write time, the scales
land at the same indices (trash included), and the attention kernels
dequantize while staging a page.

The pools are updated IN PLACE (``index_put_``, ``index_copy_``): where
the reference's jitted steps donate the pool buffers and return new ones,
the port writes into the same tensors, so the views return only the
attention context and the pool never exists twice.

The prefill/decode/mixed views are the per-layer external-cache hook the
model calls (``update_and_attend``). ``PagedMixedView`` is the ragged
superset: ``[S, C]`` rows of ``q_len`` new tokens at positions
``hist..hist+q_len-1``, serving chunked prefill, the prefix-cache suffix
prefill (``S == 1``) and decode rows (``q_len == 1``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..kernels.quant import quantize_int8_page
from ..nn import functional as F
from .kernels.paged_attention import mixed_paged_attention, paged_attention

TRASH_BLOCK = 0


class KVBlockPool(NamedTuple):
    """One layer's page pools: k/v ``[num_blocks, block_size, Hkv, D]``,
    and for int8 pools their fp32 scale planes ``[num_blocks, block_size,
    Hkv]`` (None otherwise)."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None


class BlockAllocator:
    """Host-side free list over page ids 1..num_blocks-1 (0 is trash),
    with a refcount per allocated page.

    ``alloc`` returns None, the explicit out-of-blocks signal, instead of
    raising: the engine turns it into reclaim or preempt-and-requeue.
    Pages leave ``alloc`` at refcount 1; the prefix cache and adopting
    slots ``incref`` shared pages, and a page returns to the free list
    when its last reference drops."""

    def __init__(self, num_blocks):
        if num_blocks < 2:
            raise ValueError("need >= 2 blocks (page 0 is the trash page)")
        self.num_blocks = num_blocks
        # LIFO keeps recently freed pages in circulation
        self._free = list(range(num_blocks - 1, 0, -1))
        self._free_set = set(self._free)
        self._refs = {}                 # page id -> refcount (> 0)

    @property
    def free_blocks(self):
        return len(self._free)

    @property
    def usable_blocks(self):
        return self.num_blocks - 1

    def alloc(self, n=1):
        """n page ids at refcount 1, or None when fewer than n are free."""
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._free_set.discard(p)
            self._refs[p] = 1
        return pages

    def refcount(self, i):
        return self._refs.get(i, 0)

    def incref(self, i):
        if i not in self._refs:
            raise ValueError("incref of unallocated page %r" % (i,))
        self._refs[i] += 1

    def decref(self, i):
        """Drop one reference; returns True when the page was freed."""
        if (not 0 < i < self.num_blocks or i in self._free_set
                or i not in self._refs):
            raise ValueError("bad free of page %r" % (i,))
        self._refs[i] -= 1
        if self._refs[i] == 0:
            del self._refs[i]
            self._free.append(i)
            self._free_set.add(i)
            return True
        return False

    def free(self, ids):
        for i in ids:
            self.decref(i)


class PagedKVCache:
    """Pools for every layer (on ``device``) plus the host-side block
    tables and lengths. ``quantized`` makes the pools int8 with fp32 scale
    planes; zero int8 pages times zero scales read as exact zeros, as the
    fp32 zero-initialised pools do."""

    def __init__(self, num_layers, num_blocks, block_size, num_kv_heads,
                 head_dim, max_slots, max_blocks_per_slot, device,
                 dtype=torch.float32, quantized=False):
        self.block_size = block_size
        self.max_slots = max_slots
        self.max_blocks_per_slot = max_blocks_per_slot
        self.quantized = bool(quantized)
        page = (num_blocks, block_size, num_kv_heads, head_dim)
        dt = torch.int8 if quantized else dtype

        def planes():
            if not quantized:
                return ()
            return tuple(torch.zeros(page[:3], dtype=torch.float32,
                                     device=device) for _ in range(2))

        self.pools = [
            KVBlockPool(torch.zeros(page, dtype=dt, device=device),
                        torch.zeros(page, dtype=dt, device=device),
                        *planes())
            for _ in range(num_layers)]
        self.allocator = BlockAllocator(num_blocks)
        self.block_tables = np.zeros((max_slots, max_blocks_per_slot),
                                     np.int32)
        self.seq_lens = np.zeros((max_slots,), np.int32)
        self._slot_pages = [[] for _ in range(max_slots)]
        self.cow_clones = 0             # copy-on-write page splits

    def pages_needed(self, num_tokens):
        return -(-num_tokens // self.block_size)  # ceil

    def slot_page_count(self, slot):
        return len(self._slot_pages[slot])

    def slot_pages(self, slot):
        """The slot's page ids in position order (read-only)."""
        return self._slot_pages[slot]

    def ensure_capacity(self, slot, num_tokens):
        """Allocate pages so positions 0..num_tokens-1 are covered.
        Returns True, or False on pool exhaustion (nothing allocated)."""
        need = self.pages_needed(num_tokens) - len(self._slot_pages[slot])
        if need <= 0:
            return True
        if num_tokens > self.max_blocks_per_slot * self.block_size:
            raise ValueError(
                "%d tokens exceed the per-slot capacity %d"
                % (num_tokens, self.max_blocks_per_slot * self.block_size))
        pages = self.allocator.alloc(need)
        if pages is None:
            return False
        start = len(self._slot_pages[slot])
        self._slot_pages[slot].extend(pages)
        self.block_tables[slot, start:start + need] = pages
        return True

    def adopt_prefix(self, slot, pages, matched_tokens):
        """Map an empty slot's block-table head onto shared prefix pages
        from the radix cache: each page gains a reference for this slot
        and ``seq_lens`` starts at the matched token count."""
        assert not self._slot_pages[slot], "adopt into a non-empty slot"
        for p in pages:
            self.allocator.incref(p)
        self._slot_pages[slot] = list(pages)
        self.block_tables[slot, :len(pages)] = pages
        self.seq_lens[slot] = matched_tokens

    def make_writable(self, slot, start, end):
        """Copy-on-write guard: every page covering positions ``[start,
        end)`` that the slot is about to write must be exclusively owned.
        A shared page (refcount > 1) is cloned: the block table is
        repointed at a fresh page and the old reference dropped, then one
        batched copy per pool plane (scale planes included) moves every
        clone's K/V in place. Returns False when the pool cannot supply a
        clone page; clones made so far stay valid, so a retry after
        reclaim or preemption continues where this one stopped."""
        if end <= start:
            return True
        ok = True
        src, dst = [], []
        for idx in range(start // self.block_size,
                         -(-end // self.block_size)):
            page = self._slot_pages[slot][idx]
            if self.allocator.refcount(page) <= 1:
                continue
            new = self.allocator.alloc(1)
            if new is None:
                ok = False
                break
            new = new[0]
            src.append(page)
            dst.append(new)
            self.allocator.decref(page)
            self._slot_pages[slot][idx] = new
            self.block_tables[slot, idx] = new
            self.cow_clones += 1
        if src:
            dev = self.pools[0].k.device
            s = torch.tensor(src, dtype=torch.long, device=dev)
            d = torch.tensor(dst, dtype=torch.long, device=dev)
            for pool in self.pools:
                for plane in pool:
                    if plane is not None:
                        plane.index_copy_(0, d, plane.index_select(0, s))
        return ok

    def release_slot(self, slot):
        """Release the slot's page references (finish or preempt); a page
        the prefix cache still references survives."""
        if self._slot_pages[slot]:
            self.allocator.free(self._slot_pages[slot])
        self._slot_pages[slot] = []
        self.block_tables[slot, :] = TRASH_BLOCK
        self.seq_lens[slot] = 0


def _write_pages(pool, pages, offs, k, v):
    """Scatter fresh K/V into the pool planes at ``(pages, offs)``. Int8
    pools quantize each (position, head) head_dim vector here and write
    its scale at the same indices, so pad writes and their scales both
    land in the trash page."""
    if pool.k_scale is None:
        pool.k[pages, offs] = k.to(pool.k.dtype)
        pool.v[pages, offs] = v.to(pool.v.dtype)
        return
    kq, ks = quantize_int8_page(k)
    vq, vs = quantize_int8_page(v)
    pool.k[pages, offs] = kq
    pool.v[pages, offs] = vq
    pool.k_scale[pages, offs] = ks
    pool.v_scale[pages, offs] = vs


class PagedPrefillView:
    """One layer's hook for single-request prefill (``[1, P]`` right-padded
    prompt): writes every position's K/V through the trash-padded
    block-table row in one scatter, then runs dense causal attention over
    the fresh K/V (never the pool: under int8 pages, quantization error
    enters only on pool reads). Rows past the true length see only
    earlier tokens and real rows never see them, so real rows are exactly
    the unpadded computation."""

    def __init__(self, pool, table_row, block_size):
        self.pool = pool
        self.table_row = table_row            # [MB] int32 on the pool's device
        self.block_size = block_size

    def update_and_attend(self, q, k, v):
        pos = torch.arange(k.shape[1], device=k.device)
        pages = self.table_row.long()[pos // self.block_size]
        _write_pages(self.pool, pages, pos % self.block_size, k[0], v[0])
        return F.scaled_dot_product_attention(q, k, v, is_causal=True)


class PagedDecodeView:
    """One layer's hook for the batched decode step (``[S, 1]`` tokens, one
    per slot): writes each slot's new K/V into page
    ``table[slot, len // bs]`` at offset ``len % bs`` (idle slots write
    trash), then attends over the paged history including the new token
    (effective length ``len + 1``) with the paged-attention kernel."""

    def __init__(self, pool, block_tables, seq_lens, block_size):
        self.pool = pool
        self.block_tables = block_tables      # [S, MB] int32
        self.seq_lens = seq_lens              # [S] int32
        self.block_size = block_size

    def update_and_attend(self, q, k, v):
        lens = self.seq_lens.long()
        slots = torch.arange(q.shape[0], device=q.device)
        pages = self.block_tables.long()[slots, lens // self.block_size]
        _write_pages(self.pool, pages, lens % self.block_size,
                     k[:, 0], v[:, 0])
        # GPT's q is a strided view of its fused projection; the kernel
        # reads a contiguous one
        out = paged_attention(q[:, 0].contiguous(), self.pool.k,
                              self.pool.v, self.block_tables,
                              self.seq_lens + 1,
                              k_scale=self.pool.k_scale,
                              v_scale=self.pool.v_scale)
        return out[:, None]


class PagedMixedView:
    """One layer's hook for the mixed ragged step (``[S, C]`` tokens): row
    ``s`` holds ``q_lens[s]`` new tokens at positions ``hist_lens[s] ..
    hist_lens[s] + q_lens[s] - 1`` (0 = idle row). Every valid position's
    K/V scatters through the slot's block-table row; pad positions
    (``ci >= q_len``) go to the trash page, offset 0. Attention then runs
    over the pool (history plus the chunk's own fresh K/V) with the causal
    rule ``key position <= hist + ci``."""

    def __init__(self, pool, block_tables, hist_lens, q_lens, block_size):
        self.pool = pool
        self.block_tables = block_tables      # [S, MB] int32
        self.hist_lens = hist_lens            # [S] int32 (pool history)
        self.q_lens = q_lens                  # [S] int32 (new tokens)
        self.block_size = block_size

    def update_and_attend(self, q, k, v):
        c = q.shape[1]
        mb = self.block_tables.shape[1]
        ci = torch.arange(c, device=q.device)
        pos = self.hist_lens.long()[:, None] + ci[None, :]        # [S, C]
        valid = ci[None, :] < self.q_lens.long()[:, None]
        # pad positions may lie past the table; their write goes to trash
        page_idx = torch.clamp(pos // self.block_size, 0, mb - 1)
        pages = torch.where(valid, torch.gather(self.block_tables.long(), 1,
                                                page_idx), TRASH_BLOCK)
        offs = torch.where(valid, pos % self.block_size, 0)
        _write_pages(self.pool, pages, offs, k, v)
        return mixed_paged_attention(q.contiguous(), self.pool.k,
                                     self.pool.v, self.block_tables,
                                     self.hist_lens, self.q_lens,
                                     k_scale=self.pool.k_scale,
                                     v_scale=self.pool.v_scale)
