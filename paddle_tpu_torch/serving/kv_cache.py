"""Block-paged KV cache (counterpart of paddle_tpu/serving/kv_cache.py).

Each layer owns a fixed pool of ``[num_blocks, block_size, kv_heads,
head_dim]`` pages, the reference's layout. A request holds an ordered
list of page ids (its block-table row) covering positions
``0..seq_len-1`` via ``page = table[pos // block_size]``,
``offset = pos % block_size``. Pages are allocated on demand and return
to the free list when the request finishes or is preempted, so KV memory
scales with the tokens in flight.

Page 0 is the TRASH page: block-table rows are 0-padded, so writes for
pad positions (right-padded prefill, idle decode slots) land in trash
instead of a live page, and every write stays one unconditional scatter.

The pools are updated IN PLACE (``index_put_``): where the reference's
jitted steps donate the pool buffers and return new ones, the port
writes into the same tensors, so the views return only the attention
context and the pool never exists twice.

The prefill/decode views are the per-layer external-cache hook the model
calls (``update_and_attend``). Not in this slice: copy-on-write and
prefix sharing (page refcounts above 1), the mixed ragged view of
chunked prefill, and int8 pages with scale planes.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..nn import functional as F
from .kernels.paged_attention import paged_attention

TRASH_BLOCK = 0


class KVBlockPool(NamedTuple):
    """One layer's page pools: k/v ``[num_blocks, block_size, Hkv, D]``."""

    k: torch.Tensor
    v: torch.Tensor


class BlockAllocator:
    """Host-side free list over page ids 1..num_blocks-1 (0 is trash),
    with a refcount per allocated page.

    ``alloc`` returns None, the explicit out-of-blocks signal, instead of
    raising: the engine turns it into preempt-and-requeue. Pages leave
    ``alloc`` at refcount 1 and return to the free list when the last
    reference drops (this slice never shares a page, so that is at the
    first ``free``)."""

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
    tables and lengths."""

    def __init__(self, num_layers, num_blocks, block_size, num_kv_heads,
                 head_dim, max_slots, max_blocks_per_slot, device,
                 dtype=torch.float32):
        self.block_size = block_size
        self.max_blocks_per_slot = max_blocks_per_slot
        page = (num_blocks, block_size, num_kv_heads, head_dim)
        self.pools = [
            KVBlockPool(torch.zeros(page, dtype=dtype, device=device),
                        torch.zeros(page, dtype=dtype, device=device))
            for _ in range(num_layers)]
        self.allocator = BlockAllocator(num_blocks)
        self.block_tables = np.zeros((max_slots, max_blocks_per_slot),
                                     np.int32)
        self.seq_lens = np.zeros((max_slots,), np.int32)
        self._slot_pages = [[] for _ in range(max_slots)]

    def pages_needed(self, num_tokens):
        return -(-num_tokens // self.block_size)  # ceil

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

    def release_slot(self, slot):
        """Release the slot's pages (finish or preempt)."""
        if self._slot_pages[slot]:
            self.allocator.free(self._slot_pages[slot])
        self._slot_pages[slot] = []
        self.block_tables[slot, :] = TRASH_BLOCK
        self.seq_lens[slot] = 0


def _write_pages(pool, pages, offs, k, v):
    """Scatter fresh K/V into the pool planes at ``(pages, offs)``."""
    pool.k[pages, offs] = k.to(pool.k.dtype)
    pool.v[pages, offs] = v.to(pool.v.dtype)


class PagedPrefillView:
    """One layer's hook for single-request prefill (``[1, P]`` right-padded
    prompt): writes every position's K/V through the trash-padded
    block-table row in one scatter, then runs dense causal attention over
    the fresh K/V. Rows past the true length see only earlier tokens and
    real rows never see them, so real rows are exactly the unpadded
    computation."""

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
        out = paged_attention(q[:, 0], self.pool.k, self.pool.v,
                              self.block_tables, self.seq_lens + 1)
        return out[:, None]
