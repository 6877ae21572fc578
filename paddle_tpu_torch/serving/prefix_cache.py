"""Radix prefix cache over the paged KV pool (the port's own copy of
paddle_tpu/serving/prefix_cache.py, ``FLAGS_serving_prefix_cache``).

The tree is keyed on BLOCK-SIZE TOKEN CHUNKS: one node per full KV page,
holding the page id whose pool slots contain the K/V of that chunk's
tokens at that prefix position. K/V at position i depends only on tokens
0..i (causal attention), so any request whose prompt starts with a node
path's tokens can map its block-table head onto the cached pages and
prefill only the suffix.

Ownership (``kv_cache.BlockAllocator`` refcounts):

- The TREE holds one reference per cached page (taken at ``insert``).
- Every request adopting a prefix holds its own reference per page
  (``PagedKVCache.adopt_prefix``); ``release_slot`` decrefs, so a
  finished or preempted request leaves its prefix warm in the tree.
- Only FULL pages are cached; writes happen at positions >= seq_len,
  past every full page, so shared full pages never need copying. The one
  mutable sharing case is a partial match: ``match`` may hand out the
  head of a cached page (``matched % block_size != 0``); the adopting
  request's first write lands inside that shared page and goes through
  the copy-on-write guard (``PagedKVCache.make_writable``) first.
- ``reclaim`` drops leaf pages referenced ONLY by the tree (refcount 1)
  in least-recently-used order; the engine calls it when the pool runs
  dry BEFORE preempting a running request.

Matching is capped at ``len(tokens) - 1``: the next token's logits come
from the last prompt position's forward pass, so a fully cached prompt
still prefills one token.
"""
from __future__ import annotations

import heapq
import itertools


class _Node:
    __slots__ = ("key", "page", "parent", "children", "last_used")

    def __init__(self, key, page, parent):
        self.key = key              # tuple of block_size token ids
        self.page = page            # pool page id (tree holds one ref)
        self.parent = parent
        self.children = {}          # key tuple -> _Node
        self.last_used = 0


class RadixPrefixCache:
    def __init__(self, cache):
        self.cache = cache          # PagedKVCache (owns the allocator)
        self.block_size = cache.block_size
        self.root = _Node(None, None, None)
        self._clock = itertools.count(1)
        self._nodes = 0
        # counters the engine mirrors into the metrics registry
        self.hit_tokens = 0
        self.lookup_tokens = 0
        self.inserted_pages = 0
        self.evicted_pages = 0

    @property
    def cached_pages(self):
        return self._nodes

    # -- lookup -----------------------------------------------------------

    def match(self, tokens, limit=None):
        """Longest cached prefix of ``tokens`` -> (pages, matched_len).

        Walks full-page chunks down the tree; the terminal step may be a
        PARTIAL match (a child page whose chunk shares a head with the
        remaining tokens) — its page is handed out too, and the caller's
        first write into it triggers copy-on-write. ``matched_len`` is
        capped at ``limit`` (callers pass ``len(tokens) - 1`` so at
        least one suffix token remains to prefill)."""
        limit = len(tokens) if limit is None else min(limit, len(tokens))
        stamp = next(self._clock)
        pages, matched = [], 0
        node = self.root
        bs = self.block_size
        while matched + bs <= limit:
            key = tuple(tokens[matched:matched + bs])
            child = node.children.get(key)
            if child is None:
                break
            child.last_used = stamp
            pages.append(child.page)
            matched += bs
            node = child
        # partial terminal match: the next chunk's head, inside one
        # cached child page (>= 1 token, < block_size)
        head = min(limit - matched, bs - 1)
        if head > 0:
            want = tuple(tokens[matched:matched + head])
            best, best_t = None, 0
            for ckey, child in node.children.items():
                t = 0
                while t < head and ckey[t] == want[t]:
                    t += 1
                if t > best_t:
                    best, best_t = child, t
            if best is not None:
                best.last_used = stamp
                pages.append(best.page)
                matched += best_t
        return pages, matched

    def note_lookup(self, lookup_tokens, hit_tokens):
        """Count one ADMITTED lookup. Deliberately separate from
        ``match``: a blocked queue head re-matches every engine step,
        and counting those retries would inflate the reported hit rate
        arbitrarily under pool pressure. (The retries still refresh the
        LRU stamps — the head admits soon, its prefix must stay hot.)"""
        self.lookup_tokens += int(lookup_tokens)
        self.hit_tokens += int(hit_tokens)

    # -- insert -----------------------------------------------------------

    def insert(self, tokens, pages, valid_tokens):
        """Register a request's FULL pages (the first
        ``valid_tokens // block_size`` of ``pages``, covering
        ``tokens[:...]``) in the tree. An existing node for a chunk wins
        — the request keeps its duplicate page privately and it frees
        normally at release; a new node increfs the request's page so it
        survives the request. Returns newly-inserted page count."""
        bs = self.block_size
        stamp = next(self._clock)
        node = self.root
        new = 0
        for i in range(valid_tokens // bs):
            key = tuple(tokens[i * bs:(i + 1) * bs])
            child = node.children.get(key)
            if child is None:
                page = pages[i]
                self.cache.allocator.incref(page)
                child = _Node(key, page, node)
                node.children[key] = child
                self._nodes += 1
                new += 1
            child.last_used = stamp
            node = child
        self.inserted_pages += new
        return new

    # -- eviction ---------------------------------------------------------

    def _evictable_leaves(self):
        out = []
        stack = [self.root]
        while stack:
            n = stack.pop()
            for c in n.children.values():
                if c.children:
                    stack.append(c)
                elif self.cache.allocator.refcount(c.page) == 1:
                    out.append(c)
        return out

    def _drop(self, node):
        del node.parent.children[node.key]
        self._nodes -= 1
        self.cache.allocator.decref(node.page)   # last ref -> free list
        self.evicted_pages += 1

    def reclaim(self, n_pages):
        """LRU eviction walk: drop leaf pages held ONLY by the tree
        until ``n_pages`` pages returned to the free list. ONE tree
        walk collects the candidates into a min-heap on ``last_used``;
        a dropped leaf that exposes its parent pushes the parent — so
        a multi-page reclaim (admission shortfall, warmup clear) is
        O(tree + freed·log tree), not a full re-walk per page. Returns
        the number actually freed — the caller re-checks
        ``free_blocks``."""
        freed = 0
        heap = [(leaf.last_used, id(leaf), leaf)
                for leaf in self._evictable_leaves()]
        heapq.heapify(heap)
        while freed < n_pages and heap:
            _, _, node = heapq.heappop(heap)
            if (node.children
                    or node.parent.children.get(node.key) is not node
                    or self.cache.allocator.refcount(node.page) != 1):
                continue            # stale entry (already dropped etc.)
            parent = node.parent
            self._drop(node)
            freed += 1
            if (parent is not self.root and not parent.children
                    and self.cache.allocator.refcount(parent.page) == 1):
                heapq.heappush(heap,
                               (parent.last_used, id(parent), parent))
        return freed

    def clear(self):
        """Drop every tree reference whose page is not also held by a
        live request (benchmark warmup isolation). Shared pages stay
        cached — a live request's mapping must not be pulled out from
        under it."""
        return self.reclaim(self._nodes)

    def stats(self):
        return {
            "cached_pages": self._nodes,
            "hit_tokens": self.hit_tokens,
            "lookup_tokens": self.lookup_tokens,
            "inserted_pages": self.inserted_pages,
            "evicted_pages": self.evicted_pages,
        }
