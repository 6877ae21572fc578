"""GPT-style decoder (counterpart of paddle_tpu/models/gpt.py at
``use_parallel=False`` and ``moe_experts=0``): LayerNorm, learned
positions, a fused biased ``qkv`` projection, a GELU MLP and logits tied
to the token embedding.

Module and parameter names are the reference's (``wte``, ``wpe``,
``blocks.0.qkv.weight``, ``blocks.0.ln1.bias``, ``ln_f.weight`` ...), so
``models/convert.load_jax_state`` carries its weights across unchanged.
Attention goes through ``F.scaled_dot_product_attention`` (the flash
kernel), a serving engine's paged view (``update_and_attend``) or a
``DecodeCache`` from ``init_decode_caches`` (``models/generation.py``),
the last two written in place, so ``generate_step`` returns only the
logits. ``position_offset`` is an int or, from the engine, a ``[B]``
tensor of per-row offsets. Positions past the table are clamped to its
last row, as the reference's XLA gather clamps them (only the engine's
pad rows reach there; ``generate`` validates the length).

Not in this slice: tensor parallelism (``use_parallel``) and MoE blocks
(``moe_experts``); both raise NotImplementedError (ROADMAP.md, queue
A.7).
"""
from __future__ import annotations

import torch
from torch import nn

from ..core.tensor import name_parameters
from ..device import resolve_device
from ..nn import functional as F
from ..nn.layers import Dropout, Embedding, LayerNorm, Linear
from .generation import (DecodeCache, GenerationMixin, cache_update,
                         decode_mask, masked_decode_attention)


class GPTBlock(nn.Module):
    def __init__(self, hidden, heads, ffn, dropout=0.0, use_parallel=False,
                 moe_experts=0, moe_top_k=2, *, generator, device):
        super().__init__()
        if use_parallel or moe_experts:
            raise NotImplementedError(
                "GPTBlock: use_parallel and moe_experts are not ported "
                "(ROADMAP.md, queue A.7)")
        kw = dict(generator=generator, device=device)
        self.ln1 = LayerNorm(hidden, device=device)
        self.ln2 = LayerNorm(hidden, device=device)
        self.heads = heads
        self.head_dim = hidden // heads
        self.qkv = Linear(hidden, 3 * hidden, **kw)
        self.proj = Linear(hidden, hidden, **kw)
        self.fc1 = Linear(hidden, ffn, **kw)
        self.fc2 = Linear(ffn, hidden, **kw)
        self.drop = Dropout(dropout)

    def forward(self, x, cache=None, position_offset=0):
        """``x`` after the block, or with a ``cache`` the pair (x, the
        same cache, written in place)."""
        b, s, hdim = x.shape
        qkv = self.qkv(self.ln1(x)).reshape(b, s, 3, self.heads,
                                            self.head_dim)
        q, k, v = qkv.unbind(dim=2)
        if cache is None:
            attn = F.scaled_dot_product_attention(q, k, v, is_causal=True)
        elif hasattr(cache, "update_and_attend"):
            # external-cache hook: the serving engine's paged view writes
            # K/V into its pool and runs paged attention
            # (serving/kv_cache.py)
            attn = cache.update_and_attend(q, k, v)
        elif isinstance(cache, DecodeCache):
            k, v = cache_update(cache, k, v, position_offset)
            attn = masked_decode_attention(q, k, v, decode_mask(
                position_offset, s, k.shape[1], device=q.device))
        else:
            raise TypeError(
                "GPTBlock decode takes DecodeCache buffers "
                "(init_decode_caches); got %r" % type(cache).__name__)
        x = x + self.drop(self.proj(attn.reshape(b, s, hdim)))
        x = x + self.drop(self.fc2(F.gelu(self.fc1(self.ln2(x)))))
        return x if cache is None else (x, cache)


class GPTModel(GenerationMixin, nn.Module):
    def __init__(self, vocab_size=50304, hidden_size=768, num_layers=12,
                 num_heads=12, ffn_size=None, max_seq_len=1024, dropout=0.0,
                 use_parallel=False, moe_experts=0, moe_every=2,
                 moe_top_k=2, moe_aux_coeff=0.01, *, device=None,
                 generator=None):
        """The reference's defaults are GPT-2 small's geometry (12 layers,
        12 heads x 64, about 124M parameters), in float32. Weights are
        drawn from ``generator`` (a ``torch.Generator`` on the model's
        device; seed 0 when omitted) with the reference's laws; ``device``
        defaults to the card and raises without one
        (``device.resolve_device``)."""
        super().__init__()
        if use_parallel or moe_experts:
            raise NotImplementedError(
                "GPTModel: use_parallel and moe_experts are not ported "
                "(ROADMAP.md, queue A.7)")
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        ffn_size = ffn_size or 4 * hidden_size
        kw = dict(generator=generator, device=device)
        self.wte = Embedding(vocab_size, hidden_size, **kw)
        self.wpe = Embedding(max_seq_len, hidden_size, **kw)
        self.blocks = nn.ModuleList([
            GPTBlock(hidden_size, num_heads, ffn_size, dropout, **kw)
            for _ in range(num_layers)])
        self.ln_f = LayerNorm(hidden_size, device=device)
        self.vocab_size = vocab_size
        name_parameters(self)

    @property
    def device(self):
        return self.wte.weight.device

    def _positions(self, s, position_offset):
        """``[1, S]`` or, for ``[B]`` offsets, ``[B, S]`` position ids,
        clamped to the table."""
        steps = torch.arange(s, device=self.device)
        off = position_offset
        if isinstance(off, torch.Tensor) and off.dim():
            pos = off.to(self.device, torch.long)[:, None] + steps[None]
        else:
            pos = (steps + int(off))[None]
        return pos.clamp(max=self.wpe.num_embeddings - 1)

    def forward(self, input_ids, labels=None, caches=None,
                position_offset=0):
        """Logits ``[B, S, V]``, or with ``labels [B, S]`` their mean
        cross-entropy (rows labelled -100 ignored). ``caches`` (one entry
        a block) are written in place."""
        s = input_ids.shape[1]
        x = self.wte(input_ids) + self.wpe(self._positions(s,
                                                           position_offset))
        for i, blk in enumerate(self.blocks):
            if caches is None:
                x = blk(x)
            else:
                x, caches[i] = blk(x, caches[i], position_offset)
        x = self.ln_f(x)
        logits = torch.matmul(x, self.wte.weight.t())
        if labels is not None and caches is None:
            return F.cross_entropy(logits.reshape(-1, self.vocab_size),
                                   labels.reshape(-1))
        return logits

    def generate_step(self, input_ids, caches, position_offset):
        """One step over per-block caches (the engine's views, or
        ``init_decode_caches``' buffers): writes this step's K/V in place
        and returns only the logits ``[B, S, V]``, where the reference's
        returns ``(logits, caches)``."""
        return self.forward(input_ids, caches=caches,
                            position_offset=position_offset)

    def max_decode_len(self):
        return self.wpe.num_embeddings

    def paged_cache_spec(self):
        """KV geometry for the serving engine's paged cache."""
        return {"num_layers": len(self.blocks),
                "num_kv_heads": self.blocks[0].heads,
                "head_dim": self.blocks[0].head_dim,
                "dtype": self.wte.weight.dtype}

    def init_decode_caches(self, batch, total_len):
        """One zeroed ``DecodeCache`` a block, ``[batch, total_len, H,
        D]`` in the model's dtype on its device."""
        blk = self.blocks[0]
        shape = (batch, total_len, blk.heads, blk.head_dim)
        kw = dict(dtype=self.wte.weight.dtype, device=self.device)
        return [DecodeCache(torch.zeros(shape, **kw), torch.zeros(shape, **kw))
                for _ in range(len(self.blocks))]
