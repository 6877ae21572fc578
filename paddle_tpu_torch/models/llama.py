"""Llama decoder (counterpart of paddle_tpu/models/llama.py, the
``use_parallel=False`` branch).

Module names follow the reference (``llama.layers.0.self_attn.q_proj``,
``lm_head`` ...), so ``models/convert.py`` maps the reference's
``functional_state()`` names one to one. Attention goes through
``F.scaled_dot_product_attention`` (the flash kernel) or, when a serving
engine passes a paged cache view, through the view's
``update_and_attend`` hook: the engine owns the KV pages and the model
never stores KV state. ``generate`` (``models/generation.py``) passes
one ``DecodeCache`` a layer instead: static ``[B, L_max, H_kv, D]``
buffers written in place at the step's offset, attended through the
flash kernel at offset 0 (the prefill) and through SDPA's mask path
after. The views and the ``DecodeCache`` buffers are written in place,
so ``generate_step`` returns only the logits, where the reference's
returns ``(logits, caches)``. A legacy ``(pk, pv)`` pair a layer grows
by concatenation (the reference's end-aligned decode branch); the grown
pair replaces it in the caller's list.

Training: ``forward(input_ids, labels)`` returns the mean cross-entropy
over the flattened tokens, and ``LlamaConfig(recompute=True)`` wraps
each decoder layer in ``torch.utils.checkpoint`` (the reference's
``_remat_layer``), so the backward re-runs each layer's forward instead
of keeping its activations, under the forward's ``amp.auto_cast`` state
(the reference's eager recompute re-runs it without: "Faults of the
reference" 15 in ROADMAP.md). With ``FLAGS_fused_lm_head_ce`` on and a
token count that tiles 256 (``kernels.fused_ce.fused_ce_applies``), the
loss tail goes through the fused lm_head + cross-entropy kernels and the
``[B*S, V]`` logits are never built (``_maybe_fused_ce``, the reference's
``llama.py:405-423``).

``LlamaConfig(fuse_attention_qkv=True)`` replaces q/k/v_proj with one
``qkv_proj [hidden, (H + 2*H_kv)*D]`` split at ``(H*D, H*D + H_kv*D)``,
and ``fuse_mlp=True`` replaces gate/up_proj with one ``gate_up_proj
[hidden, 2*FFN]`` (gate first): the reference's fused variants, under
its parameter names, in training and in serving alike. One wider GEMM
gives the same numbers as the narrow ones, so each fused model equals
the unfused one whose weights are the fused weight's column blocks.

Not in this slice: tensor and sequence parallelism.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import amp
from ..core.dispatch import primitive
from ..core.tensor import name_parameters
from ..device import resolve_device
from ..kernels.fused_ce import fused_ce_applies, fused_mean_ce
from ..nn import functional as F
from ..nn.layers import Embedding, Linear, RMSNorm
from .generation import (DecodeCache, GenerationMixin, cache_update,
                         decode_mask, masked_decode_attention)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


class LlamaConfig:
    def __init__(self, vocab_size=32000, hidden_size=4096,
                 intermediate_size=11008, num_hidden_layers=32,
                 num_attention_heads=32, num_key_value_heads=None,
                 max_position_embeddings=4096, rms_norm_eps=1e-6,
                 rope_theta=10000.0, dtype="float32", recompute=False,
                 fuse_attention_qkv=False, fuse_mlp=False,
                 tie_word_embeddings=False):
        if dtype not in _DTYPES:
            raise ValueError("dtype must be one of %s" % sorted(_DTYPES))
        # the reference accepts tie_word_embeddings and never applies it
        # (paddle_tpu/models/llama.py:50, 63, 392-403: lm_head stays its
        # own weight): "Faults of the reference" 23 in ROADMAP.md
        if tie_word_embeddings:
            raise NotImplementedError(
                "LlamaConfig: tie_word_embeddings=True is not supported (the "
                "reference accepts it and keeps an untied lm_head)")
        self.tie_word_embeddings = False
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.intermediate_size = intermediate_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.num_key_value_heads = num_key_value_heads or num_attention_heads
        self.max_position_embeddings = max_position_embeddings
        self.rms_norm_eps = rms_norm_eps
        self.rope_theta = rope_theta
        self.dtype = dtype
        # per-decoder-layer activation recompute in training
        self.recompute = recompute
        # one [hidden, (H + 2*H_kv)*D] and one [hidden, 2*FFN] projection
        # in place of three and two narrow ones
        self.fuse_attention_qkv = fuse_attention_qkv
        self.fuse_mlp = fuse_mlp

    @property
    def torch_dtype(self):
        return _DTYPES[self.dtype]

    @property
    def head_dim(self):
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def tiny(cls, **kw):
        d = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                 num_hidden_layers=2, num_attention_heads=4,
                 max_position_embeddings=128)
        d.update(kw)
        return cls(**d)

    @classmethod
    def llama1b(cls, **kw):
        """The reference's on-chip serving preset
        (tools/serving_benchmark.py PRESETS["llama1b"])."""
        d = dict(vocab_size=32000, hidden_size=2048, intermediate_size=5504,
                 num_hidden_layers=22, num_attention_heads=16,
                 max_position_embeddings=2048)
        d.update(kw)
        return cls(**d)

    @classmethod
    def llama1b_train(cls, **kw):
        """The reference's ~1B training row (tools/model_benchmark.py
        ``bench_llama1b``, on-chip branch): 953M parameters in bfloat16
        with per-layer recompute."""
        d = dict(vocab_size=32000, hidden_size=2048, intermediate_size=5632,
                 num_hidden_layers=16, num_attention_heads=16,
                 max_position_embeddings=2048, dtype="bfloat16",
                 recompute=True)
        d.update(kw)
        return cls(**d)


@primitive
def rope_apply(q, k, theta, position_offset=0):
    """Rotary position embedding on q and k ``[B, S, H, D]``, half-split
    pairing (dim i rotates with dim i + D/2), angles in float32.

    ``position_offset`` is an int (one offset for the whole batch) or a
    ``[B]`` integer tensor (per-row offsets: the serving decode step,
    where each slot sits at its own position)."""
    d, seq, dev = q.shape[-1], q.shape[1], q.device
    inv_freq = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                             device=dev) / d))
    steps = torch.arange(seq, dtype=torch.float32, device=dev)
    if isinstance(position_offset, torch.Tensor) and position_offset.dim():
        pos = position_offset.to(dev, torch.float32)[:, None] + steps[None]
        freqs = pos[..., None] * inv_freq                  # [B, S, D/2]
        freqs = freqs[:, :, None, :]
    else:
        freqs = torch.outer(steps + int(position_offset), inv_freq)
        freqs = freqs[None, :, None, :]                    # [1, S, 1, D/2]
    cos = torch.cat([freqs.cos(), freqs.cos()], dim=-1)
    sin = torch.cat([freqs.sin(), freqs.sin()], dim=-1)
    return _rope_rot(q, cos, sin), _rope_rot(k, cos, sin)


def _rope_rot(x, cos, sin):
    half = x.shape[-1] // 2
    xf = x.float()
    rotated = torch.cat([-xf[..., half:], xf[..., :half]], dim=-1)
    return (xf * cos + rotated * sin).to(x.dtype)


class LlamaAttention(nn.Module):
    def __init__(self, config, *, generator, device):
        super().__init__()
        c = config
        self.num_heads = c.num_attention_heads
        self.num_kv_heads = c.num_key_value_heads
        self.head_dim = c.head_dim
        self.rope_theta = c.rope_theta
        kw = dict(bias_attr=False, generator=generator, device=device,
                  dtype=c.torch_dtype)
        q_dim = self.num_heads * self.head_dim
        kv_dim = self.num_kv_heads * self.head_dim
        self.fuse_qkv = c.fuse_attention_qkv
        if self.fuse_qkv:
            self._qkv_splits = (q_dim, kv_dim, kv_dim)
            self.qkv_proj = Linear(c.hidden_size, q_dim + 2 * kv_dim, **kw)
        else:
            self.q_proj = Linear(c.hidden_size, q_dim, **kw)
            self.k_proj = Linear(c.hidden_size, kv_dim, **kw)
            self.v_proj = Linear(c.hidden_size, kv_dim, **kw)
        self.o_proj = Linear(q_dim, c.hidden_size, **kw)

    def _project(self, x):
        """q, k, v as ``[B, S, heads, D]``; from the fused projection
        they are strided views of its output (last axis contiguous),
        which rope copies for q and k and the kernels read as they are."""
        if self.fuse_qkv:
            q, k, v = self.qkv_proj(x).split(self._qkv_splits, dim=-1)
        else:
            q, k, v = self.q_proj(x), self.k_proj(x), self.v_proj(x)
        b, s, _ = x.shape
        return (q.view(b, s, self.num_heads, self.head_dim),
                k.view(b, s, self.num_kv_heads, self.head_dim),
                v.view(b, s, self.num_kv_heads, self.head_dim))

    def forward(self, x, cache=None, position_offset=0):
        """The attention output, or with a ``cache`` the pair (output,
        the cache to keep): the same view or ``DecodeCache``, written in
        place, or the grown ``(k, v)`` pair."""
        b, s, _ = x.shape
        q, k, v = self._project(x)
        q, k = rope_apply(q, k, self.rope_theta, position_offset)
        if cache is None:
            ctx = F.scaled_dot_product_attention(q, k, v, is_causal=True)
        elif hasattr(cache, "update_and_attend"):
            # external-cache hook (serving): the engine's per-layer paged
            # view writes this step's K/V into its pool pages and returns
            # the attention context (serving/kv_cache.py)
            ctx = cache.update_and_attend(q, k, v)
        elif isinstance(cache, DecodeCache):
            # static-buffer decode (generation.py)
            k, v = cache_update(cache, k, v, position_offset)
            ctx = masked_decode_attention(q, k, v, decode_mask(
                position_offset, s, k.shape[1], device=q.device))
        else:
            # legacy growing cache: the s new queries sit at the END of
            # the kv window (end-aligned mask)
            pk, pv = cache
            k, v = torch.cat([pk, k], dim=1), torch.cat([pv, v], dim=1)
            cache = (k, v)
            ctx = masked_decode_attention(q, k, v, decode_mask(
                k.shape[1] - s, s, k.shape[1], device=q.device))
        out = self.o_proj(ctx.reshape(b, s, self.num_heads * self.head_dim))
        return out if cache is None else (out, cache)


class LlamaMLP(nn.Module):
    def __init__(self, config, *, generator, device):
        super().__init__()
        c = config
        kw = dict(bias_attr=False, generator=generator, device=device,
                  dtype=c.torch_dtype)
        self.fuse_mlp = c.fuse_mlp
        if self.fuse_mlp:
            self._inter = c.intermediate_size
            self.gate_up_proj = Linear(c.hidden_size,
                                       2 * c.intermediate_size, **kw)
        else:
            self.gate_proj = Linear(c.hidden_size, c.intermediate_size, **kw)
            self.up_proj = Linear(c.hidden_size, c.intermediate_size, **kw)
        self.down_proj = Linear(c.intermediate_size, c.hidden_size, **kw)

    def forward(self, x):
        if self.fuse_mlp:
            gate, up = self.gate_up_proj(x).split(self._inter, dim=-1)
        else:
            gate, up = self.gate_proj(x), self.up_proj(x)
        return self.down_proj(F.silu(gate) * up)


class LlamaDecoderLayer(nn.Module):
    def __init__(self, config, *, generator, device):
        super().__init__()
        kw = dict(device=device, dtype=config.torch_dtype)
        self.input_layernorm = RMSNorm(config.hidden_size,
                                       config.rms_norm_eps, **kw)
        self.self_attn = LlamaAttention(config, generator=generator,
                                        device=device)
        self.post_attention_layernorm = RMSNorm(config.hidden_size,
                                                config.rms_norm_eps, **kw)
        self.mlp = LlamaMLP(config, generator=generator, device=device)

    def forward(self, x, cache=None, position_offset=0):
        """``x`` after the layer, or with a ``cache`` the pair (x, the
        cache to keep) (``LlamaAttention.forward``)."""
        h = self.self_attn(self.input_layernorm(x), cache, position_offset)
        if cache is not None:
            h, cache = h
        x = x + h
        x = x + self.mlp(self.post_attention_layernorm(x))
        return x if cache is None else (x, cache)


class LlamaModel(nn.Module):
    def __init__(self, config, *, generator, device):
        super().__init__()
        self.config = config
        self.embed_tokens = Embedding(config.vocab_size, config.hidden_size,
                                      generator=generator, device=device,
                                      dtype=config.torch_dtype)
        self.layers = nn.ModuleList(
            [LlamaDecoderLayer(config, generator=generator, device=device)
             for _ in range(config.num_hidden_layers)])
        self.norm = RMSNorm(config.hidden_size, config.rms_norm_eps,
                            device=device, dtype=config.torch_dtype)

    def forward(self, input_ids, caches=None, position_offset=0):
        """Final-normed hidden states; ``caches`` (one entry a layer) is
        updated in place, a grown legacy pair replacing its entry."""
        x = self.embed_tokens(input_ids)
        remat = self.config.recompute and caches is None
        for i, layer in enumerate(self.layers):
            if remat:
                x = checkpoint(_run_layer, layer, x, amp.amp_state(),
                               use_reentrant=False)
            elif caches is None:
                x = layer(x)
            else:
                x, caches[i] = layer(x, caches[i], position_offset)
        return self.norm(x)


def _run_layer(layer, x, amp_state):
    """A decoder layer under the AMP state of the forward that checkpointed
    it: the backward's recomputation runs outside ``auto_cast``, and
    would otherwise recompute in other dtypes than the forward did."""
    with amp.state_scope(amp_state):
        return layer(x)


class LlamaForCausalLM(GenerationMixin, nn.Module):
    def __init__(self, config, device=None, generator=None):
        """Weights are drawn from ``generator`` (a ``torch.Generator`` on
        the model's device; seed 0 when omitted). ``device`` defaults to
        the card and raises without one (``device.resolve_device``)."""
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        self.config = config
        self.llama = LlamaModel(config, generator=generator, device=device)
        self.lm_head = Linear(config.hidden_size, config.vocab_size,
                              bias_attr=False, generator=generator,
                              device=device, dtype=config.torch_dtype)
        name_parameters(self)

    @property
    def device(self):
        return self.lm_head.weight.device

    def _maybe_fused_ce(self, h, labels):
        """The mean cross-entropy of the final-normed ``h [B, S, H]``
        through the fused lm_head + CE kernels when the gate applies
        (``FLAGS_fused_lm_head_ce`` on, ``B*S % 256 == 0``), else None."""
        if not fused_ce_applies(h):
            return None
        b, s, hid = h.shape
        return fused_mean_ce(h.reshape(b * s, hid), self.lm_head.weight,
                             labels.reshape(b * s))

    def forward(self, input_ids, labels=None):
        """Full-sequence logits ``[B, S, V]`` (causal, no cache), or, when
        ``labels [B, S]`` are given, the mean cross-entropy of the logits
        against them (rows labelled -100 ignored), fused when the gate of
        ``_maybe_fused_ce`` applies."""
        h = self.llama(input_ids)
        if labels is not None:
            fused = self._maybe_fused_ce(h, labels)
            if fused is not None:
                return fused
        logits = self.lm_head(h)
        if labels is None:
            return logits
        return F.cross_entropy(logits.reshape(-1, self.config.vocab_size),
                               labels.reshape(-1))

    def generate_step(self, input_ids, caches, position_offset):
        """One step over per-layer caches (the engine's views, or
        ``init_decode_caches``' buffers): writes this step's K/V in place
        and returns only the logits ``[B, S, V]``."""
        return self.lm_head(self.llama(input_ids, caches, position_offset))

    def max_decode_len(self):
        return self.config.max_position_embeddings

    def paged_cache_spec(self):
        """KV geometry for the serving engine's paged cache."""
        cfg = self.config
        return {"num_layers": cfg.num_hidden_layers,
                "num_kv_heads": cfg.num_key_value_heads,
                "head_dim": cfg.head_dim,
                "dtype": cfg.torch_dtype}

    def init_decode_caches(self, batch, total_len):
        """One zeroed ``DecodeCache`` a layer, ``[batch, total_len, H_kv,
        D]`` in the model's dtype on its device."""
        cfg = self.config
        shape = (batch, total_len, cfg.num_key_value_heads, cfg.head_dim)
        kw = dict(dtype=cfg.torch_dtype, device=self.device)
        return [DecodeCache(torch.zeros(shape, **kw), torch.zeros(shape, **kw))
                for _ in range(cfg.num_hidden_layers)]
