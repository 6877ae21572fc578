"""Transformer layers (counterpart of paddle_tpu/nn/layers/transformer.py).

``MultiHeadAttention`` keeps the reference's ``[batch, seq, heads,
head_dim]`` layout and calls ``F.scaled_dot_product_attention``: without
a mask that is the flash kernel (kernel 1 forward, kernels 2 and 3 in the
backward), non-causal, rectangular where the keys are longer or shorter
than the queries (cross-attention, a growing ``Cache``); with a mask
(``tgt_mask``, ``src_mask``, ``memory_mask``) it is SDPA's plain masked
path, as the reference's mask takes its XLA path. In training it passes
``dropout_p=dropout``, which, as in the reference, applies no attention
dropout ("Faults of the reference" 5, mirrored).

``Cache`` grows by concatenation (incremental decoding; the layer returns
``(out, new_cache)``), ``StaticCache`` holds a projected memory
(cross-attention; the layer returns ``out``). ``TransformerEncoder`` and
``TransformerDecoder`` deep-copy their first layer ``num_layers - 1``
times, as the reference does, so every layer starts from the same
weights; the copies share the first layer's dropout generator.

Parameter names are the reference's (``encoder.layers.0.self_attn.q_proj
.weight``, ``decoder.layers.1.norm3.bias`` ...), so
``models.convert.load_jax_state`` carries weights across unchanged.
Weights are drawn from ``generator`` (a ``torch.Generator`` on
``device``; seed 0 when omitted) with the reference's laws, dropout masks
from the same generator; ``device`` defaults to the card and raises
without one. ``weight_attr`` and ``bias_attr`` are accepted where the
reference takes them: ``MultiHeadAttention``'s projections follow
``bias_attr`` (False leaves out their biases), and the other layers
ignore both, as the reference's do.
"""
from __future__ import annotations

import copy

import torch
from torch import nn

from ...core.tensor import name_parameters
from ...device import resolve_device
from .. import functional as F
from .common import Dropout, Linear
from .container import LayerList
from .norm import LayerNorm


def _setup(device, generator):
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    return device, generator


def _clones(layer, num_layers):
    """``layer`` and ``num_layers - 1`` deep copies of it; the copies
    draw dropout masks from ``layer``'s generators, not from clones of
    their state."""
    shared = {id(m.generator): m.generator for m in layer.modules()
              if isinstance(m, Dropout) and m.generator is not None}
    return LayerList([layer] + [copy.deepcopy(layer, dict(shared))
                                for _ in range(num_layers - 1)])


class MultiHeadAttention(nn.Module):
    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None, *, generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        device, generator = _setup(device, generator)
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        if self.head_dim * num_heads != embed_dim:
            raise ValueError("embed_dim %d is not a multiple of num_heads %d"
                             % (embed_dim, num_heads))
        self.dropout = dropout
        self.need_weights = need_weights
        kw = dict(bias_attr=bias_attr, generator=generator, device=device,
                  dtype=dtype)
        self.q_proj = Linear(embed_dim, embed_dim, **kw)
        self.k_proj = Linear(kdim or embed_dim, embed_dim, **kw)
        self.v_proj = Linear(vdim or embed_dim, embed_dim, **kw)
        self.out_proj = Linear(embed_dim, embed_dim, **kw)

    class Cache:
        def __init__(self, k, v):
            self.k, self.v = k, v

    class StaticCache:
        def __init__(self, k, v):
            self.k, self.v = k, v

    def _split_heads(self, x):
        b, s, _ = x.shape
        return x.reshape(b, s, self.num_heads, self.head_dim)

    def gen_cache(self, key, value=None, type=None):
        """A ``StaticCache`` of the projected ``key``/``value`` when
        ``type`` is ``StaticCache``, else an empty ``Cache`` (``[B, 0, H,
        D]`` in ``key``'s dtype) for incremental decoding."""
        if type == MultiHeadAttention.StaticCache:
            k = self._split_heads(self.k_proj(key))
            v = self._split_heads(self.v_proj(
                value if value is not None else key))
            return self.StaticCache(k, v)
        empty = torch.zeros((key.shape[0], 0, self.num_heads, self.head_dim),
                            dtype=key.dtype, device=key.device)
        return self.Cache(empty, empty.clone())

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        key = query if key is None else key
        value = key if value is None else value
        q = self._split_heads(self.q_proj(query))
        if isinstance(cache, self.StaticCache):
            k, v = cache.k, cache.v
        else:
            k = self._split_heads(self.k_proj(key))
            v = self._split_heads(self.v_proj(value))
            if isinstance(cache, self.Cache):
                k = torch.cat([cache.k, k], dim=1)
                v = torch.cat([cache.v, v], dim=1)
                cache = self.Cache(k, v)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask,
            dropout_p=self.dropout if self.training else 0.0)
        b, s = out.shape[0], out.shape[1]
        out = self.out_proj(out.reshape(b, s, self.embed_dim))
        if isinstance(cache, self.Cache):
            return out, cache
        return out


class TransformerEncoderLayer(nn.Module):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 *, generator=None, device=None, dtype=torch.float32):
        super().__init__()
        device, generator = _setup(device, generator)
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(
            d_model, nhead,
            dropout=dropout if attn_dropout is None else attn_dropout, **kw)
        self.linear1 = Linear(d_model, dim_feedforward, **kw)
        self.linear2 = Linear(dim_feedforward, d_model, **kw)
        self.norm1 = LayerNorm(d_model, device=device, dtype=dtype)
        self.norm2 = LayerNorm(d_model, device=device, dtype=dtype)
        self.dropout1 = Dropout(dropout, generator=generator)
        self.dropout2 = Dropout(dropout, generator=generator)
        self.act_dropout = Dropout(
            dropout if act_dropout is None else act_dropout,
            generator=generator)
        self.activation = activation

    def forward(self, src, src_mask=None, cache=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        if cache is not None:
            src, cache = self.self_attn(src, src, src, src_mask, cache)
        else:
            src = self.self_attn(src, src, src, src_mask)
        src = residual + self.dropout1(src)
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.act_dropout(
            getattr(F, self.activation)(self.linear1(src))))
        src = residual + self.dropout2(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return src if cache is None else (src, cache)

    def gen_cache(self, src):
        return self.self_attn.gen_cache(src)


class TransformerEncoder(nn.Module):
    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = _clones(encoder_layer, num_layers)
        self.num_layers = num_layers
        self.norm = norm
        name_parameters(self)

    def forward(self, src, src_mask=None, cache=None):
        output = src
        new_caches = []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, src_mask)
            else:
                output, c = mod(output, src_mask, cache[i])
                new_caches.append(c)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, src):
        return [layer.gen_cache(src) for layer in self.layers]


class TransformerDecoderLayer(nn.Module):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 *, generator=None, device=None, dtype=torch.float32):
        super().__init__()
        device, generator = _setup(device, generator)
        kw = dict(generator=generator, device=device, dtype=dtype)
        attn_p = dropout if attn_dropout is None else attn_dropout
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, dropout=attn_p,
                                            **kw)
        self.cross_attn = MultiHeadAttention(d_model, nhead, dropout=attn_p,
                                             **kw)
        self.linear1 = Linear(d_model, dim_feedforward, **kw)
        self.linear2 = Linear(dim_feedforward, d_model, **kw)
        self.norm1 = LayerNorm(d_model, device=device, dtype=dtype)
        self.norm2 = LayerNorm(d_model, device=device, dtype=dtype)
        self.norm3 = LayerNorm(d_model, device=device, dtype=dtype)
        self.dropout1 = Dropout(dropout, generator=generator)
        self.dropout2 = Dropout(dropout, generator=generator)
        # the reference's act_dropout is unused here: dropout3 takes
        # ``dropout`` and sits after the activation
        self.dropout3 = Dropout(dropout, generator=generator)
        self.activation = activation

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        if cache is None:
            tgt = self.self_attn(tgt, tgt, tgt, tgt_mask)
        else:
            tgt, new_inc = self.self_attn(tgt, tgt, tgt, tgt_mask, cache[0])
        tgt = residual + self.dropout1(tgt)
        if not self.normalize_before:
            tgt = self.norm1(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        if cache is None:
            tgt = self.cross_attn(tgt, memory, memory, memory_mask)
        else:
            tgt = self.cross_attn(tgt, memory, memory, memory_mask, cache[1])
        tgt = residual + self.dropout2(tgt)
        if not self.normalize_before:
            tgt = self.norm2(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        tgt = self.linear2(self.dropout3(getattr(F, self.activation)(
            self.linear1(tgt))))
        tgt = residual + tgt
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        return tgt if cache is None else (tgt, (new_inc, cache[1]))

    def gen_cache(self, memory):
        inc = self.self_attn.gen_cache(memory)
        static = self.cross_attn.gen_cache(
            memory, memory, type=MultiHeadAttention.StaticCache)
        return inc, static


class TransformerDecoder(nn.Module):
    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = _clones(decoder_layer, num_layers)
        self.num_layers = num_layers
        self.norm = norm
        name_parameters(self)

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        output = tgt
        new_caches = []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, memory, tgt_mask, memory_mask)
            else:
                output, c = mod(output, memory, tgt_mask, memory_mask,
                                cache[i])
                new_caches.append(c)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, memory):
        return [layer.gen_cache(memory) for layer in self.layers]


class Transformer(nn.Module):
    """The reference's defaults are the base model of Vaswani et al. (6 + 6
    layers, d_model 512, 8 heads, FFN 2048, dropout 0.1, relu)."""

    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 custom_encoder=None, custom_decoder=None, *, generator=None,
                 device=None, dtype=torch.float32):
        super().__init__()
        device, generator = _setup(device, generator)
        kw = dict(generator=generator, device=device, dtype=dtype)
        args = (d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before)
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            norm = (LayerNorm(d_model, device=device, dtype=dtype)
                    if normalize_before else None)
            self.encoder = TransformerEncoder(
                TransformerEncoderLayer(*args, **kw), num_encoder_layers,
                norm)
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            norm = (LayerNorm(d_model, device=device, dtype=dtype)
                    if normalize_before else None)
            self.decoder = TransformerDecoder(
                TransformerDecoderLayer(*args, **kw), num_decoder_layers,
                norm)
        self.d_model = d_model
        self.nhead = nhead
        name_parameters(self)

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask)
        return self.decoder(tgt, memory, tgt_mask, memory_mask)

    @staticmethod
    def generate_square_subsequent_mask(length, device=None):
        """The additive causal mask ``[length, length]``: 0 on and below
        the diagonal, -1e9 above it, float32 on ``device`` (the card
        unless ``device="cpu"``)."""
        keep = torch.ones(length, length, dtype=torch.bool,
                          device=resolve_device(device)).tril()
        return torch.where(keep, 0.0, -1e9).to(torch.float32)
