"""ERNIE: a BERT-style bidirectional encoder (counterpart of
paddle_tpu/models/ernie.py, the ``use_parallel=False`` layout).

Token, position and token-type embeddings, a LayerNorm and dropout, then
post-LN blocks (``x = ln1(x + drop(attn(x)))``, ``x = ln2(x +
drop(fc2(gelu(fc1(x)))))``), a tanh pooler over the first token, and the
pretraining heads: the masked-LM head (a transform, GELU, LayerNorm and a
biased ``mlm_head [hidden, vocab]``) and the sentence-order head
(``sop_head``, 2 classes over the pooled output).

Attention is bidirectional. Without ``attn_mask`` it goes through
``F.scaled_dot_product_attention(..., is_causal=False)``: kernel 1 in the
forward, kernels 2 and 3 in the backward. ``ErnieConfig(fuse_qkv=True)``
projects q, k and v with one ``qkv_proj [hidden, 3 * hidden]`` whose
output is viewed as ``[B, S, 3, heads, head_dim]``; the kernels read q, k
and v as strided views of it. With ``attn_mask`` (a padding mask, bool or
additive, broadcast against ``[B, heads, S, S]``) attention takes SDPA's
plain masked path, as the reference's mask takes its XLA path.

The fused MLM tail (``_maybe_fused_mlm_ce``): with
``FLAGS_fused_lm_head_ce`` on and ``B * S`` a multiple of 256
(``kernels.fused_ce.fused_ce_applies``), the MLM loss goes through the
fused lm_head + cross-entropy kernels (kernels 4-6) and the ``[B*S,
vocab]`` logits are never built. ``mlm_head`` carries a bias, which the
kernels do not take; it is folded in exactly, as the reference folds it:
``h`` gets a ones column and 127 zero columns, ``w`` the bias row and 127
zero rows, so ``[h, 1, 0] @ [[w], [b], [0]] = h @ w + b`` with H = hidden
+ 128 (896 for ERNIE-base). Gradients reach ``mlm_head.weight`` and
``mlm_head.bias`` through the concatenation. The reference's third
condition, a traced value, has no counterpart (``kernels/fused_ce.py``).

Parameter names are the reference's (``ernie.layers.0.attn.qkv_proj
.weight``, ``mlm_head.bias`` ...), so ``models.convert.load_jax_state``
carries its ``functional_state()`` across unchanged, and every parameter's
``name`` is its path (``core.tensor.name_parameters``), for AdamW's
``apply_decay_param_fun``. Weights are drawn from ``generator`` (a
``torch.Generator`` on the model's device; seed 0 when omitted) with the
reference's laws, and the dropout masks from the same generator;
``device`` defaults to the card and raises without one.

Not in this slice: tensor parallelism (``use_parallel=True`` raises
NotImplementedError).
"""
from __future__ import annotations

import torch
from torch import nn

from ..core.tensor import name_parameters
from ..device import resolve_device
from ..kernels.fused_ce import fused_ce_applies, fused_mean_ce
from ..nn import functional as F
from ..nn.layers import Dropout, Embedding, LayerList, LayerNorm, Linear
from .llama import _DTYPES

# columns the fused MLM tail adds to h (and rows to w) to fold the bias
MLM_BIAS_PAD = 128


class ErnieConfig:
    def __init__(self, vocab_size=40000, hidden_size=768,
                 num_hidden_layers=12, num_attention_heads=12,
                 intermediate_size=3072, max_position_embeddings=512,
                 type_vocab_size=4, hidden_dropout_prob=0.1,
                 use_parallel=False, dtype="float32", fuse_qkv=False):
        if use_parallel:
            raise NotImplementedError(
                "ErnieConfig: use_parallel is not ported (ROADMAP.md, "
                "queue A.7)")
        if dtype not in _DTYPES:
            raise ValueError("dtype must be one of %s" % sorted(_DTYPES))
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.intermediate_size = intermediate_size
        self.max_position_embeddings = max_position_embeddings
        self.type_vocab_size = type_vocab_size
        self.hidden_dropout_prob = hidden_dropout_prob
        self.use_parallel = use_parallel
        self.dtype = dtype
        # one [h, 3h] projection instead of three [h, h] ones
        self.fuse_qkv = fuse_qkv

    @property
    def torch_dtype(self):
        return _DTYPES[self.dtype]

    @classmethod
    def tiny(cls, **kw):
        d = dict(vocab_size=128, hidden_size=32, num_hidden_layers=2,
                 num_attention_heads=4, intermediate_size=64,
                 max_position_embeddings=64, type_vocab_size=2,
                 hidden_dropout_prob=0.0)
        d.update(kw)
        return cls(**d)

    @classmethod
    def base(cls, **kw):
        """ERNIE-3.0-base's geometry: vocab 40000, hidden 768, 12 layers x
        12 heads of 64, FFN 3072, 512 positions, 4 token types."""
        return cls(**kw)


def _setup(config, device, generator):
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    return dict(generator=generator, device=device,
                dtype=config.torch_dtype)


class ErnieSelfAttention(nn.Module):
    def __init__(self, c, *, generator, device, dtype):
        super().__init__()
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.heads = c.num_attention_heads
        self.head_dim = c.hidden_size // c.num_attention_heads
        self.fuse_qkv = c.fuse_qkv
        if self.fuse_qkv:
            self.qkv_proj = Linear(c.hidden_size, 3 * c.hidden_size, **kw)
        else:
            self.q_proj = Linear(c.hidden_size, c.hidden_size, **kw)
            self.k_proj = Linear(c.hidden_size, c.hidden_size, **kw)
            self.v_proj = Linear(c.hidden_size, c.hidden_size, **kw)
        self.out_proj = Linear(c.hidden_size, c.hidden_size, **kw)

    def forward(self, x, attn_mask=None):
        b, s, h = x.shape
        if self.fuse_qkv:
            qkv = self.qkv_proj(x).view(b, s, 3, self.heads, self.head_dim)
            q, k, v = qkv.unbind(dim=2)
        else:
            q, k, v = (proj(x).view(b, s, self.heads, self.head_dim)
                       for proj in (self.q_proj, self.k_proj, self.v_proj))
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask,
                                             is_causal=False)
        return self.out_proj(out.reshape(b, s, h))


class ErnieLayer(nn.Module):
    """Post-LN block (the BERT/ERNIE convention, unlike Llama's pre-LN)."""

    def __init__(self, c, *, generator, device, dtype):
        super().__init__()
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.attn = ErnieSelfAttention(c, **kw)
        self.ln1 = LayerNorm(c.hidden_size, device=device, dtype=dtype)
        self.ln2 = LayerNorm(c.hidden_size, device=device, dtype=dtype)
        self.fc1 = Linear(c.hidden_size, c.intermediate_size, **kw)
        self.fc2 = Linear(c.intermediate_size, c.hidden_size, **kw)
        self.dropout = Dropout(c.hidden_dropout_prob, generator=generator)

    def forward(self, x, attn_mask=None):
        x = self.ln1(x + self.dropout(self.attn(x, attn_mask)))
        return self.ln2(x + self.dropout(self.fc2(F.gelu(self.fc1(x)))))


class ErnieModel(nn.Module):
    def __init__(self, config, device=None, generator=None):
        super().__init__()
        c = self.config = config
        kw = _setup(c, device, generator)
        self.word_embeddings = Embedding(c.vocab_size, c.hidden_size, **kw)
        self.position_embeddings = Embedding(c.max_position_embeddings,
                                             c.hidden_size, **kw)
        self.token_type_embeddings = Embedding(c.type_vocab_size,
                                               c.hidden_size, **kw)
        self.embed_ln = LayerNorm(c.hidden_size, device=kw["device"],
                                  dtype=kw["dtype"])
        self.embed_dropout = Dropout(c.hidden_dropout_prob,
                                     generator=kw["generator"])
        self.layers = LayerList([ErnieLayer(c, **kw)
                                 for _ in range(c.num_hidden_layers)])
        self.pooler = Linear(c.hidden_size, c.hidden_size, **kw)
        name_parameters(self)

    def forward(self, input_ids, token_type_ids=None, attn_mask=None):
        """``(h [B, S, hidden], pooled [B, hidden])``."""
        s = input_ids.shape[1]
        pos = torch.arange(s, device=input_ids.device)[None]
        h = self.word_embeddings(input_ids) + self.position_embeddings(pos)
        if token_type_ids is not None:
            h = h + self.token_type_embeddings(token_type_ids)
        h = self.embed_dropout(self.embed_ln(h))
        for layer in self.layers:
            h = layer(h, attn_mask)
        pooled = F.tanh(self.pooler(h[:, 0]))
        return h, pooled


class ErnieForPretraining(nn.Module):
    """The MLM and sentence-order heads (ERNIE's pretraining objective)."""

    def __init__(self, config, device=None, generator=None):
        super().__init__()
        c = self.config = config
        kw = _setup(c, device, generator)
        self.ernie = ErnieModel(c, kw["device"], kw["generator"])
        self.mlm_transform = Linear(c.hidden_size, c.hidden_size, **kw)
        self.mlm_ln = LayerNorm(c.hidden_size, device=kw["device"],
                                dtype=kw["dtype"])
        self.mlm_head = Linear(c.hidden_size, c.vocab_size, **kw)
        self.sop_head = Linear(c.hidden_size, 2, **kw)
        name_parameters(self)

    def _maybe_fused_mlm_ce(self, h_mlm, masked_labels):
        """The mean MLM cross-entropy over the non-ignored tokens through
        the fused kernels, with ``mlm_head``'s bias folded into one more
        block of ``MLM_BIAS_PAD`` columns (see the module's docstring), or
        None where the gate does not apply."""
        if not fused_ce_applies(h_mlm):
            return None
        b, s, hid = h_mlm.shape
        t_len = b * s
        w, bias = self.mlm_head.weight, self.mlm_head.bias
        ones = torch.zeros((t_len, MLM_BIAS_PAD), dtype=h_mlm.dtype,
                           device=h_mlm.device)
        ones[:, 0] = 1.0
        h_aug = torch.cat([h_mlm.reshape(t_len, hid), ones], dim=1)
        w_aug = torch.cat([w, bias[None].to(w.dtype),
                           w.new_zeros((MLM_BIAS_PAD - 1, w.shape[1]))],
                          dim=0)
        return fused_mean_ce(h_aug, w_aug, masked_labels.reshape(t_len))

    def forward_head_loss(self, h, masked_labels):
        """The fused MLM loss over final hidden states ``h``, or None where
        the fused path does not apply (the caller then takes
        ``mlm_head`` and ``cross_entropy``)."""
        return self._maybe_fused_mlm_ce(
            self.mlm_ln(F.gelu(self.mlm_transform(h))), masked_labels)

    def forward(self, input_ids, token_type_ids=None, masked_labels=None,
                sop_labels=None):
        """``(mlm logits [B, S, vocab], sop logits [B, 2])``, or with
        ``masked_labels [B, S]`` (-100 where not masked) the mean MLM
        cross-entropy, plus the SOP cross-entropy when ``sop_labels
        [B]`` are given."""
        h, pooled = self.ernie(input_ids, token_type_ids)
        h_mlm = self.mlm_ln(F.gelu(self.mlm_transform(h)))
        sop = self.sop_head(pooled)
        if masked_labels is None:
            return self.mlm_head(h_mlm), sop
        loss = self._maybe_fused_mlm_ce(h_mlm, masked_labels)
        if loss is None:
            mlm = self.mlm_head(h_mlm)
            loss = F.cross_entropy(mlm.reshape(-1, self.config.vocab_size),
                                   masked_labels.reshape(-1),
                                   ignore_index=-100)
        if sop_labels is not None:
            loss = loss + F.cross_entropy(sop, sop_labels)
        return loss


class ErnieForSequenceClassification(nn.Module):
    def __init__(self, config, num_classes=2, device=None, generator=None):
        super().__init__()
        self.config = config
        kw = _setup(config, device, generator)
        self.ernie = ErnieModel(config, kw["device"], kw["generator"])
        self.classifier = Linear(config.hidden_size, num_classes, **kw)
        self.dropout = Dropout(config.hidden_dropout_prob,
                               generator=kw["generator"])
        name_parameters(self)

    def forward(self, input_ids, token_type_ids=None, labels=None):
        """Logits ``[B, num_classes]``, or with ``labels [B]`` their mean
        cross-entropy."""
        _, pooled = self.ernie(input_ids, token_type_ids)
        logits = self.classifier(self.dropout(pooled))
        if labels is not None:
            return F.cross_entropy(logits, labels)
        return logits
