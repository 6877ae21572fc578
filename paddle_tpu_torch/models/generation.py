"""Autoregressive generation on a static decode cache (counterpart of
paddle_tpu/models/generation.py).

- ``DecodeCache``: one layer's preallocated ``[B, L_max, H_kv, D]`` K/V
  buffers in the model's dtype on its device. ``cache_update`` writes a
  step's K/V into them in place at the position head and returns the
  full buffers (the serving engine's paged views write their pools in
  place too).
- ``GenerationMixin.generate``: one prefill over the whole prompt (offset
  0: start-aligned causal attention against the preallocated buffers,
  which is the flash kernel), then a host loop of one-token decode steps
  through SDPA's mask path. With ``eos_token_id`` the loop reads one bool
  a step (every row done?) and stops early; without it, none.

The reference compiles the whole loop (``_jit_cached``, a JAX compile
cache keyed on the call's static arguments). Eager PyTorch compiles
nothing, so there is no counterpart: each call runs its steps as they
come.

A model opts in by providing:
  generate_step(input_ids, caches, position_offset) -> logits [B, S, V]
      (the caches are written in place; the reference also returns them)
  init_decode_caches(batch, total_len) -> list[DecodeCache]
  max_decode_len() -> int or None
  device (property)
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..nn import functional as F

# the beam search's "impossible" log-probability (the reference's NEG)
NEG = -1e9


class DecodeCache(NamedTuple):
    """[B, L_max, H_kv, D] static KV buffers for one layer."""

    k: torch.Tensor
    v: torch.Tensor


def cache_update(cache, k, v, position_offset):
    """Write the ``s`` new K/V rows ``[B, s, H_kv, D]`` into ``cache`` in
    place at ``position_offset`` (an int) and return the full buffers
    ``(k_full, v_full)``."""
    off, s = int(position_offset), k.shape[1]
    if off < 0 or off + s > cache.k.shape[1]:
        raise ValueError("cache_update: rows %d..%d past the cache's %d"
                         % (off, off + s - 1, cache.k.shape[1]))
    cache.k[:, off:off + s] = k.to(cache.k.dtype)
    cache.v[:, off:off + s] = v.to(cache.v.dtype)
    return cache.k, cache.v


def decode_mask(position_offset, s, kv_len, device=None):
    """The valid-region causal mask of a cached step, ``[s, kv_len]`` bool
    (key j visible to query i when ``j <= position_offset + i``), or the
    string "causal" when it reduces to start-aligned causality (the
    prefill at the int offset 0: the flash kernel then stays the path)."""
    if isinstance(position_offset, int) and position_offset == 0:
        return "causal"
    kv_pos = torch.arange(kv_len, device=device)
    q_pos = int(position_offset) + torch.arange(s, device=device)
    return kv_pos[None, :] <= q_pos[:, None]


def masked_decode_attention(q, k, v, mask):
    """Attention for ``decode_mask``'s result."""
    if isinstance(mask, str):   # "causal"
        # prefill at offset 0 against a preallocated cache: start-aligned
        # is exactly right (the unwritten tail is never visible)
        return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                              _warn_rect_causal=False)
    return F.scaled_dot_product_attention(q, k, v, attn_mask=mask[None, None],
                                          is_causal=False)


def sample_filter(logits, top_k=0, top_p=1.0):
    """The reference's sampling filter over float32 ``[B, V]`` logits
    (already divided by the temperature): with ``top_k``, every logit
    below the k-th largest becomes -inf (ties at the k-th value stay);
    with ``top_p < 1``, every logit below the cutoff does, the cutoff
    being the last logit of the smallest descending prefix whose softmax
    mass reaches ``top_p``."""
    if top_k:
        kth = torch.sort(logits, dim=-1).values[:, -top_k][:, None]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if top_p < 1.0:
        sorted_l = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_l, dim=-1), dim=-1)
        # the reference's gather past the end keeps every logit; so does
        # the last one
        cutoff_idx = (cum < top_p).sum(dim=-1).clamp(max=logits.shape[-1] - 1)
        cutoff = sorted_l.gather(-1, cutoff_idx[:, None])
        logits = logits.masked_fill(logits < cutoff, float("-inf"))
    return logits


class GenerationMixin:
    def max_decode_len(self):
        """Maximum total sequence length (prompt + generated), or None
        when unbounded. Models override."""
        return None

    def _coerce_prompt(self, input_ids, max_new_tokens):
        """-> (ids int64 ``[b, prompt_len]`` on the model's device, b,
        prompt_len, total); validates against ``max_decode_len`` (a
        position past a learned table would index out of it, and rope
        would extrapolate silently)."""
        ids = torch.as_tensor(input_ids).to(self.device, torch.long)
        b, prompt_len = ids.shape
        total = prompt_len + max_new_tokens
        limit = self.max_decode_len()
        if limit is not None and total > limit:
            raise ValueError(
                "generate: prompt_len (%d) + max_new_tokens (%d) exceeds "
                "the model's maximum sequence length (%d)"
                % (prompt_len, max_new_tokens, limit))
        return ids, b, prompt_len, total

    def _run_eval(self, fn, *args):
        """Run ``fn`` in inference semantics: eval mode (dropout off) and
        ``torch.no_grad()``, the training flag restored after."""
        was_training = self.training
        self.eval()
        try:
            with torch.no_grad():
                return fn(*args)
        finally:
            if was_training:
                self.train()

    def _last_logits(self, ids, caches, offset):
        """The last position's logits of one step ``[B, V]``."""
        return self.generate_step(ids, caches, offset)[:, -1, :]

    def generate(self, input_ids, max_new_tokens=32, do_sample=False,
                 top_k=0, top_p=1.0, temperature=1.0, eos_token_id=None,
                 seed=0, num_beams=1, length_penalty=0.0):
        """Autoregressive generation. Returns the generated ids
        ``[B, max_new_tokens]`` (int64, prompt excluded) on the model's
        device; positions after a sequence's eos are padded with eos.

        Greedy by default; ``do_sample`` samples from the softmax of the
        logits over ``temperature`` after ``sample_filter`` (``top_k``,
        ``top_p``), drawing from a ``torch.Generator`` on the model's
        device seeded with ``seed``: the same seed gives the same tokens,
        but not the reference's (JAX's random stream is not reproduced).

        ``num_beams > 1`` switches to beam search (``_beam_search``).
        ``length_penalty`` is the GNMT exponent alpha (score / len^alpha)
        applied at the final beam selection."""
        if num_beams > 1:
            if do_sample:
                raise ValueError(
                    "beam search is deterministic; do_sample=True "
                    "conflicts with num_beams > 1")
            return self._beam_search(input_ids, max_new_tokens, num_beams,
                                     eos_token_id, length_penalty,
                                     temperature)
        ids, b, prompt_len, total = self._coerce_prompt(input_ids,
                                                        max_new_tokens)
        gen = None
        if do_sample:
            gen = torch.Generator(device=self.device).manual_seed(seed)

        def sample(logits):
            logits = logits.float() / max(temperature, 1e-6)
            if not do_sample:
                return logits.argmax(dim=-1)
            probs = torch.softmax(sample_filter(logits, top_k, top_p), -1)
            return torch.multinomial(probs, 1, generator=gen)[:, 0]

        def run():
            caches = self.init_decode_caches(b, total)
            # prefill the whole prompt in one pass
            tok = sample(self._last_logits(ids, caches, 0))
            fill = eos_token_id if eos_token_id is not None else 0
            out = torch.full((b, max_new_tokens), fill, dtype=torch.long,
                             device=self.device)
            out[:, :1] = tok[:, None]
            done = (tok == eos_token_id) if eos_token_id is not None \
                else None
            for i in range(1, max_new_tokens):
                if done is not None and bool(done.all()):
                    break
                nxt = sample(self._last_logits(tok[:, None], caches,
                                               prompt_len + i - 1))
                if done is not None:
                    nxt = torch.where(done, eos_token_id, nxt)
                    done = done | (nxt == eos_token_id)
                out[:, i] = nxt
                tok = nxt
            return out

        return self._run_eval(run)

    def _beam_search(self, input_ids, max_new_tokens, num_beams,
                     eos_token_id, length_penalty, temperature):
        """Beams live as an expanded batch of ``b * K`` rows. The prompt is
        prefilled once at batch b and the caches fanned out; the first
        step takes K distinct tokens from beam 0 (the others are masked:
        all beams are still equal); each later step takes the top K
        continuations over (beams x vocab) cumulative log-probs, with
        finished beams frozen on eos at zero cost, and reorders the
        caches to the winning beams (``index_select`` into new buffers,
        never an in-place gather over its own source)."""
        ids, b, prompt_len, total = self._coerce_prompt(input_ids,
                                                        max_new_tokens)
        K = num_beams
        dev = self.device
        temp = max(temperature, 1e-6)

        def run():
            caches = self.init_decode_caches(b, total)
            last = self._last_logits(ids, caches, 0).float()
            caches[:] = [DecodeCache(c.k.repeat_interleave(K, dim=0),
                                     c.v.repeat_interleave(K, dim=0))
                         for c in caches]
            last = last.repeat_interleave(K, dim=0)           # [b*K, V]
            logp = torch.log_softmax(last / temp, dim=-1)
            vocab = logp.shape[-1]
            beam_mask = torch.where(
                torch.arange(b * K, device=dev) % K == 0, 0.0, NEG)[:, None]
            scores, top_i = (logp + beam_mask).reshape(b, K * vocab).topk(K)
            tok = top_i % vocab                               # [b, K]
            fill = eos_token_id if eos_token_id is not None else 0
            out = torch.full((b, K, max_new_tokens), fill, dtype=torch.long,
                             device=dev)
            out[:, :, :1] = tok[:, :, None]
            done = ((tok == eos_token_id) if eos_token_id is not None
                    else torch.zeros((b, K), dtype=torch.bool, device=dev))
            frozen = None
            if eos_token_id is not None:
                frozen = torch.full((vocab,), NEG, device=dev)
                frozen[eos_token_id] = 0.0
            rows = torch.arange(b, device=dev)[:, None] * K
            i = 1
            while i < max_new_tokens and not bool(done.all()):
                last = self._last_logits(tok.reshape(b * K, 1), caches,
                                         prompt_len + i - 1).float()
                logp = torch.log_softmax(last / temp, dim=-1)
                logp = logp.reshape(b, K, vocab)
                if frozen is not None:
                    # finished beams: only eos continues, at zero cost
                    logp = torch.where(done[:, :, None], frozen, logp)
                cand = (scores[:, :, None] + logp).reshape(b, K * vocab)
                scores, idx = cand.topk(K)                    # [b, K]
                src = idx // vocab
                tok = idx % vocab
                flat_src = (rows + src).reshape(-1)           # [b*K]
                caches[:] = [DecodeCache(c.k.index_select(0, flat_src),
                                         c.v.index_select(0, flat_src))
                             for c in caches]
                out = out.gather(1, src[:, :, None].expand_as(out))
                done = done.gather(1, src)
                if eos_token_id is not None:
                    done = done | (tok == eos_token_id)
                out[:, :, i] = tok
                i += 1
            # GNMT length normalization at the final selection
            if length_penalty:
                eos = eos_token_id if eos_token_id is not None else -1
                first_eos = (out == eos).int().argmax(dim=-1) + 1
                lengths = torch.where(done, first_eos, i).float().clamp(
                    min=1.0)
                norm = scores / lengths ** length_penalty
            else:
                norm = scores
            best = norm.argmax(dim=1)                         # [b]
            return out[torch.arange(b, device=dev), best]

        return self._run_eval(run)
