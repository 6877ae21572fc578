"""Seq2seq decoding (counterpart of paddle_tpu/nn/decode.py): the
``Decoder`` interface, ``BeamSearchDecoder`` over an RNN cell,
``gather_tree`` and ``dynamic_decode``, the cell-level API that seq2seq
models use (the language models' ``generate`` is
``models/generation.py``). A host loop of eager steps, as the
reference's.

The beam search is the reference's: the cell's states and inputs are
``[batch * beam, ...]``; each step scores ``log_softmax(output_fn(cell
output))`` in float32 plus each beam's score, keeps the best ``beam_size``
of the ``beam * vocab`` candidates, and lets a finished beam continue only
on ``end_token``, at no cost. Candidates of equal score are taken lowest
flat index first, the order of the reference's ``jax.lax.top_k``
(``torch.topk`` promises no order among ties on CUDA, so the port sorts
stably). ``step`` passes the cell nothing but its input and states: a
cell that attends over a memory holds it before the call, tiled to the
beams by ``tile_beam_merge_with_batch``. The states are a flat list of
tensors. ``gather_tree`` runs on the ids' device.
"""
from __future__ import annotations

import torch

__all__ = ["Decoder", "BeamSearchDecoder", "dynamic_decode", "gather_tree"]

_NEG = -1e9


class Decoder:
    """The interface ``dynamic_decode`` drives."""

    def initialize(self, inits):
        raise NotImplementedError

    def step(self, time, inputs, states, **kwargs):
        raise NotImplementedError

    def finalize(self, outputs, final_states, sequence_lengths):
        return outputs, final_states


class BeamSearchDecoder(Decoder):
    def __init__(self, cell, start_token, end_token, beam_size,
                 embedding_fn=None, output_fn=None):
        self.cell = cell
        self.start_token = int(start_token)
        self.end_token = int(end_token)
        self.beam_size = int(beam_size)
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn

    @staticmethod
    def tile_beam_merge_with_batch(x, beam_size):
        """``[batch, ...] -> [batch * beam, ...]``, each row repeated
        ``beam_size`` times in place."""
        return torch.as_tensor(x).repeat_interleave(beam_size, dim=0)

    def _split(self, x):
        return x.reshape((-1, self.beam_size) + tuple(x.shape[1:]))

    def _embed(self, ids):
        return ids if self.embedding_fn is None else self.embedding_fn(ids)

    def initialize(self, inits):
        """``(inputs, states, (scores, finished))`` for ``inits``, the
        cell's states for the batch (a tensor or a flat list)."""
        inits = inits if isinstance(inits, (list, tuple)) else [inits]
        states = [self.tile_beam_merge_with_batch(s, self.beam_size)
                  for s in inits]
        batch = states[0].shape[0] // self.beam_size
        device = states[0].device
        ids = torch.full((batch * self.beam_size,), self.start_token,
                         dtype=torch.long, device=device)
        # beam 0 carries the whole mass at first, so the first step keeps
        # beam_size distinct tokens
        scores = torch.full((batch, self.beam_size), _NEG, device=device)
        scores[:, 0] = 0.0
        finished = torch.zeros(batch, self.beam_size, dtype=torch.bool,
                               device=device)
        return self._embed(ids), states, (scores, finished)

    def step(self, time, inputs, states, beam_state, **kwargs):
        """One step: ``((token, parent) [batch, beam], next inputs,
        states reordered to the kept beams, (scores, finished))``."""
        scores, finished = beam_state
        batch, k = scores.shape
        cell_out, new_states = self.cell(
            inputs, states[0] if len(states) == 1 else states)
        if self.output_fn is not None:
            cell_out = self.output_fn(cell_out)
        logp = torch.log_softmax(cell_out.float(), dim=-1)
        vocab = logp.shape[-1]
        logp = logp.reshape(batch, k, vocab)
        frozen = torch.full((vocab,), _NEG, device=logp.device)
        frozen[self.end_token] = 0.0
        logp = torch.where(finished[:, :, None], frozen, logp)
        cand = (scores[:, :, None] + logp).reshape(batch, k * vocab)
        order = torch.sort(cand, dim=-1, descending=True, stable=True)
        new_scores, idx = order.values[:, :k], order.indices[:, :k]
        parent = torch.div(idx, vocab, rounding_mode="floor")
        token = idx % vocab
        rows = torch.arange(batch, device=idx.device).repeat_interleave(k)
        cols = parent.reshape(-1)
        new_states = (new_states if isinstance(new_states, (list, tuple))
                      else [new_states])
        gathered = [self._split(s)[rows, cols] for s in new_states]
        finished = finished.gather(1, parent) | (token == self.end_token)
        return ((token, parent), self._embed(token.reshape(-1)), gathered,
                (new_scores, finished))


def gather_tree(ids, parents):
    """``ids`` and ``parents`` ``[max_time, batch, beam]``: each final
    beam's tokens, followed back through its parents."""
    ids = torch.as_tensor(ids)
    parents = torch.as_tensor(parents, device=ids.device)
    out = torch.empty_like(ids)
    cur = torch.arange(ids.shape[2], device=ids.device).expand(
        ids.shape[1], -1)
    for t in range(ids.shape[0] - 1, -1, -1):
        out[t] = ids[t].gather(1, cur)
        cur = parents[t].gather(1, cur)
    return out


def dynamic_decode(decoder, inits=None, max_step_num=None, **kwargs):
    """Steps ``decoder`` until every beam has finished or
    ``max_step_num`` steps (100 when None). Returns ``(ids [batch, time,
    beam]`` best first, ``the final states)``."""
    if max_step_num is None:
        max_step_num = 100
    inputs, states, beam_state = decoder.initialize(inits)
    tokens, parents = [], []
    for t in range(int(max_step_num)):
        (token, parent), inputs, states, beam_state = decoder.step(
            t, inputs, states, beam_state, **kwargs)
        tokens.append(token)
        parents.append(parent)
        if bool(beam_state[1].all()):
            break
    ids = gather_tree(torch.stack(tokens), torch.stack(parents))
    return ids.transpose(0, 1), states
