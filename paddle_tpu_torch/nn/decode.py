"""Beam-search decoding: the port of paddle_tpu/nn/decode.py.

``Decoder`` is the step-decoder interface; ``BeamSearchDecoder`` runs a cell
on ``batch * beam`` rows, scores each candidate with the cumulative log
probability and keeps the best ``beam_size`` of ``beam * vocab`` per batch
row; ``dynamic_decode`` steps it on the host until every beam has finished
(one host read a step) or ``max_step_num``, then backtracks the parent
pointers with ``gather_tree``.

The JAX arithmetic, kept here: a step's log probabilities are
``log(clip(softmax(logits), 1e-20))`` in the logits' dtype (not
``log_softmax``); a finished beam extends only with ``end_token``, at zero
cost, and every other token of a finished beam costs -1e9; the scores take
the promoted dtype of the float32 start scores and the logits; at the start
beam 0 has score 0 and the others -1e9; ``lengths`` are int64 and
grow by one a step until the beam finishes. Candidates that tie keep the
lowest flat index first, as ``jax.lax.top_k`` does: the top ``beam_size``
come from a stable descending sort.
"""
from __future__ import annotations

from collections import namedtuple

import torch

from .functional.extras import gather_tree

__all__ = ["Decoder", "BeamSearchDecoder", "dynamic_decode"]

BeamSearchState = namedtuple(
    "BeamSearchState", ["cell_states", "log_probs", "finished", "lengths"])
BeamSearchOutput = namedtuple(
    "BeamSearchOutput", ["scores", "predicted_ids", "parent_ids"])


class Decoder:
    """Abstract step-decoder interface (decode.py Decoder)."""

    def initialize(self, inits):
        raise NotImplementedError

    def step(self, time, inputs, states, **kwargs):
        raise NotImplementedError

    def finalize(self, outputs, final_states, sequence_lengths):
        raise NotImplementedError

    @property
    def tracks_own_finished(self):
        return False


def _tile_beam(x, beam_size):
    """Each row of ``x`` repeated ``beam_size`` times, consecutively."""
    return torch.as_tensor(x).repeat_interleave(beam_size, dim=0)


def _top_k_lowest_index_first(flat, k):
    """``jax.lax.top_k``'s order: the ``k`` largest per row, ties lowest
    index first."""
    scores, idx = torch.sort(flat, dim=1, descending=True, stable=True)
    return scores[:, :k], idx[:, :k]


class BeamSearchDecoder(Decoder):
    """decode.py BeamSearchDecoder: beam-expanded cell decoding scored by the
    cumulative log probability (no length penalty)."""

    def __init__(self, cell, start_token, end_token, beam_size, embedding_fn=None,
                 output_fn=None):
        self.cell = cell
        self.start_token = int(start_token)
        self.end_token = int(end_token)
        self.beam_size = int(beam_size)
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn

    @staticmethod
    def tile_beam_merge_with_batch(x, beam_size):
        return _tile_beam(x, beam_size)

    def initialize(self, initial_cell_states):
        states = initial_cell_states
        if not isinstance(states, (tuple, list)):
            states = (states,)
        self._batch = int(states[0].shape[0])
        B, K = self._batch, self.beam_size
        dev = states[0].device
        cell_states = tuple(_tile_beam(s, K) for s in states)
        # only beam 0 is live at t=0 (all beams hold identical states)
        log_probs = torch.tensor([0.0] + [-1e9] * (K - 1), dtype=torch.float32,
                                 device=dev).repeat(B, 1)
        init = BeamSearchState(cell_states=cell_states, log_probs=log_probs,
                               finished=torch.zeros(B, K, dtype=torch.bool, device=dev),
                               lengths=torch.zeros(B, K, dtype=torch.int64, device=dev))
        start = torch.full((B * K,), self.start_token, dtype=torch.int64, device=dev)
        return start, init, init.finished

    def step(self, time, inputs, states, **kwargs):
        B, K = self._batch, self.beam_size
        emb = self.embedding_fn(inputs) if self.embedding_fn else inputs
        cell_states = (states.cell_states if len(states.cell_states) > 1
                       else states.cell_states[0])
        cell_out, next_cell_states = self.cell(emb, cell_states)
        if not isinstance(next_cell_states, (tuple, list)):
            next_cell_states = (next_cell_states,)
        logits = self.output_fn(cell_out) if self.output_fn else cell_out
        V = int(logits.shape[-1])
        e = torch.exp(logits - logits.amax(-1, keepdim=True))
        logp = torch.log(torch.clamp(e / e.sum(-1, keepdim=True), min=1e-20)).reshape(B, K, V)
        # finished beams only extend with end_token at zero cost
        end_only = torch.full((V,), -1e9, dtype=logp.dtype, device=logp.device)
        end_only[self.end_token] = 0.0
        logp = torch.where(states.finished[..., None], end_only, logp)
        total = states.log_probs[..., None] + logp                  # (B, K, V)
        top_scores, top_idx = _top_k_lowest_index_first(total.reshape(B, K * V), K)
        parent = top_idx // V                                      # beam index
        token = top_idx % V
        prev_fin = torch.gather(states.finished, 1, parent)
        new_finished = prev_fin | (token == self.end_token)
        new_lengths = torch.gather(states.lengths, 1, parent) + (~prev_fin).long()
        # gather the cell states along the chosen parents
        flat_parent = (torch.arange(B, device=parent.device)[:, None] * K + parent).reshape(-1)
        new_cell_states = tuple(s[flat_parent] for s in next_cell_states)
        next_state = BeamSearchState(new_cell_states, top_scores, new_finished, new_lengths)
        out = BeamSearchOutput(scores=top_scores, predicted_ids=token, parent_ids=parent)
        return out, next_state, token.reshape(-1), new_finished

    def finalize(self, outputs, final_states, sequence_lengths):
        # outputs.*: (T, B, K) stacked; backtrack the beam pointers
        return gather_tree(outputs.predicted_ids, outputs.parent_ids), final_states

    @property
    def tracks_own_finished(self):
        return True


def dynamic_decode(decoder, inits=None, max_step_num=100, output_time_major=False,
                   impute_finished=False, is_test=False, return_length=False, **kwargs):
    """decode.py dynamic_decode: ``decoder.step`` until every sequence has
    finished or ``max_step_num`` steps; ids ``(B, T, K)``, or ``(T, B, K)``
    when ``output_time_major``. ``impute_finished`` and ``is_test`` are
    ignored, as in the JAX package."""
    inputs, states, finished = decoder.initialize(inits)
    step_outputs = []
    for t in range(int(max_step_num)):
        out, states, inputs, finished = decoder.step(t, inputs, states, **kwargs)
        step_outputs.append(out)
        if bool(finished.all()):
            break
    stacked = type(step_outputs[0])(*[torch.stack([getattr(o, f) for o in step_outputs])
                                      for f in step_outputs[0]._fields])
    preds, final_states = decoder.finalize(stacked, states, states.lengths)
    if not output_time_major:
        preds = preds.transpose(0, 1)
    if return_length:
        return preds, final_states, states.lengths
    return preds, final_states
