"""Self-speculative drafting for the continuous-batching engine: the port of
paddle_tpu/models/spec_decode.py.

Prompt-lookup (n-gram) speculative decoding: the draft model is the
request's own context. Generated text keeps re-using n-grams of the prompt
and of itself, so the continuation after the latest earlier occurrence of
the context's tail is a cheap draft. No second model and no device work:
the drafter is a host-side suffix index over each request's prompt and
generated tokens.

Two draft sources, tried in order:

1. radix-cache chain tokens: when the context sits on a cached radix chain
   (``models/radix_cache.py``), a child block whose stored tokens extend the
   context proposes what another request with this exact prefix wrote.
   Speculating engines register their decode blocks into the chain too, so
   a repeated prompt drafts its previous run's whole output;
2. the n-gram suffix index: the last ``max_ngram..min_ngram`` tokens of the
   context are looked up among their earlier occurrences (most recent
   first), and the tokens that followed are proposed.

Drafts are verified, never trusted: the serving engine packs them as extra
lanes of the mixed step (``LlamaDecodeEngine.build_mixed_step``) and keeps
the longest agreeing prefix, so greedy outputs are the same with
speculation on or off.
"""
from __future__ import annotations

import numpy as np

from .radix_cache import _digest

__all__ = ["SuffixDrafter"]

_EMPTY = np.zeros(0, np.int32)


class _Ctx:
    """One request's draft state: the token context, its n-gram suffix index
    and the radix-chain cursor (digest of the last full block)."""

    __slots__ = ("tokens", "index", "n_full", "parent")

    def __init__(self):
        self.tokens = []      # python ints (prompt + generated)
        self.index = {}       # (n, gram tuple) -> [end positions], newest last
        self.n_full = 0       # full radix blocks digested so far
        self.parent = b""     # chain digest of the last full block


class SuffixDrafter:
    """Host-side prompt-lookup drafter over per-request suffix indexes.

    ``lookahead`` caps the tokens proposed a call (the engine's
    ``spec_lookahead``); ``max_ngram``/``min_ngram`` bound the match lengths
    tried, longest first; ``prefix_cache`` enables the radix-chain source."""

    def __init__(self, lookahead=8, max_ngram=3, min_ngram=1, prefix_cache=None):
        self.lookahead = int(lookahead)
        self.max_ngram = int(max_ngram)
        self.min_ngram = max(1, int(min_ngram))
        if self.max_ngram < self.min_ngram:
            raise ValueError("max_ngram must be >= min_ngram")
        self.prefix_cache = prefix_cache
        self._reqs = {}       # rid -> _Ctx

    def __len__(self):
        return len(self._reqs)

    # -- lifecycle -----------------------------------------------------------
    def admit(self, rid, prompt):
        """Start tracking a request: index its whole prompt."""
        c = self._reqs[rid] = _Ctx()
        for tok in np.asarray(prompt, np.int32).reshape(-1):
            self._push(c, int(tok))

    def note(self, rid, token):
        """One generated token: extend the context and its index."""
        c = self._reqs.get(rid)
        if c is not None:
            self._push(c, int(token))

    def drop(self, rid):
        self._reqs.pop(rid, None)

    def clear(self):
        self._reqs.clear()

    def _push(self, c, tok):
        c.tokens.append(tok)
        end = len(c.tokens)
        for n in range(self.min_ngram, self.max_ngram + 1):
            if end < n:
                break
            key = (n, tuple(c.tokens[end - n:end]))
            lst = c.index.get(key)
            if lst is None:
                c.index[key] = [end]
            else:
                lst.append(end)
                if len(lst) > 8:      # recent occurrences only
                    del lst[0]
        pc = self.prefix_cache
        if pc is not None:
            bs = pc.block_size
            while (c.n_full + 1) * bs <= end:
                c.parent = _digest(
                    c.parent, np.asarray(c.tokens[c.n_full * bs:(c.n_full + 1) * bs],
                                         np.int32))
                c.n_full += 1

    # -- drafting ------------------------------------------------------------
    def draft(self, rid, k=None):
        """Up to ``k`` (default ``lookahead``) proposed next tokens for
        request ``rid``: an int32 array, possibly empty. A pure lookup: it
        never changes state."""
        k = self.lookahead if k is None else min(int(k), self.lookahead)
        c = self._reqs.get(rid)
        if c is None or k <= 0:
            return _EMPTY
        # source 1: a radix chain another request already wrote
        pc = self.prefix_cache
        if pc is not None:
            t = pc.continue_tokens(c.parent, c.tokens[c.n_full * pc.block_size:], k)
            if t is not None and len(t):
                return t
        # source 2: latest earlier occurrence of the longest matching tail
        end = len(c.tokens)
        for n in range(self.max_ngram, self.min_ngram - 1, -1):
            if end < n:
                continue
            lst = c.index.get((n, tuple(c.tokens[end - n:end])))
            if not lst:
                continue
            for p in reversed(lst):
                if p < end:           # the tail itself indexes at p == end
                    return np.asarray(c.tokens[p:p + k], np.int32)
        return _EMPTY
