"""Radix (prefix) cache over the paged KV pool: the port of
paddle_tpu/models/radix_cache.py.

Two requests that share a prompt prefix share the KV blocks that prefix
produced instead of recomputing and re-storing them. The paged pool
(``models/paged_kv.py``) already has what sharing needs (block granularity,
per-block reference counts, copy-on-write); this module adds the content
index on top:

- every full block written at prefill time is registered under a chain
  digest ``H(parent_digest, block_tokens)``: a block's K/V is a function of
  the whole token prefix through that block, so equal chain digests with
  verified tokens mean equal K/V;
- admission walks a new prompt's blocks down the digest chain (the radix
  descent) and maps every hit read-only into the request's block table
  (``PagedKVCache.adopt_blocks``, one reference each);
- the cache holds its own reference on registered blocks
  (``PagedKVCache.retain_blocks``), so a shared prefix outlives the request
  that produced it; under pool pressure the engine evicts entries, leaves
  first, in LRU order;
- digests are verified against the stored tokens on lookup, so a digest
  collision degrades to a miss instead of serving another prompt's K/V.

Everything here is host-side bookkeeping (dicts and reference counts): a
hit costs the device nothing. The digest is the JAX package's, byte for
byte (blake2b, 16 bytes, over the parent digest and the int32 token bytes).

With ``spill=True`` an evicted entry parks its exact K/V bits in host RAM
(``read_blocks``: CPU tensors, bit for bit the pool's) instead of vanishing,
and ``restore_chain`` writes a later match's spilled continuation back into
fresh pool blocks in place (``PagedKVCache.write_block_contents``), so the
pool tensors a captured CUDA graph holds stay the same tensors. The
``radix.digest`` fault point fires where the JAX package fires it.

With the monitor on, the ``paddle_tpu_kv_spilled_blocks`` gauge and
``paddle_tpu_kv_spill_restores_total`` record where the JAX package's do.
"""
from __future__ import annotations

import collections
import hashlib

import numpy as np
import torch

from ..analysis import faultinject as _fi

__all__ = ["PrefixCache"]


_MON = None  # (state, spilled-blocks gauge, spill-restores counter)


def _mon():
    global _MON
    if _MON is None:
        from .. import monitor as _m

        _MON = (_m._state,
                _m.gauge("paddle_tpu_kv_spilled_blocks"),
                _m.counter("paddle_tpu_kv_spill_restores_total"))
    return _MON


def _digest(parent, tokens):
    """Chain digest of one block: parent digest (b"" at the root) + the
    block's token ids. Module-level so tests can monkeypatch it to force
    collisions."""
    h = hashlib.blake2b(parent, digest_size=16)
    h.update(np.asarray(tokens, np.int32).tobytes())
    return h.digest()


class _Entry:
    __slots__ = ("digest", "parent", "tokens", "block")

    def __init__(self, digest, parent, tokens, block):
        self.digest = digest
        self.parent = parent
        self.tokens = tokens    # the block's token ids (collision check)
        self.block = block      # physical block id in the pool


class _SpillEntry:
    """One evicted block parked in host RAM: the chain metadata and the
    block's exact pool leaves per layer (``(k, v)`` or the quantized
    ``(kq, ks, vq, vs)``, CPU tensors)."""

    __slots__ = ("digest", "parent", "tokens", "payload")

    def __init__(self, digest, parent, tokens, payload):
        self.digest = digest
        self.parent = parent
        self.tokens = tokens
        self.payload = payload


class PrefixCache:
    """Content index over one :class:`PagedKVCache` pool."""

    def __init__(self, pager, capacity_blocks=None, spill=False,
                 spill_capacity_blocks=None):
        self._pager = pager
        self.block_size = pager.block_size
        # digest -> _Entry; insertion order is LRU order (move_to_end on use)
        self._entries = collections.OrderedDict()
        self._by_block = {}          # physical block -> digest
        # digest -> number of live child entries chained under it: evict
        # takes leaves first, so chains shed from the tail
        self._nchildren = {}
        # parent digest (b"" at the root) -> [child digests]: the downward
        # edges continue_tokens walks for the speculative drafter
        self._children = {}
        self.capacity = capacity_blocks
        # host-RAM spill store: evicted entries park their exact K/V here, LRU
        # order, and a later prefix match restores them into fresh blocks
        self.spill = bool(spill)
        self.spill_capacity = spill_capacity_blocks
        self._spilled = collections.OrderedDict()   # digest -> _SpillEntry
        self.hits = 0                # lookups that matched >= 1 block
        self.misses = 0
        self.blocks_shared = 0       # blocks mapped into admitted requests
        self.collisions = 0          # digest hits with mismatched tokens
        self.evicted = 0
        self.restores = 0            # spilled blocks restored to the pool

    def __len__(self):
        return len(self._entries)

    # -- lookup ---------------------------------------------------------------
    def match(self, prompt):
        """Longest cached prefix of ``prompt``: (blocks, n_tokens).

        Walks full blocks down the digest chain. A block-aligned prompt may
        match in full; the engine then re-runs only the last token for its
        first-token logits, and that write copies the shared tail block
        (``PagedKVCache.make_positions_exclusive``)."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        bs = self.block_size
        blocks, parent = [], b""
        for i in range(len(prompt) // bs):
            tokens = prompt[i * bs:(i + 1) * bs]
            d = _digest(parent, tokens)
            e = self._entries.get(d)
            # fired only on a non-empty cache, so an nth trigger is never
            # spent on a lookup the corruption cannot touch
            _sp = _fi.fire("radix.digest") if self._entries else None
            if _sp is not None and _sp.action == "flag":
                # drill: the chain hands back a wrong entry (right digest,
                # other content); the token check below must make it a miss
                blk = next(iter(self._entries.values())).block
                e = _Entry(d, parent, (tokens + 1).astype(tokens.dtype), blk)
            if e is None:
                break
            if not np.array_equal(e.tokens, tokens):
                # digest collision: the stored content is not this prefix
                self.collisions += 1
                break
            blocks.append(e.block)
            self._entries.move_to_end(d)
            parent = d
        if blocks:
            self.hits += 1
            self.blocks_shared += len(blocks)
        else:
            self.misses += 1
        return blocks, len(blocks) * bs

    def continue_tokens(self, parent, partial, k):
        """Speculative-draft source (``models/spec_decode.py``): the tokens a
        cached chain stores past the current context. ``parent`` is the
        digest of the context's last full block (``b""`` at the root),
        ``partial`` the context tokens past that boundary. A child block
        whose stored tokens start with ``partial`` proposes its following
        tokens, and the walk goes on down the chain until ``k`` tokens are
        gathered or it runs dry. Read-only and verified by token comparison;
        a miss returns None."""
        partial = np.asarray(partial, np.int32).reshape(-1)
        out = []
        while len(out) < k:
            r = len(partial)
            nxt = None
            for d in reversed(self._children.get(parent, ())):
                e = self._entries.get(d)
                if e is None:
                    continue
                if r < len(e.tokens) and np.array_equal(e.tokens[:r], partial):
                    nxt = e
                    break
            if nxt is None:
                break
            out.extend(nxt.tokens[r:r + (k - len(out))])
            parent = nxt.digest
            partial = partial[:0]
        if not out:
            return None
        return np.asarray(out, np.int32)

    # -- registration ---------------------------------------------------------
    def register(self, prompt, n_tokens_written, table_row):
        """Index every full prompt block of ``table_row`` whose K/V is fully
        written (``n_tokens_written`` tokens so far). Idempotent per digest;
        each newly indexed block is pinned with one cache reference."""
        return self.register_from((0, b""), prompt, n_tokens_written, table_row)[0]

    def register_from(self, cursor, tokens, n_tokens_written, table_row):
        """Incremental :meth:`register`: resume the chain walk at ``cursor =
        (n_blocks_done, parent_digest)``. ``tokens`` holds the sequence from
        the cursor block on (``tokens[0]`` is absolute position
        ``n_blocks_done * block_size``); ``n_tokens_written`` and
        ``table_row`` stay absolute. Returns ``(n_registered, new_cursor)``;
        the cursor is valid only for the same token sequence."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        bs = self.block_size
        done, parent = int(cursor[0]), cursor[1]
        base = done
        n_full = min(base * bs + len(tokens), int(n_tokens_written)) // bs
        registered = 0
        for i in range(done, n_full):
            blk_tokens = tokens[(i - base) * bs:(i - base + 1) * bs]
            d = _digest(parent, blk_tokens)
            e = self._entries.get(d)
            if e is None:
                blk = int(table_row[i])
                if blk <= 0:
                    break   # row shorter than claimed; nothing to index
                if blk in self._by_block:
                    # the row adopted a cached block under another digest
                    # chain (a collision-degraded row): never index it twice
                    parent = d
                    done = i + 1
                    continue
                self._pager.retain_blocks([blk])
                self._entries[d] = _Entry(d, parent, tokens=blk_tokens, block=blk)
                self._by_block[blk] = d
                self._children.setdefault(parent, []).append(d)
                if parent:
                    self._nchildren[parent] = self._nchildren.get(parent, 0) + 1
                registered += 1
            else:
                self._entries.move_to_end(d)
            parent = d
            done = i + 1
        if self.capacity is not None and len(self._entries) > self.capacity:
            self.evict(len(self._entries) - self.capacity)
        return registered, (done, parent)

    # -- eviction -------------------------------------------------------------
    def evict(self, n_blocks, pools=None):
        """Release up to ``n_blocks`` least-recently-used leaf entries whose
        block only the cache references (refs == 1): blocks mapped into live
        requests are never reclaimed, and an entry with live children is
        skipped so chains shed from the tail. With spill on and the live
        ``pools`` passed, each evicted block's exact K/V parks in host RAM
        first. Returns the number of blocks handed back to the pool."""
        freed = 0
        while freed < n_blocks:
            progressed = False
            for d in list(self._entries):
                if freed >= n_blocks:
                    break
                e = self._entries[d]
                if self._nchildren.get(d, 0) > 0 or self._pager._refs[e.block] != 1:
                    continue
                if self.spill and pools is not None:
                    self._spill_entry(e, pools)
                self._drop(e)
                freed += 1
                self.evicted += 1
                progressed = True
            if not progressed:
                break   # everything left is live or an interior node
        return freed

    def _spill_entry(self, e, pools):
        from .paged_kv import read_blocks

        # one tuple of pool leaves a layer, whatever layout the pool carries
        payload = [tuple(leaf[0] for leaf in entry) for entry in read_blocks(pools, [e.block])]
        self._spilled[e.digest] = _SpillEntry(e.digest, e.parent, e.tokens, payload)
        self._spilled.move_to_end(e.digest)
        if self.spill_capacity is not None:
            while len(self._spilled) > self.spill_capacity:
                self._spilled.popitem(last=False)
        mon = _mon()
        if mon[0].on:
            mon[1].set(len(self._spilled))

    def restore_chain(self, prompt, blocks, shared, pools):
        """Continue a :meth:`match` result through the spill store: every
        spilled entry chaining past the pool-resident prefix is written back
        into a freshly taken pool block (its exact K/V, in place) and indexed
        again. Returns the extended ``(blocks, shared_tokens, pools)``;
        unchanged when nothing chains on or the pool lacks the blocks (the
        miss then recomputes, which is always correct)."""
        if not self._spilled:
            return blocks, shared, pools
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        bs = self.block_size
        parent = b""
        for i in range(shared // bs):
            parent = _digest(parent, prompt[i * bs:(i + 1) * bs])
        todo = []
        for i in range(shared // bs, len(prompt) // bs):
            tokens = prompt[i * bs:(i + 1) * bs]
            d = _digest(parent, tokens)
            se = self._spilled.get(d)
            if se is None or d in self._entries or not np.array_equal(se.tokens, tokens):
                break
            todo.append(se)
            parent = d
        if not todo:
            return blocks, shared, pools
        blks = self._pager.take_blocks(len(todo))
        if blks is None:
            return blocks, shared, pools
        contents = [tuple(torch.stack([se.payload[layer][i] for se in todo])
                          for i in range(len(entry0)))
                    for layer, entry0 in enumerate(todo[0].payload)]
        pools = self._pager.write_block_contents(pools, blks, contents)
        for se, blk in zip(todo, blks):
            del self._spilled[se.digest]
            self._entries[se.digest] = _Entry(se.digest, se.parent, se.tokens, blk)
            self._by_block[blk] = se.digest
            self._children.setdefault(se.parent, []).append(se.digest)
            if se.parent:
                self._nchildren[se.parent] = self._nchildren.get(se.parent, 0) + 1
        self.restores += len(todo)
        self.blocks_shared += len(todo)
        if not blocks:
            # match() missed only because the whole chain was in host RAM:
            # the lookup did match cached K/V, so count it as a hit
            self.hits += 1
            self.misses -= 1
        mon = _mon()
        if mon[0].on:
            mon[1].set(len(self._spilled))
            mon[2].inc(len(todo))
        return blocks + blks, shared + len(todo) * bs, pools

    def _drop(self, e):
        del self._entries[e.digest]
        del self._by_block[e.block]
        self._nchildren.pop(e.digest, None)
        if e.parent and e.parent in self._nchildren:
            self._nchildren[e.parent] -= 1
            if self._nchildren[e.parent] <= 0:
                del self._nchildren[e.parent]
        kids = self._children.get(e.parent)
        if kids is not None:
            try:
                kids.remove(e.digest)
            except ValueError:
                pass
            if not kids:
                del self._children[e.parent]
        # the dropped entry's own downward edges stay: digests are content
        # addressed, so a reborn parent reconnects to its cached children
        self._pager.release_blocks([e.block])

    def clear(self):
        """Drop the whole index and the spill store, releasing every cache
        pin (the next pass starts cold)."""
        for e in self._entries.values():
            self._pager.release_blocks([e.block])
        self._entries.clear()
        self._by_block.clear()
        self._nchildren.clear()
        self._children.clear()
        self._spilled.clear()
        mon = _mon()
        if mon[0].on:
            mon[1].set(0)   # no phantom spilled blocks after a clear
