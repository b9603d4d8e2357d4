"""Paged KV cache: the port of paddle_tpu/models/paged_kv.py.

The KV cache is a pool of fixed-size blocks per layer, ``[num_blocks,
block_size, kv_heads, head_dim]`` tensors on the device, and every sequence
owns a list of block ids, its block table. Blocks are granted on the host as
a sequence grows, so a batch of short sequences does not reserve max_len
each, and finished sequences return their blocks. Attention gathers a
sequence's blocks through its table in plain torch, as the JAX package does
in XLA: the indexed reads are the indirection, and no kernel is hand-written
for them.

What differs from the JAX package:

- Pools are written in place (``index_put_``, ``index_copy_``). The JAX
  functions donate the pools and return new ones; the port's return the same
  tensors, so every caller's reference stays live, and
  ``CowPoolExhausted.pools`` holds the pools it was handed.
- torch has no ``mode="drop"`` scatter. A padding row (a prompt position at
  or past its sequence's length, a lane whose ``valid`` is False) writes
  nothing here either, without a host sync: it repeats the first valid
  row's write (the same value to the same slot), or, when no row is valid,
  writes its own slot's current value back (``_write_plan``).
- The block tables are one persistent int32 device tensor,
  ``block_tables``, overwritten in place from the host mirror only when a
  grant, a free, an adoption, a fork or a copy-on-write changed it; gathers
  index with it directly, and a captured CUDA graph that reads it keeps
  reading the current tables.
- ``read_blocks`` returns host (CPU) tensors: numpy has no bfloat16.
- The fault-injection points ``paged_kv.ensure`` and ``paged_kv.cow`` fire,
  and the monitor's ``paddle_tpu_kv_free_blocks`` gauge,
  ``paddle_tpu_kv_cow_copies_total`` and ``paddle_tpu_kv_pool_exhausted_total``
  record, where the JAX package's do (host counts only).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .. import monitor as _monitor
from .. import resolve_device
from ..analysis import faultinject as _fi
from ..analysis import sanitizers as _sanitizers

__all__ = ["PagedKVCache", "CowPoolExhausted", "alloc_blocks",
           "read_blocks",
           "paged_write_decode", "paged_write_prefill", "paged_write_mixed",
           "paged_attention_decode", "paged_write_decode_int8",
           "paged_write_prefill_int8", "paged_write_mixed_int8",
           "paged_attention_decode_int8"]


_MON = None  # (state, free-blocks gauge, CoW counter, exhaustion counter)


def _mon():
    global _MON
    if _MON is None:
        _MON = (_monitor._state,
                _monitor.gauge("paddle_tpu_kv_free_blocks"),
                _monitor.counter("paddle_tpu_kv_cow_copies_total"),
                _monitor.counter("paddle_tpu_kv_pool_exhausted_total"))
    return _MON


class CowPoolExhausted(RuntimeError):
    """Copy-on-write ran out of free blocks. Copies that were already
    remapped before the pool ran dry are applied (their table rows point at
    initialized private blocks), and ``.pools`` holds the pools, written in
    place, so a caller may reclaim blocks and retry."""

    def __init__(self, msg, pools):
        super().__init__(msg)
        self.pools = pools


class PagedKVCache:
    """Host-side block allocator and the device block pools for one layer
    set. Block grants and frees are host control flow (a free list and
    per-block reference counts over a numpy mirror of the tables); the pools
    and the int32 tables live on ``device``."""

    def __init__(self, num_layers, num_blocks, block_size, kv_heads, head_dim,
                 batch, max_blocks_per_seq, dtype=torch.bfloat16,
                 quantized=False, device=None):
        self.device = resolve_device(device)
        self.block_size = int(block_size)
        self.num_blocks = int(num_blocks)
        self.max_blocks_per_seq = int(max_blocks_per_seq)
        self.quantized = bool(quantized)
        shape = (num_blocks, block_size, kv_heads, head_dim)

        def zeros(shp, dt):
            return [torch.zeros(shp, dtype=dt, device=self.device)
                    for _ in range(num_layers)]

        if quantized:
            # int8 blocks + per-(token, head) fp32 absmax scales
            self.k, self.v = zeros(shape, torch.int8), zeros(shape, torch.int8)
            self.k_scale = zeros(shape[:-1], torch.float32)
            self.v_scale = zeros(shape[:-1], torch.float32)
        else:
            self.k, self.v = zeros(shape, dtype), zeros(shape, dtype)
        # block 0 is the permanently reserved null block: unassigned table
        # slots point at it, so gathers stay in bounds without masking reads
        self._free = list(range(num_blocks - 1, 0, -1))
        self.batch = int(batch)
        self._tables_np = np.zeros((batch, max_blocks_per_seq), np.int32)
        self.block_tables = torch.zeros((batch, max_blocks_per_seq), dtype=torch.int32,
                                        device=self.device)
        # per-block reference counts: > 1 after fork_rows (beam search shares
        # prompt blocks); writes go copy-on-write via make_tail_exclusive
        self._refs = np.zeros(num_blocks, np.int32)

    def reset(self):
        """The state a new pager starts in, in the same tensors (the decode
        engine's captured programs are bound to them): every block free in
        the constructor's order, no references, tables and pools zeroed."""
        self._free = list(range(self.num_blocks - 1, 0, -1))
        self._tables_np[:] = 0
        self._refs[:] = 0
        pools = self.k + self.v + (self.k_scale + self.v_scale if self.quantized else [])
        with torch.inference_mode():
            for t in pools:
                t.zero_()
        self._upload()

    def _upload(self):
        """Overwrite the device tables in place from the host mirror. The
        copy is taken from a private snapshot and is blocking, so the mirror
        may change right after; ``inference_mode`` lets it update tables
        made under inference mode too."""
        with torch.inference_mode():
            self.block_tables.copy_(torch.from_numpy(self._tables_np.copy()))

    # -- host-side allocator -------------------------------------------------
    def ensure_capacity(self, seq_lens_next):
        """Grant blocks so every sequence can hold seq_lens_next[b] tokens.

        The device tables are uploaded again only when a grant happened: most
        decode steps grant nothing (blocks change once per block_size
        tokens). On exhaustion, the grants already made to earlier rows are
        uploaded before the error, so the device tables match the mirror."""
        _sp = _fi.fire("paged_kv.ensure")
        if _sp is not None and _sp.action == "flag":
            # drill: the allocator's exhaustion error without touching the
            # free list; the engine's eviction relief or preemption must
            # absorb it
            raise RuntimeError(
                "paged KV pool exhausted: no free blocks (injected fault; "
                f"pool={self.num_blocks}, block={self.block_size})")
        tables = self._tables_np
        owned = (tables > 0).sum(axis=1)
        need_arr = np.asarray(seq_lens_next)
        needed = -(-np.maximum(need_arr.astype(np.int64), 0) // self.block_size)
        mon = _mon()
        if (needed <= owned).all():
            if mon[0].on:
                mon[1].set(len(self._free))
            return
        changed = False
        for b, need_tok in enumerate(need_arr):
            need = int(-(-int(need_tok) // self.block_size))  # ceil
            while owned[b] < need:
                if not self._free:
                    if mon[0].on:
                        mon[3].inc()
                    if changed:
                        self._upload()
                    raise RuntimeError(
                        "paged KV pool exhausted: no free blocks "
                        f"(pool={self.num_blocks}, block={self.block_size})")
                blk = self._free.pop()
                tables[b, owned[b]] = blk
                self._refs[blk] = 1
                owned[b] += 1
                changed = True
        if mon[0].on:
            mon[1].set(len(self._free))
        if changed:
            self._upload()

    def free_sequence(self, b):
        """Drop sequence b's block references; blocks return to the pool
        when their last referencing row lets go."""
        tables = self._tables_np
        for blk in tables[b]:
            if blk > 0:
                self._refs[blk] -= 1
                if self._refs[blk] == 0:
                    self._free.append(int(blk))
        tables[b] = 0
        self._upload()
        self._gauge()

    def _gauge(self):
        mon = _mon()
        if mon[0].on:
            mon[1].set(len(self._free))

    # -- external references (radix/prefix cache) ----------------------------
    def retain_blocks(self, blocks):
        """Take one extra reference on each block (the prefix cache's pin):
        a retained block survives :meth:`free_sequence` of its owner and
        returns to the pool only when released."""
        for blk in blocks:
            blk = int(blk)
            if not 0 < blk < self.num_blocks:
                raise ValueError(f"block {blk} out of range")
            if self._refs[blk] <= 0:
                raise ValueError(f"block {blk} is free; cannot retain")
            self._refs[blk] += 1

    def release_blocks(self, blocks):
        """Drop one reference per block (undo of retain_blocks); blocks whose
        last reference goes return to the free pool. Returns how many did."""
        freed = 0
        for blk in blocks:
            blk = int(blk)
            self._refs[blk] -= 1
            if self._refs[blk] == 0:
                self._free.append(blk)
                freed += 1
        self._gauge()
        return freed

    def adopt_blocks(self, b, blocks):
        """Map shared ``blocks`` into the head of row b's block table (one
        new reference each): row b's first ``len(blocks) * block_size``
        positions read the shared KV. Row b must hold no blocks yet."""
        tables = self._tables_np
        if (tables[b] > 0).any():
            raise ValueError(f"row {b} already holds blocks")
        if len(blocks) > self.max_blocks_per_seq:
            raise ValueError("shared prefix longer than max_blocks_per_seq")
        for i, blk in enumerate(blocks):
            blk = int(blk)
            if self._refs[blk] <= 0:
                raise ValueError(f"block {blk} is free; cannot adopt")
            tables[b, i] = blk
            self._refs[blk] += 1
        self._upload()

    # -- host-RAM spill/restore ----------------------------------------------
    def take_blocks(self, n):
        """Pop ``n`` free blocks for a restore, each with one reference (the
        restorer owns it). Returns None, taking nothing, when the pool has
        fewer than ``n`` free blocks."""
        n = int(n)
        if n <= 0 or len(self._free) < n:
            return None
        blks = [self._free.pop() for _ in range(n)]
        for blk in blks:
            self._refs[blk] = 1
        self._gauge()
        return blks

    def place_blocks(self, b, blocks):
        """Map ``blocks`` (owned by the caller via :meth:`take_blocks`) into
        the head of empty row ``b``: the restore path of a preempted request,
        whose spilled KV goes back into these blocks at the same offsets."""
        tables = self._tables_np
        if (tables[b] > 0).any():
            raise ValueError(f"row {b} already holds blocks")
        if len(blocks) > self.max_blocks_per_seq:
            raise ValueError("restore longer than max_blocks_per_seq")
        for i, blk in enumerate(blocks):
            tables[b, i] = int(blk)
        self._upload()

    def write_block_contents(self, pools, blocks, contents):
        """Upload host block contents into pool ``blocks``, in place:
        ``contents`` is a per-layer list of pool-leaf tuples (``(k, v)``, or
        ``(kq, ks, vq, vs)`` for the quantized layout), each a numpy array
        or host tensor shaped ``[n, block_size, ...]``. Returns ``pools``."""
        if len(blocks) == 0:
            return pools
        idx = torch.tensor(np.asarray(blocks, np.int64), device=self.device)
        for entry, leaves in zip(pools, contents):
            for pool, arr in zip(entry, leaves):
                pool.index_copy_(0, idx, torch.as_tensor(arr).to(pool.device, pool.dtype))
        return pools

    # -- copy-on-write -------------------------------------------------------
    def _cow_apply(self, pools, pairs):
        """Copy block ``old`` into block ``new`` for every pair, in every
        tensor of ``pools`` (any nesting of lists and tuples, as the JAX
        package's tree_map takes; each leaf is block-major on axis 0)."""
        olds = torch.tensor([o for o, _ in pairs], dtype=torch.int64, device=self.device)
        news = torch.tensor([w for _, w in pairs], dtype=torch.int64, device=self.device)
        for leaf in _leaves(pools):
            leaf.index_copy_(0, news, leaf.index_select(0, olds))
        return pools

    def _make_exclusive(self, rows, bidxs, pools):
        """Give every (row, block index) whose block is shared a private copy;
        on exhaustion, apply the copies already remapped, then raise."""
        mon = _mon()
        t = self._tables_np
        pairs = []
        exhausted = False
        for b, bidx in zip(rows, bidxs):
            b, bidx = int(b), int(bidx)
            phys = int(t[b, bidx])
            if phys > 0 and self._refs[phys] > 1:
                if not self._free:
                    if mon[0].on:
                        mon[3].inc()
                    # apply-then-raise: the rows remapped so far look
                    # unshared now, so they must get their data copy
                    exhausted = True
                    break
                new = self._free.pop()
                self._refs[new] = 1
                self._refs[phys] -= 1
                t[b, bidx] = new
                pairs.append((phys, new))
        if pairs:
            if mon[0].on:
                mon[2].inc(len(pairs))
                mon[1].set(len(self._free))
            pools = self._cow_apply(pools, pairs)
            self._upload()
        if exhausted:
            raise CowPoolExhausted(
                "paged KV pool exhausted during copy-on-write "
                f"(pool={self.num_blocks})", pools)
        return pools

    def make_positions_exclusive(self, rows, positions, pools):
        """Copy-on-write for the mixed serving step: before row ``rows[i]``
        writes at ``positions[i]``, a targeted block that is shared (refs >
        1: prefix-cache hits, beam forks) is replaced by a private copy.
        Unshared pools take the cheap early exit."""
        _sp = _fi.fire("paged_kv.cow")
        if _sp is not None and _sp.action == "flag":
            # drill: a real CowPoolExhausted carrying the live pools, raised
            # before any copy
            raise CowPoolExhausted(
                "paged KV pool exhausted during copy-on-write (injected fault; "
                f"pool={self.num_blocks})", pools)
        if (self._refs <= 1).all():
            return pools
        t = self._tables_np
        rows = np.asarray(rows, np.int64)
        bidxs = np.asarray(positions, np.int64) // self.block_size
        targets = t[rows, bidxs]
        hot = np.flatnonzero((targets > 0) & (self._refs[targets] > 1))
        return self._make_exclusive(rows[hot], bidxs[hot], pools)

    def fork_rows(self, parent_rows):
        """Every row adopts parent_rows[b]'s block table (shared blocks,
        refcounted): the paged form of the dense cache's beam reorder.
        Writes afterwards must go through make_tail_exclusive."""
        parent_rows = np.asarray(parent_rows, np.int64)
        t = self._tables_np
        new = t[parent_rows].copy()
        if np.array_equal(new, t):
            return   # identity fork (EOS-frozen beams): nothing changes
        self._refs -= np.bincount(t[t > 0].ravel(),
                                  minlength=self.num_blocks).astype(np.int32)
        self._refs += np.bincount(new[new > 0].ravel(),
                                  minlength=self.num_blocks).astype(np.int32)
        # blocks nobody references anymore go back to the pool
        for blk in np.unique(t[t > 0]):
            if self._refs[blk] == 0:
                self._free.append(int(blk))
        self._tables_np = new
        self._upload()
        self._gauge()

    def make_tail_exclusive(self, pos, pools):
        """Copy-on-write: before writing at position ``pos``, every row whose
        tail block (pos // block_size) is shared gets its own copy of it.
        No-op when nothing is shared, which is plain decoding's case."""
        if (self._refs <= 1).all():
            return pools
        bidx = int(pos) // self.block_size
        rows = range(len(self._tables_np))
        return self._make_exclusive(rows, [bidx] * len(rows), pools)


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    else:
        for sub in tree:
            yield from _leaves(sub)


def alloc_blocks(batch, max_len, block_size):
    """Blocks per sequence for a max_len budget."""
    return -(-max_len // block_size)


def read_blocks(pools, blocks):
    """Download pool ``blocks`` to host RAM (the spill read): a per-layer list
    of pool-leaf tuples of CPU tensors ``[n, block_size, ...]``, ``(k, v)``
    or the quantized ``(kq, ks, vq, vs)``, bit for bit the pool's. The copy
    to the host is the spill's purpose, so it is a sanctioned read for the
    host-sync tripwire (the JAX package reads the blocks with a raw
    ``np.asarray`` its tripwire does not see)."""
    out = []
    with _sanitizers.allow_host_sync():
        for entry in pools:
            idx = torch.tensor(np.asarray(blocks, np.int64), device=entry[0].device)
            out.append(tuple(leaf.index_select(0, idx).cpu() for leaf in entry))
    return out


def _decode_scatter_idx(block_tables, seq_lens, bs):
    """(phys block, in-block offset) for writing one token at seq_lens[b]."""
    pos = seq_lens.long()
    rows = torch.arange(block_tables.shape[0], device=block_tables.device)
    return block_tables[rows, pos // bs].long(), pos % bs


def _write_plan(phys, off, valid=None):
    """The slots a write of one row per (phys, off) touches, and the row whose
    value each slot gets, with no host sync: a row whose ``valid`` is False
    repeats the first valid row's write (the same value to the same slot),
    or, when no row is valid, writes its own slot's current value back, so
    it changes nothing. ``valid=None`` writes every row."""
    if valid is None:
        return phys, off, None, None
    lane = torch.arange(valid.shape[0], device=valid.device)
    any_valid = valid.any()
    src = torch.where(valid, lane, torch.argmax(valid.to(torch.int32)))
    src = torch.where(any_valid, src, lane)
    return phys[src], off[src], src, any_valid


def _put(pool, plan, new):
    """``pool[phys, off] = new`` in place, row by row as ``plan`` says."""
    phys, off, src, any_valid = plan
    new = new.to(pool.dtype)
    if src is not None:
        new = torch.where(any_valid, new[src], pool[phys, off])
    pool.index_put_((phys, off), new)
    return pool


def _decode_plan(block_tables, seq_lens, block_size):
    """The write plan of one token per sequence at seq_lens[b]: the same for
    every layer of a decode step, so the engine computes it once a step."""
    return _write_plan(*_decode_scatter_idx(block_tables, seq_lens, block_size))


def _write_planned(pools, plan, news):
    """``pool[plan] = new`` in place for each (pool, new) pair."""
    return tuple(_put(pool, plan, new) for pool, new in zip(pools, news))


def paged_write_decode(cache_k, cache_v, block_tables, seq_lens, k_new, v_new):
    """Write one new token per sequence into its current tail block, in
    place. k_new/v_new: [B, kv_heads, head_dim]; position = seq_lens[b].
    Returns (cache_k, cache_v)."""
    plan = _decode_plan(block_tables, seq_lens, cache_k.shape[1])
    return _write_planned((cache_k, cache_v), plan, (k_new, v_new))


def paged_write_mixed(cache_k, cache_v, row_tables, positions, valid,
                      k_new, v_new):
    """Write one token per lane of a mixed (decode + chunked-prefill) pack.
    ``row_tables`` is the per-lane view ``block_tables[slot_ids]``; lanes
    whose ``valid`` is False write nothing."""
    plan = _write_plan(*_decode_scatter_idx(row_tables, positions, cache_k.shape[1]), valid)
    return _put(cache_k, plan, k_new), _put(cache_v, plan, v_new)


def _prefill_scatter_idx(pool, block_tables, seq_lens, S):
    """Flattened (phys, offset, valid) for writing a [B, S, ...] prompt:
    token t of sequence b lands at block_tables[b, t // bs], offset t % bs;
    only t < seq_lens[b] is valid."""
    B, bs = block_tables.shape[0], pool.shape[1]
    t = torch.arange(S, device=block_tables.device)
    phys = block_tables[:, t // bs].long()                  # [B, S]
    valid = t[None, :] < seq_lens.to(t.device)[:, None]     # [B, S]
    return phys.reshape(-1), (t % bs).repeat(B), valid.reshape(-1)


def _flat_rows(x):
    return x.reshape((x.shape[0] * x.shape[1],) + tuple(x.shape[2:]))


def paged_write_prefill(cache_k, cache_v, block_tables, seq_lens,
                        k_new, v_new):
    """Write a full prompt per sequence, in place: k_new/v_new [B, S,
    kv_heads, D]; only t < seq_lens[b] is written."""
    plan = _write_plan(*_prefill_scatter_idx(cache_k, block_tables, seq_lens,
                                             k_new.shape[1]))
    return _put(cache_k, plan, _flat_rows(k_new)), _put(cache_v, plan, _flat_rows(v_new))


def paged_write_decode_int8(kq, ks, vq, vs, block_tables, seq_lens,
                            k_new_q, k_new_s, v_new_q, v_new_s):
    """int8 form of paged_write_decode: values [B, kv, D] int8 plus their
    per-(token, head) scales [B, kv], the same slots in four pools."""
    plan = _decode_plan(block_tables, seq_lens, kq.shape[1])
    return _write_planned((kq, ks, vq, vs), plan, (k_new_q, k_new_s, v_new_q, v_new_s))


def paged_write_mixed_int8(kq, ks, vq, vs, row_tables, positions, valid,
                           k_new_q, k_new_s, v_new_q, v_new_s):
    """int8 form of paged_write_mixed: one quantized token per lane (values
    [T, kv, D] int8, scales [T, kv]); lanes whose ``valid`` is False write
    nothing."""
    plan = _write_plan(*_decode_scatter_idx(row_tables, positions, kq.shape[1]), valid)
    return tuple(_put(pool, plan, new) for pool, new in
                 ((kq, k_new_q), (ks, k_new_s), (vq, v_new_q), (vs, v_new_s)))


def paged_write_prefill_int8(kq, ks, vq, vs, block_tables, seq_lens,
                             k_new_q, k_new_s, v_new_q, v_new_s):
    """int8 form of paged_write_prefill (values [B, S, kv, D] int8, scales
    [B, S, kv]); padding rows write nothing."""
    plan = _write_plan(*_prefill_scatter_idx(kq, block_tables, seq_lens, k_new_q.shape[1]))
    return tuple(_put(pool, plan, _flat_rows(new)) for pool, new in
                 ((kq, k_new_q), (ks, k_new_s), (vq, v_new_q), (vs, v_new_s)))


def paged_attention_decode_int8(q, kq, ks, vq, vs, block_tables, seq_lens,
                                scale=None):
    """One decode step against the int8 paged cache without a dequantized
    copy: the per-(token, head) scales fold into the score and value
    products. The arithmetic is the dense engine's ``_attend_int8``, op for
    op (QK and PV products in q.dtype, the scale fold in
    promote(q.dtype, float32), divide by sqrt(D)), so the dense-int8 and
    paged-int8 engines compute the same function."""
    B, n_q, D = q.shape
    nb, bs, n_kv, _ = kq.shape
    groups = n_q // n_kv
    T = block_tables.shape[1] * bs

    k = kq[block_tables].reshape(B, T, n_kv, D)
    k_s = ks[block_tables].reshape(B, T, n_kv)
    v = vq[block_tables].reshape(B, T, n_kv, D)
    v_s = vs[block_tables].reshape(B, T, n_kv)

    qg = q.reshape(B, n_kv, groups, D)
    logits = torch.einsum("bhgd,bthd->bhgt", qg, k.to(q.dtype))
    ct = torch.promote_types(q.dtype, torch.float32)
    logits = (logits.to(ct) * k_s.transpose(1, 2)[:, :, None, :].to(ct)
              / (math.sqrt(D) if scale is None else 1.0 / scale))
    t = torch.arange(T, device=q.device)[None, None, None, :]
    mask = t <= seq_lens.to(q.device)[:, None, None, None]
    logits = torch.where(mask, logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    pv = (probs * v_s.transpose(1, 2)[:, :, None, :].to(ct)).to(q.dtype)
    out = torch.einsum("bhgt,bthd->bhgd", pv, v.to(q.dtype))
    return out.reshape(B, n_q, D).to(q.dtype)


def paged_attention_decode(q, cache_k, cache_v, block_tables, seq_lens,
                           scale=None):
    """One decode step of attention against the paged cache.

    q: [B, q_heads, head_dim] (GQA: q_heads a multiple of kv_heads). Gathers
    each sequence's blocks into a [B, T_max, kv, D] view (T_max =
    max_blocks_per_seq * block_size) and masks t <= seq_lens[b] (inclusive:
    the current token was just written at position seq_lens[b])."""
    B, n_q, D = q.shape
    nb, bs, n_kv, _ = cache_k.shape
    groups = n_q // n_kv
    T = block_tables.shape[1] * bs

    k = cache_k[block_tables].reshape(B, T, n_kv, D)
    v = cache_v[block_tables].reshape(B, T, n_kv, D)

    if scale is None:
        scale = 1.0 / math.sqrt(D)
    # promote, don't demote: bf16 -> f32 for a stable softmax, f64 stays f64
    ct = torch.promote_types(q.dtype, torch.float32)
    qg = q.reshape(B, n_kv, groups, D)
    logits = torch.einsum("bhgd,bthd->bhgt", qg.to(ct), k.to(ct)) * scale
    t = torch.arange(T, device=q.device)[None, None, None, :]
    mask = t <= seq_lens.to(q.device)[:, None, None, None]
    logits = torch.where(mask, logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgt,bthd->bhgd", probs, v.to(ct))
    return out.reshape(B, n_q, D).to(q.dtype)
