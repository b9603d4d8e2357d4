"""Radix prefix cache of the PyTorch port (paddle_tpu_torch/models/radix_cache.py)
against the JAX package's (paddle_tpu/models/radix_cache.py), on the CPU.

The same call sequence goes through both ``PrefixCache``s, each over its own
package's ``PagedKVCache``: every return value, the entries in LRU order
(digest, parent, tokens, block), the child edges, the counters and the pagers'
tables, free lists and reference counts must be equal. Digest collisions are
forced by monkeypatching ``_digest`` in both modules, and by the
``radix.digest`` fault point armed in both packages.

The host-RAM spill store (``spill=True``): the same evictions with the live
pools, ``restore_chain`` calls and ``clear`` leave equal entries, spill
store (order, tokens and every payload bit), counters, pager books and pool
bits (but for the null block, where the JAX restore pads its writes).
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

import paddle_tpu  # noqa: F401  (the JAX package's settings)
from paddle_tpu.analysis import faultinject as jfi
from paddle_tpu.models import paged_kv as jpk
from paddle_tpu.models import radix_cache as jrc
from paddle_tpu_torch.analysis import faultinject as tfi
from paddle_tpu_torch.models import paged_kv as tpk
from paddle_tpu_torch.models import radix_cache as trc

BS = 4


def _pair(batch=4, blocks=32, capacity=None):
    kw = dict(num_layers=1, num_blocks=blocks, block_size=BS, kv_heads=1, head_dim=2,
              batch=batch, max_blocks_per_seq=8)
    jp = jpk.PagedKVCache(dtype=jnp.float32, **kw)
    tp = tpk.PagedKVCache(dtype=torch.float32, device="cpu", **kw)
    return (jrc.PrefixCache(jp, capacity_blocks=capacity),
            trc.PrefixCache(tp, capacity_blocks=capacity))


def _state(pc):
    pager = pc._pager
    return dict(
        entries=[(d, e.parent, e.tokens.tolist(), int(e.block)) for d, e in pc._entries.items()],
        by_block=dict(pc._by_block), nchildren=dict(pc._nchildren),
        children={k: list(v) for k, v in pc._children.items()},
        counters=(pc.hits, pc.misses, pc.blocks_shared, pc.collisions, pc.evicted, len(pc)),
        tables=pager._tables_np.tolist(), free=list(pager._free), refs=pager._refs.tolist())


def _norm(x):
    """Return values in one form: numpy arrays as lists."""
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, (list, tuple)):
        return [_norm(v) for v in x]
    return x


def _written(pc, row, n_tokens):
    need = np.zeros(pc._pager.batch, np.int64)
    need[row] = n_tokens
    pc._pager.ensure_capacity(need)
    return pc._pager._tables_np[row]


def _both(ops, **pair_kw):
    """Run ``ops(pc)`` (a generator of return values) on both caches; the
    returns and the final states must be equal."""
    j, t = _pair(**pair_kw)
    out_j, out_t = list(ops(j)), list(ops(t))
    assert _norm(out_t) == _norm(out_j)
    assert _state(t) == _state(j)
    return t


def _prompt(seed, n):
    return np.random.RandomState(seed).randint(0, 50, n).astype(np.int32)


def test_digest_is_the_jax_digest():
    for parent in (b"", jrc._digest(b"", np.arange(BS))):
        for toks in (np.arange(BS), _prompt(1, 64), np.zeros(0, np.int32)):
            assert trc._digest(parent, toks) == jrc._digest(parent, toks)


def _match_register(pc):
    p = _prompt(0, 13)
    row = _written(pc, 0, 13)
    yield pc.register(p, 5, row)           # one full block written so far
    yield pc.register(p, 13, row)          # the other two
    yield pc.register(p, 13, row)          # idempotent
    yield pc.match(p)
    q = p.copy()
    q[6] = 99                              # diverges in block 2
    yield pc.match(q)
    q[0] = 99
    yield pc.match(q)                      # a miss
    pc._pager.free_sequence(0)             # the owner goes; pins remain
    yield pc.match(p)
    yield pc.match(p[:8])                  # block-aligned full hit


def _lru_and_eviction(pc):
    prompts = [_prompt(s, 12) for s in range(4)]
    for r, p in enumerate(prompts):
        yield pc.register(p, 12, _written(pc, r, 12))
    for r in range(4):
        pc._pager.free_sequence(r)
    yield pc.match(prompts[1])             # prompt 1 becomes most recent
    yield pc.evict(2)                      # leaves first, LRU order
    yield pc.evict(100)
    yield pc.match(prompts[1])


def _evict_skips_live_and_interior(pc):
    base = _prompt(5, 8)
    a = np.concatenate([base, _prompt(6, 8)])
    b = np.concatenate([base, _prompt(7, 8)])
    yield pc.register(a, 16, _written(pc, 0, 16))
    blocks, n = pc.match(b)
    yield blocks, n
    pc._pager.adopt_blocks(1, blocks)
    _written(pc, 1, 16)
    yield pc.register(b, 16, pc._pager._tables_np[1])
    pc._pager.free_sequence(0)             # row 1 stays live
    yield pc.evict(10)                     # only a's tail is cache-only
    pc._pager.free_sequence(1)
    yield pc.evict(10)


def _capacity(pc):
    for r in range(3):
        yield pc.register(_prompt(10 + r, 8), 8, _written(pc, r, 8))
    yield pc.match(_prompt(10, 8))


def _register_from_cursor(pc):
    p = _prompt(20, 30)
    row = _written(pc, 0, 30)
    n, cur = pc.register_from((0, b""), p, 9, row)
    yield n, cur[0]
    n, cur = pc.register_from(cur, p[cur[0] * BS:], 30, row)
    yield n, cur[0]
    yield pc.match(p)


def _continue_tokens(pc):
    p = _prompt(30, 16)
    yield pc.register(p, 16, _written(pc, 0, 16))
    q = np.concatenate([p[:8], _prompt(31, 8)])
    yield pc.register(q, 16, _written(pc, 1, 16))
    d1 = jrc._digest(b"", p[:4]) if isinstance(pc, jrc.PrefixCache) \
        else trc._digest(b"", p[:4])
    yield pc.continue_tokens(b"", p[:2], 6)        # walks down the chain
    yield pc.continue_tokens(d1, p[4:5], 12)       # newest matching child wins
    yield pc.continue_tokens(d1, [77], 4)          # mismatched partial: None
    yield pc.continue_tokens(d1, [], 3)            # block-aligned context
    for r in (0, 1):
        pc._pager.free_sequence(r)
    yield pc.evict(1)                               # unlinks a child edge
    yield pc.continue_tokens(d1, p[4:5], 12)


def _clear(pc):
    for r in range(2):
        yield pc.register(_prompt(40 + r, 8), 8, _written(pc, r, 8))
    pc.clear()
    yield pc.match(_prompt(40, 8))
    for r in range(2):
        pc._pager.free_sequence(r)


@pytest.mark.parametrize("ops,kw", [
    (_match_register, {}), (_lru_and_eviction, {}), (_evict_skips_live_and_interior, {}),
    (_capacity, dict(capacity=3)), (_register_from_cursor, {}), (_continue_tokens, {}),
    (_clear, {}),
], ids=lambda x: getattr(x, "__name__", "kw"))
def test_same_calls_same_books(ops, kw):
    _both(ops, **kw)


def _collide(monkeypatch):
    for mod in (jrc, trc):
        monkeypatch.setattr(mod, "_digest", lambda parent, tokens: b"same")


def _collisions(pc):
    p = _prompt(50, 8)
    yield pc.register(p, 8, _written(pc, 0, 8))
    yield pc.match(_prompt(51, 8))          # every lookup collides: a miss
    yield pc.match(p)
    q = _prompt(52, 8)
    blocks, _ = pc.match(p)
    pc._pager.adopt_blocks(1, blocks[:1])
    _written(pc, 1, 8)
    # the row's adopted block is indexed already: never indexed twice
    yield pc.register(q, 8, pc._pager._tables_np[1])


def test_collisions_degrade_to_misses(monkeypatch):
    _collide(monkeypatch)
    t = _both(_collisions)
    assert t.collisions == 3      # one in each of the three lookups


def _digest_fault(pc):
    fi = jfi if isinstance(pc, jrc.PrefixCache) else tfi
    p = _prompt(55, 12)
    yield pc.register(p, 12, _written(pc, 0, 12))
    fi.arm("radix.digest", action="flag", nth=2)
    yield pc.match(p)                       # the second block's lookup is corrupt
    yield pc.match(p)                       # nth fires once: a full hit again
    fi.reset()


def test_digest_fault_degrades_to_a_collision():
    t = _both(_digest_fault)
    assert t.collisions == 1 and t.hits == 2


# -- the host-RAM spill store -------------------------------------------------

def _spill_pair(quantized, capacity=None, blocks=16):
    """Both caches with spill on, each with its own copy of the same random
    pools (two layers; the null block too)."""
    kw = dict(num_layers=2, num_blocks=blocks, block_size=BS, kv_heads=2, head_dim=4, batch=4,
              max_blocks_per_seq=8, quantized=quantized)
    jp = jpk.PagedKVCache(dtype=jnp.float32, **kw)
    tp = tpk.PagedKVCache(dtype=torch.float32, device="cpu", **kw)
    rng = np.random.RandomState(3)
    jpools, tpools = [], []
    for _ in range(2):
        if quantized:
            leaves = [rng.randint(-127, 128, (blocks, BS, 2, 4)).astype(np.int8),
                      rng.rand(blocks, BS, 2).astype(np.float32),
                      rng.randint(-127, 128, (blocks, BS, 2, 4)).astype(np.int8),
                      rng.rand(blocks, BS, 2).astype(np.float32)]
        else:
            leaves = [rng.randn(blocks, BS, 2, 4).astype(np.float32) for _ in range(2)]
        jpools.append(tuple(jnp.asarray(v) for v in leaves))
        tpools.append(tuple(torch.from_numpy(v.copy()) for v in leaves))
    spill = dict(spill=True, spill_capacity_blocks=capacity)
    return (jrc.PrefixCache(jp, **spill), [jpools]), (trc.PrefixCache(tp, **spill), [tpools])


def _spill_state(pc, pools):
    def host(x):
        return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    spilled = [(d, se.parent, se.tokens.tolist(),
                [[host(leaf).tolist() for leaf in entry] for entry in se.payload])
               for d, se in pc._spilled.items()]
    bits = [[host(leaf)[1:].tolist() for leaf in entry] for entry in pools[0]]
    return dict(_state(pc), spilled=spilled, restores=pc.restores, pools=bits)


def _evict_restore(pc, pools):
    prompts = [_prompt(60 + s, 12) for s in range(3)]
    for r, p in enumerate(prompts):
        yield pc.register(p, 12, _written(pc, r, 12))
    for r in range(3):
        pc._pager.free_sequence(r)
    yield pc.match(prompts[2])             # prompt 2 most recent
    yield pc.evict(5, pools=pools[0])      # leaves first, LRU: spilled
    yield pc.evict(1)                      # no pools: dropped, not spilled
    for p in (prompts[0], prompts[1], prompts[0]):
        blocks, shared = pc.match(p)
        blocks, shared, pools[0] = pc.restore_chain(p, blocks, shared, pools[0])
        yield blocks, shared
    yield pc.match(prompts[0])             # pool-resident again


def _capacity_and_clear(pc, pools):
    prompts = [_prompt(70 + s, 8) for s in range(3)]
    for r, p in enumerate(prompts):
        yield pc.register(p, 8, _written(pc, r, 8))
    for r in range(3):
        pc._pager.free_sequence(r)
    # the store keeps the newest 3 of 6 spilled blocks: each prompt's first
    yield pc.evict(6, pools=pools[0])
    for p in (prompts[0], prompts[2]):
        blocks, shared = pc.match(p)
        blocks, shared, pools[0] = pc.restore_chain(p, blocks, shared, pools[0])
        yield blocks, shared
    pc.clear()
    blocks, shared, pools[0] = pc.restore_chain(prompts[1], [], 0, pools[0])
    yield blocks, shared                   # the store is gone


def _no_room(pc, pools):
    p = _prompt(80, 16)
    yield pc.register(p, 16, _written(pc, 0, 16))
    pc._pager.free_sequence(0)
    yield pc.evict(4, pools=pools[0])
    taken = pc._pager.take_blocks(len(pc._pager._free) - 1)    # one block left
    blocks, shared = pc.match(p)
    blocks, shared, pools[0] = pc.restore_chain(p, blocks, shared, pools[0])
    yield blocks, shared                   # unchanged: no room
    pc._pager.release_blocks(taken)
    blocks, shared = pc.match(p)
    blocks, shared, pools[0] = pc.restore_chain(p, blocks, shared, pools[0])
    yield blocks, shared


@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("ops,capacity", [(_evict_restore, None), (_capacity_and_clear, 3),
                                          (_no_room, None)],
                         ids=lambda x: getattr(x, "__name__", str(x)))
def test_spill_store_same_books_and_bits(ops, capacity, quantized):
    (j, jpools), (t, tpools) = _spill_pair(quantized, capacity)
    out_j, out_t = list(ops(j, jpools)), list(ops(t, tpools))
    assert _norm(out_t) == _norm(out_j)
    assert _spill_state(t, tpools) == _spill_state(j, jpools)
    assert t.restores


def test_spill_payload_is_host_tensors_restored_in_place():
    """The port parks CPU tensors and restores into the same pool tensors."""
    (_j, _jp), (t, tpools) = _spill_pair(True)
    ids = [id(leaf) for entry in tpools[0] for leaf in entry]
    list(_evict_restore(t, tpools))
    assert [id(leaf) for entry in tpools[0] for leaf in entry] == ids
    p = _prompt(60, 12)
    t._pager.free_sequence(0)
    t.evict(len(t), pools=tpools[0])
    for se in t._spilled.values():
        assert [leaf.device.type for entry in se.payload for leaf in entry] == ["cpu"] * 8
        assert [leaf.dtype for leaf in se.payload[0]] == [torch.int8, torch.float32] * 2
    assert t.restore_chain(p, [], 0, tpools[0])[2] is tpools[0]
