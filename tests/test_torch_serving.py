"""Continuous-batching serving of the PyTorch port
(paddle_tpu_torch/models/serving.py and the mixed step and decode burst of
paddle_tpu_torch/models/llama_decode.py) against the JAX package's, on the CPU.

The model is tests/test_serving.py's (vocab 96, hidden 64, 2 layers, 4 heads,
2 KV heads), its weights carried to the port by ``llama_from_numpy``.

- The same packs go through both ``build_mixed_step``s (decode lanes, draft
  chains that are accepted, cut short and rejected, a prefill chunk, invalid
  lanes) and both ``build_decode_burst``s: tokens and accept flags equal, the
  pools within 1e-5 at fp32 (int8 pools: values within one step, scales
  within 1e-5).
- The same request schedule goes through both engines: the ``step()``
  result, ``lens``, the block tables, the reference counts and the free list
  equal after every step, and the radix entries and spill store, request
  stats, drafter state, shed records, ``status()`` (but for the engine tag
  and a recovery's duration) and pools equal at the end. Each schedule runs
  once per module (``_RUNS``). The resilience schedules arm the same fault
  point in both packages: preemption under ``paged_kv.ensure`` with a
  bit-exact restore (fp32 and int8 pools), a radix prefix spilled to host
  RAM and restored, ``cancel``, ``withdraw_pending``, ``request_knobs`` and
  ``recover`` mid-schedule.
"""
import sys
import threading

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import paddle_tpu as paddle
from paddle_tpu.analysis import faultinject as jfi
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import serving as jserving
from paddle_tpu.models.llama_decode import LlamaDecodeEngine as JaxDecode
from paddle_tpu_torch.models import (LlamaConfig, LlamaDecodeEngine, llama_from_numpy,
                                     serving as tserving)
from paddle_tpu_torch.analysis import faultinject as tfi
from paddle_tpu_torch.models import llama_decode as tdecode

KW = dict(vocab_size=96, hidden_size=64, intermediate_size=176, num_hidden_layers=2,
          num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128)
V = KW["vocab_size"]
_MODELS = {}
_RUNS = {}


def _models():
    if not _MODELS:
        paddle.seed(0)
        jm = JaxLlama(JaxConfig(**KW))
        jm.eval()
        state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
        _MODELS["pair"] = (jm, llama_from_numpy(state, LlamaConfig(**KW), device="cpu"))
    return _MODELS["pair"]


def _prompt(rng, n):
    return rng.randint(0, V, (n,)).astype(np.int32)


# -- the two programs --------------------------------------------------------

def _decoders(int8, max_len=64, bs=8, batch=4):
    jm, tm = _models()
    kw = dict(max_len=max_len, kv_cache_layout="paged", block_size=bs,
              kv_cache_dtype="int8" if int8 else None)
    je, te = JaxDecode(jm, **kw), LlamaDecodeEngine(tm, **kw)
    (jp, jpools), (tp, tpools) = je._init_paged(batch), te._init_paged(batch)
    # the same random pool contents on both sides, the null block included
    rng = np.random.RandomState(1)
    filled_j, filled_t = [], []
    for je_, te_ in zip(jpools, tpools):
        leaves_j, leaves_t = [], []
        for a, b in zip(je_, te_):
            if b.dtype == torch.int8:
                v = rng.randint(-127, 128, b.shape).astype(np.int8)
            elif int8:
                v = (rng.rand(*b.shape) * 0.02 + 1e-3).astype(np.float32)
            else:
                v = rng.randn(*b.shape).astype(np.float32)
            b.copy_(torch.from_numpy(v))
            leaves_j.append(jnp.asarray(v))
            leaves_t.append(b)
        filled_j.append(tuple(leaves_j))
        filled_t.append(tuple(leaves_t))
    return je, te, jp, tp, filled_j, filled_t


def _close_pools(jpools, tpools, skip_null=False):
    for je, te in zip(jpools, tpools):
        for a, b in zip(je, te):
            a, b = np.asarray(a), b.numpy()
            if skip_null:
                a, b = a[1:], b[1:]
            if b.dtype == np.int8:
                assert np.abs(a.astype(np.int32) - b.astype(np.int32)).max() <= 1
            else:
                np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5)


def _mixed_inputs(je, jp, tp, jpools):
    """A pack of T = 24 lanes: slot 0 decodes at 10 with three drafts (the
    first two agree with the model, the third does not), slot 1 decodes at 5
    with two drafts (the first disagrees, so the second is rejected although
    it continues the first), slot 2 prefills positions 0..7, slot 3 decodes
    at 17; the last 6 lanes are invalid. The agreeing drafts are found by
    running the JAX step lane by lane."""
    for p in (jp, tp):
        p.ensure_capacity([14, 8, 8, 18])
    T = 24
    step = jax.jit(je.build_mixed_step())
    tok = np.zeros(T, np.int32)
    pos = np.zeros(T, np.int32)
    slot = np.zeros(T, np.int32)
    chain = np.zeros(T, bool)
    valid = np.zeros(T, bool)
    lanes = [(0, 10, 4), (1, 5, 3), (3, 17, 1)]
    lane = 0
    for s, p0, n in lanes:
        slot[lane:lane + n] = s
        pos[lane:lane + n] = p0 + np.arange(n)
        chain[lane + 1:lane + n] = True
        tok[lane] = 7 + s
        lane += n
    slot[lane:lane + 8] = 2
    pos[lane:lane + 8] = np.arange(8)
    tok[lane:lane + 8] = np.arange(30, 38)
    valid[:lane + 8] = True

    def greedy(t):
        out, _ = step(jnp.asarray(np.stack([t, pos])), jpools, jp.block_tables,
                      jnp.asarray(slot), jnp.asarray(valid), jnp.asarray(np.zeros(T, bool)))
        return np.asarray(out)[0]

    tok[1] = greedy(tok)[0]          # slot 0: the first draft agrees
    tok[2] = greedy(tok)[1]          # so does the second
    tok[3] = (greedy(tok)[2] + 1) % V    # the third does not
    tok[5] = (greedy(tok)[4] + 1) % V    # slot 1: the first draft disagrees
    tok[6] = greedy(tok)[5]          # the second continues it
    return np.stack([tok, pos]), slot, valid, chain, jp.block_tables


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
def test_mixed_step_matches_jax(int8):
    je, te, jp, tp, jpools, tpools = _decoders(int8)
    pack, slot, valid, chain, jtables = _mixed_inputs(je, jp, tp, jpools)
    jout, jpools = jax.jit(je.build_mixed_step())(
        jnp.asarray(pack), jpools, jtables, jnp.asarray(slot), jnp.asarray(valid),
        jnp.asarray(chain))
    with torch.inference_mode():
        tout = te.build_mixed_step()(
            torch.from_numpy(pack), tpools, tp.block_tables, torch.from_numpy(slot),
            torch.from_numpy(valid), torch.from_numpy(chain))
    assert tout.dtype == torch.int32 and tuple(tout.shape) == (2, 24)
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    accept = tout[1].numpy()
    if not int8:
        np.testing.assert_array_equal(accept[:7], [0, 1, 1, 0, 0, 0, 0])
    assert not accept[~chain].any()
    _close_pools(jpools, tpools)


@pytest.mark.parametrize("chain_first_lane", [False, True])
def test_accept_flags_are_the_segmented_running_and(chain_first_lane):
    """The device-side accept flags against a plain loop, over random chains
    and agreements: with the LM head patched so the greedy tokens are ``nt``,
    lane i agrees iff nt[i - 1] equals its token (lane 0 reads lane T - 1, as
    ``jnp.roll`` does; in a chain it counts from lane 0, as JAX's scan)."""
    te = LlamaDecodeEngine(_models()[1], max_len=64, kv_cache_layout="paged", block_size=8)
    rng = np.random.RandomState(int(chain_first_lane))
    T = 64
    chain = rng.rand(T) < 0.6
    chain[0] = chain_first_lane
    tok = rng.randint(0, 3, T).astype(np.int32)
    nt = rng.randint(0, 3, T).astype(np.int32)
    want = np.zeros(T, bool)
    run = True
    for i in range(T):
        run = (run and nt[i - 1] == tok[i]) if chain[i] else True
        want[i] = chain[i] and run
    te._logits = lambda x: torch.nn.functional.one_hot(torch.from_numpy(nt).long(), V).float()
    _pager, pools = te._init_paged(1)
    with torch.inference_mode():
        out = te.build_mixed_step()(
            torch.from_numpy(np.stack([tok, np.zeros(T, np.int32)])), pools,
            torch.zeros((1, 8), dtype=torch.int32), torch.zeros(T, dtype=torch.int32),
            torch.ones(T, dtype=torch.bool), torch.from_numpy(chain))
    np.testing.assert_array_equal(out[0].numpy(), nt)
    np.testing.assert_array_equal(out[1].numpy().astype(bool), want)
    assert want.any() and (chain & ~want).any()


@pytest.mark.parametrize("int8,rows", [(False, None), (False, 24), (True, None), (True, 24)],
                         ids=["fp32", "fp32_24_rows", "int8", "int8_24_rows"])
def test_decode_burst_matches_jax(int8, rows):
    """Slots 0, 1 and 3 decode at their own positions; slot 2 is inactive
    (a table row of zeros: it writes into the null block, as in JAX). With
    ``rows`` the burst runs at 24 lanes: the same tokens, and the padding
    lanes write nothing."""
    je, te, jp, tp, jpools, tpools = _decoders(int8)
    K = 4
    lens = np.array([10, 5, 0, 17], np.int32)
    for p in (jp, tp):
        p.ensure_capacity([14, 9, 0, 21])
    pack = np.stack([np.array([3, 40, 0, 77], np.int32), lens])
    jout, jpools = jax.jit(je.build_decode_burst(K))(jnp.asarray(pack), jpools, jp.block_tables)
    with torch.inference_mode():
        tout = te.build_decode_burst(K, rows=rows)(torch.from_numpy(pack), tpools,
                                                   tp.block_tables)
    assert tout.dtype == torch.int32 and tuple(tout.shape) == (4, K)
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    _close_pools(jpools, tpools)


@pytest.mark.parametrize("live", [24, 16, 5, 40], ids=["all", "one_group", "short", "padded"])
def test_lane_groups_attend_as_one_call(live):
    """``_attend_lane_groups`` against one call of the paged attention over
    every lane: the first ``live`` lanes within 1e-6 at fp32 (a short last
    group padded with null-block lanes), zeros after the last group."""
    _je, te, _jp, tp, _jpools, tpools = _decoders(False)
    tp.ensure_capacity([14, 8, 8, 18])
    rng = np.random.RandomState(5)
    n = 40 if live == 40 else 24
    q = torch.from_numpy(rng.randn(n, 4, 16).astype(np.float32))
    rows = torch.from_numpy(rng.randint(0, 4, n))
    tables = tp.block_tables[rows]
    lens = torch.from_numpy(rng.randint(0, 18, n).astype(np.int32))
    attend = lambda q, t, s: tdecode._pk.paged_attention_decode(q, *tpools[0], t, s)  # noqa: E731
    want = attend(q, tables, lens)
    got = tdecode._attend_lane_groups(attend, q, tables, lens, live)
    groups = -(-live // tdecode.LANE_GROUP) * tdecode.LANE_GROUP
    np.testing.assert_allclose(got[:live].numpy(), want[:live].numpy(), rtol=1e-6, atol=1e-6)
    assert not got[groups:].any()


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
def test_burst_computes_a_lane_as_the_mixed_step(int8):
    """A decoding row's logits are the same bits from the mixed step (T = 24
    lanes, the row at lane 17 beside a prefill chunk and invalid lanes) and
    from one burst iteration at the mixed step's 24 rows (the row at lane
    0..3): both programs compute a lane with the same shapes."""
    _je, te, _jp, tp, _jpools, tpools = _decoders(int8)
    tp.ensure_capacity([14, 9, 0, 21])
    lens = np.array([10, 5, 0, 17], np.int32)
    toks = np.array([3, 40, 0, 77], np.int32)
    seen = []
    logits = te._logits
    te._logits = lambda x: (seen.append(logits(x)), seen[-1])[1]
    T = 24
    pack = np.zeros((2, T), np.int32)
    slot = np.zeros(T, np.int32)
    valid = np.zeros(T, bool)
    lanes = {0: 3, 1: 17, 3: 9}                 # slot -> lane in the mixed step
    for b, lane in lanes.items():
        pack[:, lane], slot[lane], valid[lane] = (toks[b], lens[b]), b, True
    pack[:, 10:16] = np.stack([np.arange(50, 56), np.arange(6)])   # slot 2 prefills
    slot[10:16], valid[10:16] = 2, True
    tp.ensure_capacity([14, 9, 8, 21])
    pools = [tuple(leaf.clone() for leaf in entry) for entry in tpools]
    with torch.inference_mode():
        te.build_mixed_step()(torch.from_numpy(pack), pools, tp.block_tables,
                              torch.from_numpy(slot), torch.from_numpy(valid),
                              torch.zeros(T, dtype=torch.bool))
        mixed = seen.pop()
        te.build_decode_burst(1, rows=T)(torch.from_numpy(np.stack([toks, lens])), tpools,
                                         tp.block_tables)
        burst = seen.pop()
    te._logits = logits
    for b, lane in lanes.items():
        assert torch.equal(burst[b], mixed[lane]), b


# -- the engines -------------------------------------------------------------

_KEEP = ("rid", "slot", "prompt_len", "tenant", "shared_tokens", "prefill_chunks", "tokens",
         "shed", "aborted", "restored")


def _stats(eng, rids):
    out = {}
    for rid in rids:
        st = eng.pop_stats(rid)
        out[rid] = None if st is None else {k: st[k] for k in _KEEP if k in st}
    return out


def _plain(r):
    """A call's return value in one form for both packages: arrays as lists,
    a RequestAborted as its rid, tokens, tenant and stats (clock values
    dropped)."""
    if isinstance(r, np.ndarray):
        return r.tolist()
    if isinstance(r, (jserving.RequestAborted, tserving.RequestAborted)):
        st = None if r.stats is None else {k: r.stats[k] for k in _KEEP if k in r.stats}
        return ("RequestAborted", r.rid, [int(t) for t in r.tokens], r.tenant, st,
                "ttft_ns" in (r.stats or {}))
    if isinstance(r, dict):
        return {k: _plain(v) for k, v in r.items()}
    if isinstance(r, (list, tuple)):
        return [_plain(v) for v in r]
    return r


def _status(eng):
    """status() but for the engine tag and a recovery's duration."""
    if not hasattr(eng, "status"):
        return None
    st = eng.status()
    del st["engine"]
    if "last_recovery" in st:
        del st["last_recovery"]["ms"]
    return st


def _radix(eng):
    pc = eng.prefix_cache
    if pc is None:
        return None
    return ([(d, e.parent, e.tokens.tolist(), int(e.block)) for d, e in pc._entries.items()],
            {k: list(v) for k, v in pc._children.items()},
            (pc.hits, pc.misses, pc.blocks_shared, pc.collisions, pc.evicted, pc.restores),
            [(d, se.parent, se.tokens.tolist()) for d, se in pc._spilled.items()])


def _call(eng, name, args, kw):
    """One schedule call: an engine method, or ``arm`` (a fault point of the
    engine's own package) or ``evict`` (radix eviction with the live pools,
    spilling with ``kv_spill``)."""
    if name == "arm":
        fi = jfi if isinstance(eng, (jserving.ContinuousBatchingEngine,
                                     jserving.StaticBatchEngine)) else tfi
        return fi.arm(*args, **kw)
    if name == "evict":
        return eng.prefix_cache.evict(*args, pools=eng._pools)
    return getattr(eng, name)(*args, **kw)


def _drafter(eng):
    d = eng._drafter
    if d is None:
        return None
    return {rid: (list(c.tokens), c.n_full, c.parent) for rid, c in d._reqs.items()}


def _drive(eng, schedule, step_kw, max_steps=200):
    """Run ``schedule`` ({step: [(method, args, kwargs)]}) on ``eng``: a log
    of every call's result or exception and every step's result and books."""
    log, rids = [], []
    for s in range(max_steps):
        for name, args, kw in schedule.get(s, ()):
            try:
                r = _call(eng, name, args, kw)
                log.append(("call", s, name, _plain(r)))
                if name in ("submit", "add_request") and r is not None:
                    rids.append(r)
            except (ValueError, RuntimeError) as e:
                log.append(("raise", s, name, type(e).__name__, getattr(e, "tenant", None)))
        res = eng.step(**step_kw)
        log.append(("step", s, sorted((rid, [int(t) for t in toks]) for rid, toks in res)))
        pager = eng._pager
        log.append(("books", s, eng.lens.tolist(), pager._tables_np.tolist(),
                    pager._refs.tolist(), list(pager._free)))
        if s > max(schedule) and not (eng.num_active or eng.num_pending):
            break
    else:
        raise AssertionError("schedule did not drain")
    shed = [(e.rid, e.tenant) for e in eng.pop_shed()] if hasattr(eng, "pop_shed") else None
    final = dict(radix=_radix(eng) if hasattr(eng, "prefix_cache") else None,
                 drafter=_drafter(eng) if hasattr(eng, "_drafter") else None,
                 stats=_stats(eng, rids), shed=shed, status=_status(eng),
                 spec=(getattr(eng, "spec_drafted", 0), getattr(eng, "spec_accepted", 0)))
    return log, final


def _prefix_prompts(seed=0):
    rng = np.random.RandomState(seed)
    pre = _prompt(rng, 16)
    return [np.concatenate([pre, _prompt(rng, n)]) for n in (5, 9, 3, 13)]


def _staggered():
    p = _prefix_prompts()
    return {0: [("add_request", (p[0],), {})], 1: [("add_request", (p[1],), {})],
            3: [("submit", (p[2],), {}), ("submit", (p[3],), dict(max_new_tokens=6))],
            6: [("submit", (p[0],), {})], 9: [("submit", (p[3][:17],), {})]}


def _full_hit():
    rng = np.random.RandomState(7)
    aligned = _prompt(rng, 16)                # 2 blocks of 8
    longer = np.concatenate([aligned, _prompt(rng, 8)])
    return {0: [("submit", (aligned,), {})],
            12: [("submit", (aligned,), {}), ("submit", (aligned,), {}),
                 ("submit", (longer,), {})],
            30: [("submit", (longer,), {})]}


def _spf():
    rng = np.random.RandomState(2)
    return {0: [("submit", (_prompt(rng, 24),), dict(max_new_tokens=3)),
                ("submit", (_prompt(rng, 4),), dict(max_new_tokens=3)),
                ("submit", (_prompt(rng, 13),), dict(max_new_tokens=5))],
            2: [("submit", (_prompt(rng, 6),), dict(max_new_tokens=4))]}


def _repeats():
    """Repetitive prompts, each served twice (the second time its chain and
    its own n-grams draft)."""
    rng = np.random.RandomState(11)
    pats = [_prompt(rng, 5) for _ in range(2)]
    prompts = [np.concatenate([np.tile(pats[i % 2], 3), _prompt(rng, 2)]) for i in range(3)]
    sched = {0: [("submit", (prompts[0],), {}), ("submit", (prompts[1],), {})],
             2: [("submit", (prompts[2],), {})]}
    sched[40] = [("submit", (p,), {}) for p in prompts]
    return sched


def _tenants():
    rng = np.random.RandomState(4)
    p = [_prompt(rng, int(n)) for n in rng.randint(3, 12, 8)]
    return {0: [("set_tenant", ("gold", 2.0, 1), {}), ("set_tenant", ("silver", 1.0, 1), {}),
                ("set_tenant", ("bronze", 1.0, 0), {}),
                ("submit", (p[0],), dict(tenant="bronze")),
                ("submit", (p[1],), dict(tenant="bronze")),
                ("submit", (p[2],), dict(tenant="bronze")),
                ("submit", (p[3],), dict(tenant="bronze")),    # queue full: shed
                ("submit", (p[4],), dict(tenant="gold")),      # displaces a bronze
                ("submit", (p[5],), dict(tenant="silver"))],   # and another
            3: [("submit", (p[6],), dict(tenant="gold")),
                ("submit", (p[7],), dict(tenant="silver"))]}


def _backpressure():
    rng = np.random.RandomState(6)
    p = [_prompt(rng, 5) for _ in range(4)]
    return {0: [("submit", (p[0],), {}), ("submit", (p[1],), {}),
                ("submit", (p[2],), {})],                      # queue full: raises
            1: [("submit", (p[2],), {}),                       # the step admitted p[0]
                ("submit", (p[3],), dict(timeout=0.01))]}      # waits, then raises


def _waves():
    rng = np.random.RandomState(5)
    return {0: [("submit", (_prompt(rng, 6),), dict(max_new_tokens=2)),
                ("submit", (_prompt(rng, 20),), dict(max_new_tokens=8)),
                ("submit", (_prompt(rng, 12),), {})],
            1: [("submit", (_prompt(rng, 5),), dict(max_new_tokens=3))],
            4: [("submit", (_prompt(rng, 33),), dict(max_new_tokens=1))]}


def _preempt():
    """Slot 0 decodes, slot 1 is mid-prefill when the decode grant's pool
    runs dry (an injected fault): slot 1 is preempted to host RAM and
    restored on the next step (tests/test_serving.py:535)."""
    rng = np.random.RandomState(8)
    pa, pb = _prompt(rng, 10), _prompt(rng, 20)
    return {0: [("add_request", (pa,), dict(max_new_tokens=8))],
            2: [("add_request", (pb,), dict(max_new_tokens=8))],
            3: [("arm", ("paged_kv.ensure",), dict(action="flag", nth=1))]}


def _radix_spill():
    """A finished prompt's chain evicted to host RAM, then restored by the
    same prompt's admission (a block-aligned full hit), then hit in the pool."""
    p = _prompt(np.random.RandomState(9), 24)
    return {0: [("submit", (p,), dict(max_new_tokens=6))],
            8: [("evict", (100,), {}), ("submit", (p,), dict(max_new_tokens=6))],
            9: [("submit", (p,), dict(max_new_tokens=6))]}


def _cancel():
    rng = np.random.RandomState(12)
    p = [_prompt(rng, n) for n in (9, 12, 7, 10)]
    return {0: [("submit", (p[0],), dict(max_new_tokens=3)),
                ("add_request", (p[1],), dict(max_new_tokens=20)),
                ("submit", (p[2],), dict(max_new_tokens=3)),
                ("submit", (p[3],), dict(max_new_tokens=4)),
                ("cancel", (3,), {})],                        # queued
            3: [("cancel", (1,), {}), ("cancel", (999,), {})],   # active, unknown
            12: [("cancel", (0,), {})]}                       # finished: stands


def _withdraw():
    rng = np.random.RandomState(13)
    p = [_prompt(rng, n) for n in (9, 12, 7, 10)]
    return {0: [("submit", (q,), dict(max_new_tokens=4)) for q in p],
            1: [("withdraw_pending", (), {}), ("submit", (p[3],), dict(max_new_tokens=4))]}


def _knobs():
    p = _prefix_prompts(4)
    return {0: [("submit", (q,), {}) for q in p[:2]],
            7: [("request_knobs", (), dict(decode_burst=2, chunk_size=4, decode_priority=0.25)),
                ("request_knobs", (), dict(nope=1))],
            8: [("submit", (q,), {}) for q in p[2:]]}


def _recover():
    p = _prefix_prompts(3)
    return {0: [("submit", (q,), {}) for q in p],
            4: [("recover", ("drill",), {}), ("pop_aborted", (), {})],
            5: [("submit", (p[0],), {}), ("submit", (p[1],), {})]}


_CB = dict(max_batch=3, max_len=64, block_size=8, chunk_size=8, decode_burst=4)
_SPILL = dict(max_batch=2, max_len=64, block_size=8, chunk_size=8, decode_burst=1, kv_spill=True,
              prefix_cache=False)
_RSPILL = dict(max_batch=2, max_len=64, block_size=8, chunk_size=32, kv_spill=True)
SCENARIOS = {
    # name: (engine, engine kwargs, schedule, step kwargs)
    "staggered_chunked": ("cont", _CB, _staggered, dict(max_new_tokens=10)),
    "full_hit_cow": ("cont", dict(_CB, max_batch=4), _full_hit, dict(max_new_tokens=6)),
    "spf_decode_priority": ("cont", dict(_CB, max_batch=2, chunk_size=4, max_step_tokens=8,
                                         policy="spf", decode_priority=0.5, decode_burst=1,
                                         prefix_cache=False), _spf, {}),
    "no_burst": ("cont", dict(_CB, decode_burst=1), _staggered, dict(max_new_tokens=10)),
    "spec": ("cont", dict(_CB, max_batch=2, max_step_tokens=12, spec_lookahead=4,
                          pool_blocks=40), _repeats, dict(max_new_tokens=12)),
    "int8": ("cont", dict(_CB, kv_cache_dtype="int8"), _staggered, dict(max_new_tokens=10)),
    "int8_spec": ("cont", dict(_CB, max_batch=2, max_step_tokens=12, spec_lookahead=4,
                               pool_blocks=40, kv_cache_dtype="int8"), _repeats,
                  dict(max_new_tokens=12)),
    "tenants_shedding": ("cont", dict(_CB, max_batch=1, max_queue=3), _tenants,
                         dict(max_new_tokens=3)),
    "strict_priority": ("cont", dict(_CB, max_batch=2, max_queue=3, strict_priority=True),
                        _tenants, dict(max_new_tokens=3)),
    "backpressure": ("cont", dict(_CB, max_batch=1, max_queue=2), _backpressure,
                     dict(max_new_tokens=2)),
    "eos": ("cont", _CB, _staggered, None),
    "static_waves": ("static", dict(max_batch=2, max_len=64, block_size=8,
                                    prefill_buckets=(16, 32)), _waves, {}),
    "preempt_spill": ("cont", _SPILL, _preempt, {}),
    "preempt_spill_int8": ("cont", dict(_SPILL, kv_cache_dtype="int8"), _preempt, {}),
    "radix_spill": ("cont", _RSPILL, _radix_spill, {}),
    "radix_spill_int8": ("cont", dict(_RSPILL, kv_cache_dtype="int8"), _radix_spill, {}),
    "cancel": ("cont", dict(_CB, max_batch=2, decode_burst=1), _cancel, {}),
    "withdraw": ("cont", dict(_CB, max_batch=2), _withdraw, {}),
    "knobs": ("cont", _CB, _knobs, dict(max_new_tokens=10)),
    "recover": ("cont", _CB, _recover, dict(max_new_tokens=10)),
}


def _engine(pkg, kind, kw, model):
    mod = jserving if pkg == "jax" else tserving
    cls = mod.ContinuousBatchingEngine if kind == "cont" else mod.StaticBatchEngine
    return cls(model, **kw)


def _eos():
    """An eos token from the middle of the first finished request's stream
    in the staggered schedule, so requests stop early, mid-burst too."""
    log = _run("staggered_chunked")["jax"][0]
    first = next(e[2] for e in log if e[0] == "step" and e[2])
    return dict(eos_token_id=first[0][1][4], max_new_tokens=10)


def _run(name):
    if name not in _RUNS:
        kind, kw, schedule, step_kw = SCENARIOS[name]
        if step_kw is None:
            step_kw = _eos()
        jm, tm = _models()
        got = {}
        for pkg, model in (("jax", jm), ("torch", tm)):
            (jfi if pkg == "jax" else tfi).reset()
            eng = _engine(pkg, kind, kw, model)
            got[pkg + "_bursts"] = bursts = []
            if kind == "cont":
                build = eng._inner.build_decode_burst
                eng._inner.build_decode_burst = lambda K, *a, **k: (bursts.append(K),
                                                                    build(K, *a, **k))[1]
            try:
                got[pkg] = _drive(eng, schedule(), step_kw)
            finally:
                got[pkg + "_trips"] = (jfi if pkg == "jax" else tfi).trips()
                (jfi if pkg == "jax" else tfi).reset()
            got[pkg + "_engine"] = eng
        _RUNS[name] = got
    return _RUNS[name]


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_same_steps_and_books_as_jax(name):
    run = _run(name)
    (jlog, jfinal), (tlog, tfinal) = run["jax"], run["torch"]
    for a, b in zip(jlog, tlog):
        assert b == a
    assert len(tlog) == len(jlog)
    assert any(e[0] == "step" and e[2] for e in tlog)
    assert tfinal == jfinal
    assert run["torch_trips"] == run["jax_trips"]
    assert run["torch_bursts"] == run["jax_bursts"]


@pytest.mark.parametrize("name", [n for n in SCENARIOS if SCENARIOS[n][0] == "cont"])
def test_pools_match_jax(name):
    run = _run(name)
    je, te = run["jax_engine"], run["torch_engine"]
    # block 0 is the null block: a burst's inactive rows all write there, in
    # an order neither library fixes, and nothing reads it unmasked
    _close_pools(je._pools, te._pools, skip_null=True)


def test_scenarios_reach_their_paths():
    """Each schedule exercises what it is named for (counted on the port)."""
    spec = _run("spec")["torch_engine"]
    assert spec.spec_drafted > 0 and 0 < spec.spec_accepted < spec.spec_drafted
    hit = _run("full_hit_cow")["torch_engine"]
    assert hit.prefix_cache.hits >= 3 and hit.prefix_cache.misses >= 1
    tlog = _run("tenants_shedding")["torch"][0]
    assert [e[3] for e in tlog if e[0] == "raise"] == ["RequestShed"]
    # two bronze requests displaced at step 0, the third at step 3
    assert len(_run("tenants_shedding")["torch"][1]["shed"]) == 3
    blog = _run("backpressure")["torch"][0]
    assert [e[3] for e in blog if e[0] == "raise"] == ["AdmissionTimeout"] * 2
    stats = _run("spf_decode_priority")["torch"][1]["stats"]
    assert max(st["prefill_chunks"] for st in stats.values()) >= 4
    eos_log = _run("eos")["torch"][0]
    assert any(len(toks) < 10 for e in eos_log if e[0] == "step" for _r, toks in e[2])


def test_resilience_scenarios_reach_their_paths():
    """Each resilience schedule exercises what it is named for (counted on
    the port)."""
    for name in ("preempt_spill", "preempt_spill_int8"):
        eng = _run(name)["torch_engine"]
        assert _run(name)["torch_trips"] == [("paged_kv.ensure", "flag")]
        assert eng.preemptions == 1 and eng.preempt_restores == 1 and eng.spilled_bytes > 0
        assert _run(name)["torch"][1]["stats"][1]["restored"] is True
    for name in ("radix_spill", "radix_spill_int8"):
        pc = _run(name)["torch_engine"].prefix_cache
        assert pc.restores == 3 and pc.hits == 2 and not pc._spilled
    final = _run("cancel")["torch"][1]
    assert final["status"]["cancelled"] == 2 and set(final["stats"]) == {0, 1, 2, 3}
    assert [rid for e in _run("cancel")["torch"][0] if e[0] == "step" for rid, _ in e[2]] \
        == [0, 2]
    wlog = _run("withdraw")["torch"][0]
    withdrawn = next(e[3] for e in wlog if e[0] == "call" and e[2] == "withdraw_pending")
    assert [w["rid"] for w in withdrawn] == [2, 3]
    assert _run("knobs")["torch_bursts"] == [4, 2]
    assert _run("knobs")["torch"][1]["status"]["knobs"]["chunk_size"] == 4
    rlog, rfinal = _run("recover")["torch"]
    aborted = next(e[3] for e in rlog if e[0] == "call" and e[2] == "pop_aborted")
    assert len(aborted) == 3 and all(a[0] == "RequestAborted" for a in aborted)
    assert any(a[2] for a in aborted)          # partial tokens ride the abort
    assert rfinal["status"]["recoveries"] == 1 and rfinal["status"]["epoch"] == 1
    assert rfinal["radix"][2][0] >= 2          # the re-admissions hit the warm cache


def test_batching_never_changes_a_requests_tokens():
    """Each request of the staggered schedule, served alone by a fresh port
    engine (no prefix cache, no burst), emits the tokens it emitted batched."""
    _jm, tm = _models()
    log, final = _run("staggered_chunked")["torch"]
    got = {rid: toks for e in log if e[0] == "step" for rid, toks in e[2]}
    prompts = [args[0] for calls in _staggered().values() for name, args, kw in calls]
    limits = [kw.get("max_new_tokens", 10) for calls in _staggered().values()
              for name, args, kw in calls]
    assert len(got) == len(prompts)
    for rid, (p, limit) in enumerate(zip(prompts, limits)):
        solo = tserving.ContinuousBatchingEngine(tm, max_batch=1, max_len=64, block_size=8,
                                                 chunk_size=8, prefix_cache=False,
                                                 decode_burst=1)
        solo.add_request(p, max_new_tokens=limit)
        out = []
        while solo.num_active:
            out += solo.step()
        assert out[0][1] == got[rid]


def test_burst_at_mixed_step_rows_keeps_every_stream():
    """The burst runs at the mixed step's T lanes on every device (the JAX
    burst at B rows): forced back to B rows, the staggered and int8
    schedules give the same JAX steps and books as the engine's T rows."""
    jm, tm = _models()
    for name in ("staggered_chunked", "int8"):
        kind, kw, schedule, step_kw = SCENARIOS[name]
        eng = _engine("torch", kind, kw, tm)
        assert eng._burst_rows == eng.max_step_tokens > eng.max_batch
        eng._burst_rows = None
        log, final = _drive(eng, schedule(), step_kw)
        assert (log, final) == _run(name)["jax"]
        assert "burst" in eng._jit_cache


def test_cpu_engine_runs_eagerly_and_builds_each_program_once():
    run = _run("staggered_chunked")
    te = run["torch_engine"]
    assert te.device.type == "cpu" and te._burst_rows == te.max_step_tokens
    assert set(te._jit_cache) == {"step", "burst"}
    assert not any(p.captured for p in te._jit_cache.values())
    assert te._pager.block_tables.device.type == "cpu"


def test_concurrent_submit_while_stepping():
    """submit() from 8 producer threads (a 1 us switch interval) while this
    thread steps: every request gets its own id and finishes exactly once,
    and the pool's books balance at the end."""
    _jm, tm = _models()
    eng = tserving.ContinuousBatchingEngine(tm, max_batch=3, max_len=32, block_size=8,
                                            chunk_size=8, decode_burst=2)
    rids, errors = [], []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def produce(seed):
        rng = np.random.RandomState(seed)
        try:
            for _ in range(5):
                rids.append(eng.submit(_prompt(rng, int(rng.randint(2, 10))),
                                       max_new_tokens=2))
        except Exception as e:   # noqa: BLE001 - reported by the assert below
            errors.append(e)

    threads = [threading.Thread(target=produce, args=(i,)) for i in range(8)]
    done = []
    try:
        for t in threads:
            t.start()
        while any(t.is_alive() for t in threads) or eng.num_active or eng.num_pending:
            done += [rid for rid, _toks in eng.step()]
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and errors == []
    assert len(rids) == 40 and sorted(rids) == list(range(40))
    assert sorted(done) == sorted(rids)
    pager = eng._pager
    live = int((pager._refs > 0).sum())
    assert live == len(eng.prefix_cache) and live + len(pager._free) == pager.num_blocks - 1


def test_pool_bytes_and_layout():
    jm, tm = _models()
    for dt in (None, "int8"):
        j = jserving.ContinuousBatchingEngine(jm, max_batch=2, max_len=32, block_size=8,
                                              kv_cache_dtype=dt)
        t = tserving.ContinuousBatchingEngine(tm, max_batch=2, max_len=32, block_size=8,
                                              kv_cache_dtype=dt)
        assert t.kv_pool_bytes == j.kv_pool_bytes
        assert [len(e) for e in t._pools] == [len(e) for e in j._pools]
        assert t.max_step_tokens == j.max_step_tokens


@pytest.mark.parametrize("kw,match", [
    (dict(max_step_tokens=2), "must exceed"), (dict(policy="lifo"), "unknown policy"),
    (dict(decode_priority=1.0), r"\[0, 1\)"), (dict(chunk_size=0), "chunk_size"),
])
def test_bad_options_raise_as_in_jax(kw, match):
    jm, tm = _models()
    for mod, model in ((jserving, jm), (tserving, tm)):
        with pytest.raises(ValueError, match=match):
            mod.ContinuousBatchingEngine(model, max_batch=2, max_len=32, block_size=8, **kw)


@pytest.mark.parametrize("n", [0, 31, 40])
def test_prompt_bounds_as_in_jax(n):
    jm, tm = _models()
    for mod, model in ((jserving, jm), (tserving, tm)):
        eng = mod.ContinuousBatchingEngine(model, max_batch=1, max_len=32, block_size=8)
        if n == 31:
            assert eng.submit(np.arange(n, dtype=np.int32) % V) == 0
        else:
            with pytest.raises(ValueError, match="out of range"):
                eng.submit(np.zeros(n, np.int32))
