#!/usr/bin/env python3
"""Where a decode token of the port's continuous-batching engine depends on
the program that computes it: the mixed step (T = 144 lanes at
``chip_smoke.py`` phase 10's serving parameters) or the decode burst (B = 16
rows, or T rows when padded, as the engine runs it). Both programs attend in
groups of ``llama_decode.LANE_GROUP`` lanes, the burst only over the groups
that hold its rows.

    python3 tools/serving_lanes.py

Needs one CUDA card. The flagship LLaMA (bf16, 8 layers, random weights from
a seed, as in ``chip_smoke.py``) with random pool contents. Prints three JSON
lines:

- ``ops``: each op of one decoder layer and the LM head, run on 16 rows and
  on the same 16 rows padded to 144, the first 16 rows compared bit for bit
  (paged attention as one call and in lane groups);
- ``lanes``: 16 decode lanes' logits through the mixed step, the burst at 16
  rows and the burst at 144 rows (one iteration), compared bit for bit, with
  the lanes' smallest top-2 logit gap, and the device ms of one captured
  replay of each program (8 iterations a burst);
- ``workload``: phase 10's serving workload through the engine cold, then
  warm, with the burst at 16 rows and at 144 rows: captured (tokens/s of each
  pass, requests whose tokens differ), then eagerly so every emitted token's
  logits are recorded (the requests whose tokens differ and, at the first
  differing token, the top-2 logit gap in each pass).
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np   # noqa: E402
import torch   # noqa: E402

import chip_smoke as cs   # noqa: E402
import paddle_tpu_torch.models as models   # noqa: E402
from paddle_tpu_torch.models import llama_decode as ld, paged_kv as pk, serving   # noqa: E402
from paddle_tpu_torch.nn import functional as F   # noqa: E402

B, T, MAX_LEN = 16, 144, 576


def bits_equal(a, b):
    return bool(torch.equal(a, b))


def top2_gap(logits):
    v = torch.topk(logits.float(), 2, dim=-1).values
    return (v[..., 0] - v[..., 1])


def op_check(eng, gen):
    """Each op of layer 0 and the LM head on 16 rows against 144 rows."""
    e = eng._inner
    p = e.layers[0]
    linear = torch.nn.functional.linear
    tokens = torch.randint(0, e.emb.shape[0], (T,), generator=gen, device="cuda")
    lens = torch.arange(T, device="cuda", dtype=torch.int32) % 400 + 20
    lens[:B] = torch.arange(B, device="cuda", dtype=torch.int32) * 23 + 100
    rows = torch.cat([torch.arange(B, device="cuda"),
                      torch.zeros(T - B, dtype=torch.long, device="cuda")])
    k_pool, v_pool = eng._pools[0]
    out = {}

    def both(name, fn, *inputs):
        full = fn(*inputs)
        out[name] = bits_equal(fn(*(x[:B] for x in inputs)), full[:B])
        return full

    x = e.emb[tokens][:, None]                                   # (T, 1, hidden)
    h = both("rms_norm", lambda x: F.rms_norm(x, p["ln1"], epsilon=e.eps), x)
    q = both("q_proj", lambda h: linear(h, p["wq"]), h).view(T, e.num_heads, e.head_dim)
    attend = lambda q, t, s: pk.paged_attention_decode(q, k_pool, v_pool, t, s)  # noqa: E731
    a = both("paged_attention", attend, q, eng._pager.block_tables[rows], lens)
    both("paged_attention_lane_groups", lambda q, t, s: ld._attend_lane_groups(
        attend, q, t, s, q.shape[0]), q, eng._pager.block_tables[rows], lens)
    both("o_proj", lambda a: linear(a, p["wo"]), a.reshape(T, -1))
    g = both("gate_proj", lambda h: linear(h, p["gate"]), h)
    both("down_proj", lambda g: linear(torch.nn.functional.silu(g), p["down"]), g)
    both("lm_head", lambda x: linear(F.rms_norm(x, e.norm_w, epsilon=e.eps), e.head_w), x)
    return out


def lane_check(eng, gen):
    """16 decode lanes' logits through the mixed step and the burst."""
    e = eng._inner
    V = e.emb.shape[0]
    lens = np.arange(B) * 23 + 100
    toks = torch.randint(0, V, (B,), generator=gen).numpy().astype(np.int32)
    base = cs.clone_pools(eng._pools)
    stash = []
    logits = e._logits
    e._logits = lambda x: (stash.append(logits(x)), stash[-1])[1]
    tables = eng._pager.block_tables
    pack = np.zeros((2, T), np.int32)
    pack[0, :B], pack[1, :B] = toks, lens
    slot = torch.zeros(T, dtype=torch.int32, device="cuda")
    slot[:B] = torch.arange(B, device="cuda")
    valid = torch.arange(T, device="cuda") < B
    got = {}
    cs.copy_pools(eng._pools, base)
    e.build_mixed_step()(torch.from_numpy(pack).cuda(), eng._pools, tables, slot, valid,
                         torch.zeros(T, dtype=torch.bool, device="cuda"))
    got["mixed_step"] = stash[-1][:B]
    bpack = torch.from_numpy(np.stack([toks, lens.astype(np.int32)])).cuda()
    for name, rows in (("burst_16_rows", None), ("burst_144_rows", T)):
        cs.copy_pools(eng._pools, base)
        stash.clear()
        e.build_decode_burst(1, rows=rows)(bpack, eng._pools, tables)
        got[name] = stash[0][:B]
    e._logits = logits
    # device ms of one replay of each program (CUDA graphs, CUDA events)
    replay_ms = {}
    progs = dict(mixed_step=(e.build_mixed_step(), (
        torch.from_numpy(pack), tables, slot, valid,
        torch.zeros(T, dtype=torch.bool, device="cuda"))))
    for name, rows in (("burst_16_rows", None), ("burst_144_rows", T)):
        progs[name] = (e.build_decode_burst(eng.decode_burst, rows=rows),
                       (torch.from_numpy(bpack.cpu().numpy()), tables))
    for name, (fn, inputs) in progs.items():
        prog = serving._Program(fn, eng._pools)
        replay_ms[name] = cs.call_ms(torch, lambda: prog(*inputs), iters=5, warmup=1)
        del prog
    cs.copy_pools(eng._pools, base)
    ref = got["mixed_step"]
    return dict(min_top2_gap=top2_gap(ref).min().item(), replay_ms=replay_ms,
                burst_iterations=eng.decode_burst,
                **{name: dict(bit_equal=bits_equal(g, ref),
                              max_abs_diff=(g.float() - ref.float()).abs().max().item(),
                              lanes_differ=int(((g != ref).any(-1)).sum().item()),
                              tokens_equal=bits_equal(g.argmax(-1), ref.argmax(-1)))
                   for name, g in got.items() if name != "mixed_step"})


class Recorder:
    """Run an engine's programs eagerly and record, for every emitted token,
    the top-2 logit gap of the row that produced it."""

    def __init__(self, eng, n_requests):
        self.kind = None
        self.gaps = {}                      # (request index, token index) -> gap
        self.calls = []                     # logits of the current program call
        self.lane_of = {}                   # slot -> row of the current call
        inner = eng._inner
        logits = inner._logits

        def record(x):
            out = logits(x)
            self.calls.append(top2_gap(out).cpu())
            return out

        inner._logits = record
        for key in ("step", "burst"):
            prog = eng._step_jit() if key == "step" else eng._burst_jit()

            def eager(*inputs, _prog=prog, _key=key):
                self.calls.clear()
                self.kind = _key
                self.count = {}
                if _key == "step":
                    slot, valid = inputs[2].cpu().numpy(), inputs[3].cpu().numpy()
                    self.lane_of = {int(s): int(np.flatnonzero((slot == s) & valid)[-1])
                                    for s in np.unique(slot[valid])}
                dev = inputs[1].device
                return _prog._run([x.to(dev) for x in inputs])

            eng._jit_cache[key] = eager
        note = eng._note_token

        def noted(slot, tok, *a):
            req = eng._slots[slot]
            if self.kind == "step":
                gap = self.calls[0][self.lane_of[slot]]
            else:
                i = self.count.get(slot, 0)
                self.count[slot] = i + 1
                gap = self.calls[i][slot]
            self.gaps[(req.rid % n_requests, len(req.outputs))] = float(gap)
            return note(slot, tok, *a)

        eng._note_token = noted


def workload_check(model):
    P = cs.SERVE10
    rng = np.random.RandomState(0)
    prompts, new_tokens, arrivals = cs.poisson_prefix_workload(
        model.config.vocab_size, n_requests=P["n_requests"], n_groups=P["n_groups"],
        prefix_blocks=P["prefix_blocks"], block_size=P["block_size"],
        tail_range=P["tail_range"], new_range=P["new_range"],
        mean_interarrival_s=P["mean_interarrival_s"], rng=rng)
    max_len = max(len(p) for p in prompts) + max(P["new_range"]) + P["block_size"]
    out = {}
    for name, rows in (("burst_16_rows", None), ("burst_144_rows", "T")):
        def engine():
            eng = models.ContinuousBatchingEngine(
                model, max_batch=P["max_batch"], max_len=max_len, block_size=P["block_size"],
                chunk_size=P["chunk_size"], decode_burst=P["decode_burst"])
            eng._burst_rows = None if rows is None else eng.max_step_tokens
            return eng

        # the captured programs: a cold and a warm pass, timed
        eng = engine()
        graphs = [cs.drive_serving(eng, prompts, new_tokens, arrivals) for _ in range(2)]
        del eng
        torch.cuda.empty_cache()
        # the same eagerly, every emitted token's top-2 logit gap recorded
        eng = engine()
        rec = Recorder(eng, P["n_requests"])
        passes = []
        for _ in range(2):
            rec.gaps = {}
            wall, total, _ttft, toks = cs.drive_serving(eng, prompts, new_tokens, arrivals)
            passes.append((toks, dict(rec.gaps), wall, total))
        (cold, gcold, *_), (warm, gwarm, *_) = passes
        differ = [i for i, (a, b) in enumerate(zip(cold, warm)) if a != b]
        first = None
        if differ:
            i = differ[0]
            j = next(j for j, (a, b) in enumerate(zip(cold[i], warm[i])) if a != b)
            first = dict(request=i, token_index=j, cold_token=cold[i][j], warm_token=warm[i][j],
                         cold_top2_gap=gcold.get((i, j)), warm_top2_gap=gwarm.get((i, j)))
        out[name] = dict(requests_differ=len(differ), first_difference=first,
                         tokens=passes[0][3], eager_pass_s=[p[2] for p in passes],
                         graphs_tokens_per_sec=[g[1] / g[0] for g in graphs],
                         graphs_requests_differ=sum(a != b for a, b in zip(graphs[0][3],
                                                                         graphs[1][3])))
        del eng, rec
        torch.cuda.empty_cache()
    return out


def main():
    if not torch.cuda.is_available():
        print("serving_lanes: no CUDA card visible", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"card: {cs.nvidia_smi()}", flush=True)
    cfg = models.LlamaConfig(**cs.FLAGSHIP, dtype="bfloat16")
    model = models.LlamaForCausalLM(cfg, device="cuda", seed=0)
    eng = models.ContinuousBatchingEngine(model, max_batch=B, max_len=MAX_LEN, block_size=64,
                                          chunk_size=128, decode_burst=8)
    gen = torch.Generator(device="cuda").manual_seed(3)
    with torch.inference_mode():
        for entry in eng._pools:
            for leaf in entry:
                leaf.copy_(torch.randn(leaf.shape, generator=gen, device="cuda") * 0.5)
        eng._pager.ensure_capacity(np.arange(B) * 23 + 109)
        print("ops " + json.dumps(op_check(eng, gen)), flush=True)
        print("lanes " + json.dumps(lane_check(eng, torch.Generator().manual_seed(4))),
              flush=True)
    del eng
    torch.cuda.empty_cache()
    with torch.inference_mode():
        print("workload " + json.dumps(workload_check(model)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
