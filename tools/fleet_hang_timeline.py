#!/usr/bin/env python3
"""The timeline of a fleet hang drill on the card, monitor off and on.

    python3 tools/fleet_hang_timeline.py

Builds ``chip_smoke.py``'s flagship (bf16, random weights from seed 0) and,
for each pass, a ``FleetRouter`` with per-replica watchdogs, ``slo=True`` and
``burn_aware_routing=True`` (HANG11's settings), warmed with its plain
``warmup`` (the watchdogs at their drill timeout throughout). Then HANG11's
delay on the nth ``serving.step`` while 8 of phase 11's requests are served
at once. The passes: a reference with nothing armed, then the drill with 2
and 3 replicas, each with the monitor and tracing off and on (flight dumps to
the build directory). Every replica's steps longer than 0.15 s, every
recovery, every flight dump (seconds, bytes) and every GC pause over 5 ms is
logged on one clock, from the drill's arming on; each pass prints its
recoveries in all (warmup's included), its trips, and whether its tokens
equal the reference's. Needs one CUDA card; prints one ``RUN``, ``EVENTS``
and ``STATE_LOG`` line a pass.
"""
from __future__ import annotations

import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import paddle_tpu_torch as T  # noqa: E402
import paddle_tpu_torch.models as models  # noqa: E402
from paddle_tpu_torch import serving as fleet  # noqa: E402
from paddle_tpu_torch.ops.cuda import _build  # noqa: E402

T0 = time.perf_counter()
EVENTS = []


def event(*a):
    EVENTS.append((round(time.perf_counter() - T0, 4),) + a)


def main():
    if not torch.cuda.is_available():
        print("fleet_hang_timeline: no CUDA card visible", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print("card", cs.nvidia_smi(), flush=True)
    print("build_seconds", _build.build_all(), flush=True)
    fi = T.analysis.faultinject
    P, H = cs.FLEET11, cs.HANG11
    cfg = models.LlamaConfig(**cs.FLAGSHIP, dtype="bfloat16")
    model = models.LlamaForCausalLM(cfg, device="cuda", seed=0)
    prompts, new_tokens, _arr = cs.fleet11_workload(cfg.vocab_size, np.random.RandomState(0))
    prompts, new_tokens = prompts[:H["n_requests"]], new_tokens[:H["n_requests"]]

    gc_start = {}

    def gc_pause(phase, info):
        if phase == "start":
            gc_start["t"] = time.perf_counter()
        else:
            d = time.perf_counter() - gc_start.get("t", time.perf_counter())
            if d > 0.005:
                event("gc", info["generation"], round(d, 4))

    gc.callbacks.append(gc_pause)
    dump = T.monitor.trace.flight_dump

    def timed_dump(*a, **k):
        t = time.perf_counter()
        path = dump(*a, **k)
        event("flight_dump", k.get("key"), round(time.perf_counter() - t, 4),
              os.path.getsize(path) if path else None)
        return path

    T.monitor.trace.flight_dump = timed_dump

    def instrument(fl):
        for rep in fl.replicas:
            eng = rep.engine
            step, recover = eng.step, eng.recover

            def timed_step(*a, _step=step, _tag=rep.tag, **k):
                t = time.perf_counter()
                r = _step(*a, **k)
                d = time.perf_counter() - t
                if d > 0.15:
                    event("slow_step", _tag, round(d, 4))
                return r

            def timed_recover(*a, _recover=recover, _tag=rep.tag, **k):
                event("recover_start", _tag, (a[0] if a else k.get("reason", ""))[:60])
                t = time.perf_counter()
                r = _recover(*a, **k)
                event("recover_end", _tag, round(time.perf_counter() - t, 4))
                return r

            eng.step, eng.recover = timed_step, timed_recover

    def run(replicas, monitored, arm=True):
        cs.obs_reset(T)
        os.environ["PADDLE_TPU_FLIGHT_DIR"] = str(_build.BUILD_DIR / "flight")
        fl = fleet.FleetRouter(
            model, replicas=replicas, max_new_tokens=P["max_new"],
            hang_timeout=H["hang_timeout"], slo=True, burn_aware_routing=True,
            engine_kwargs=dict(max_batch=P["max_batch"], max_len=P["max_len"],
                               block_size=P["block_size"], chunk_size=P["chunk_size"],
                               decode_burst=P["decode_burst"]))
        instrument(fl)
        try:
            if not fl.warmup(prompts[0][:6], max_new_tokens=2 * P["decode_burst"] + 2,
                             timeout=300):
                raise SystemExit("warmup did not finish")
            if monitored:
                T.monitor.enable()
                T.monitor.trace.enable()
            EVENTS.clear()
            event("armed")
            if arm:
                fi.arm("serving.step", action="delay", delay_s=H["delay_s"], nth=H["nth"])
            wall, out, _t, done = cs.drive_fleet(fl, prompts, new_tokens,
                                                 [0.0] * len(prompts))
            event("done")
            trips = fi.trips()
            recs = [r for rep in fl.replicas for r in rep.engine.recovery_stats]
            steps = [rep.steps for rep in fl.replicas]
            log = [tuple(x) for x in fl.state_log]
        finally:
            fi.reset()
            fl.stop()
            cs.obs_reset(T)
            os.environ.pop("PADDLE_TPU_FLIGHT_DIR", None)
        print("RUN " + json.dumps(dict(
            replicas=replicas, monitored=monitored, arm=arm, done=done, wall=wall,
            trips=trips, recoveries=len(recs), failovers=fl.failovers, steps=steps,
            reasons=[r["reason"][:60] for r in recs])), flush=True)
        print("EVENTS " + json.dumps(EVENTS), flush=True)
        print("STATE_LOG " + json.dumps([[str(y)[:60] for y in x] for x in log]), flush=True)
        del fl
        gc.collect()
        return out

    ref = run(2, False, arm=False)
    for replicas, monitored in ((2, False), (2, True), (3, True), (3, False)):
        out = run(replicas, monitored)
        print("MATCH", replicas, monitored, out == ref, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
