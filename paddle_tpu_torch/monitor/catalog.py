"""Metric and span name catalogs: the stable contract of the telemetry
subsystem.

Every metric this framework emits is declared here, named
``paddle_tpu_<subsystem>_<name>`` (snake_case, counters end in ``_total``,
histograms carry their unit as the trailing token, e.g. ``_ns`` /
``_seconds``). Dashboards and downstream artifact validators key on these
strings, so renaming an entry is a breaking change — add a new name and
deprecate the old one instead. ``tools/check_metric_names.py`` lints both
this table and every literal registration in the source tree against the
convention.

Span names (``monitor/trace.py``) are the same kind of contract for the
causal view: trace viewers, flight-recorder consumers and the hang-dump
workflow key on the exact strings, so every span the framework emits is
declared in ``SPANS`` (``<subsystem>.<name>``, dotted lowercase) and
linted by graftlint rule GL006 exactly like GL005 lints metric names.

This module is deliberately dependency-free (no torch, no package-relative
imports) so a lint tool can load it by file path without initializing the
framework. It is the port's copy of ``paddle_tpu/monitor/catalog.py``: the
same names, kinds and labels, so one dashboard reads both packages.
"""

# Subsystems a metric may belong to (the <subsystem> token of the name).
SUBSYSTEMS = ("dispatch", "jit", "serving", "kv", "dataloader", "monitor",
              "mesh", "comm", "ckpt", "train", "fleet", "control")

NAME_PATTERN = (
    r"^paddle_tpu_(" + "|".join(SUBSYSTEMS) + r")_[a-z][a-z0-9_]*$"
)

# name -> (metric type, label names, help text)
METRICS = {
    # -- op dispatch (ops/_apply.py) -------------------------------------
    "paddle_tpu_dispatch_op_calls_total": (
        "counter", ("op",),
        "Eager op dispatches through ops._apply.apply, labeled by op name."),
    "paddle_tpu_dispatch_latency_ns": (
        "histogram", (),
        "Wall time of one eager op dispatch (AMP cast + kernel dispatch + "
        "tape record), nanoseconds."),
    "paddle_tpu_dispatch_amp_casts_total": (
        "counter", (),
        "Tensor inputs actually cast by AMP auto_cast on the dispatch path."),
    # -- jit program caches (jit/api.py to_static + the serving engine's
    #    compiled prefill/decode programs) -------------------------------
    "paddle_tpu_jit_compiles_total": (
        "counter", ("function",),
        "Program-cache misses (trace + XLA compile), labeled by the cached "
        "callable (to_static function name, serving.prefill, "
        "serving.decode_step)."),
    "paddle_tpu_jit_cache_hits_total": (
        "counter", ("function",),
        "Program-cache calls served by an already-compiled program."),
    "paddle_tpu_jit_trace_compile_seconds": (
        "histogram", (),
        "Wall time of a to_static signature cache miss: trace + compile + "
        "the first execution, seconds."),
    "paddle_tpu_jit_cached_signatures": (
        "gauge", ("function",),
        "Live compiled signatures per cached callable."),
    # -- serving engine (models/serving.py) ------------------------------
    "paddle_tpu_serving_queue_depth": (
        "gauge", (),
        "Requests submitted but not yet admitted into the running batch."),
    "paddle_tpu_serving_batch_occupancy": (
        "gauge", (),
        "Fraction of continuous-batching slots holding an active request "
        "(0..1)."),
    "paddle_tpu_serving_prefill_latency_ns": (
        "histogram", (),
        "Per-request prefill wall time: slot admission to the step that "
        "consumed the last prompt token (chunked prefill spans several "
        "steps), nanoseconds."),
    "paddle_tpu_serving_decode_step_latency_ns": (
        "histogram", (),
        "Wall time of one batched decode step over all active slots, "
        "nanoseconds."),
    "paddle_tpu_serving_generated_tokens_total": (
        "counter", (),
        "Tokens emitted across all requests (prefill first-token included)."),
    "paddle_tpu_serving_evictions_total": (
        "counter", (),
        "Slots evicted (finished or length-capped requests)."),
    "paddle_tpu_serving_ttft_ns": (
        "histogram", (),
        "Time to first token: submit/add_request to the prefill argmax, "
        "nanoseconds."),
    "paddle_tpu_serving_admitted_total": (
        "counter", (),
        "Requests admitted into a batch slot."),
    "paddle_tpu_serving_rejected_total": (
        "counter", (),
        "add_request calls refused because the batch was full."),
    "paddle_tpu_serving_admission_rejected_total": (
        "counter", (),
        "submit() calls that raised AdmissionTimeout: the bounded "
        "admission queue stayed full past the caller's timeout "
        "(backpressure)."),
    "paddle_tpu_serving_pack_tokens": (
        "histogram", (),
        "Real lanes (decode tokens + prefill-chunk tokens) packed into "
        "one mixed step, out of the max_step_tokens budget."),
    "paddle_tpu_serving_chunked_prefill_depth": (
        "histogram", (),
        "Prefill chunks a request's prompt took (1 = the whole prompt "
        "rode one step's budget), observed at prefill completion."),
    "paddle_tpu_serving_prefix_cache_hits_total": (
        "counter", (),
        "Admissions whose prompt matched >= 1 cached prefix block."),
    "paddle_tpu_serving_prefix_cache_misses_total": (
        "counter", (),
        "Admissions with no cached prefix block to share."),
    "paddle_tpu_serving_prefix_blocks_shared_total": (
        "counter", (),
        "KV blocks mapped read-only from the radix cache into admitted "
        "requests (prompt tokens neither recomputed nor re-stored)."),
    "paddle_tpu_serving_shed_total": (
        "counter", ("tenant",),
        "Requests shed under sustained overload (queued victims removed "
        "for a higher-priority arrival, or arrivals refused with "
        "RequestShed), labeled by tenant."),
    "paddle_tpu_serving_tenant_queue_depth": (
        "gauge", ("tenant",),
        "Per-tenant admission-queue depth (submitted, not yet admitted)."),
    "paddle_tpu_serving_aborted_total": (
        "counter", (),
        "In-flight requests aborted by engine recovery (typed "
        "RequestAborted with partial tokens)."),
    "paddle_tpu_serving_recoveries_total": (
        "counter", (),
        "Engine recover() passes (driving-thread death, watchdog-"
        "detected hang, or manual drill)."),
    "paddle_tpu_serving_preemptions_total": (
        "counter", (),
        "Active requests preempted under pool pressure: KV spilled to "
        "host RAM, request requeued at the head of its tenant queue."),
    "paddle_tpu_serving_cancelled_total": (
        "counter", (),
        "Requests cancelled via engine.cancel() (queued requests "
        "removed from their lane, active slots evicted without a "
        "result) — the tail-hedging loser's exit path."),
    "paddle_tpu_serving_spec_draft_tokens_total": (
        "counter", (),
        "Speculative draft tokens packed into mixed-step verify lanes "
        "(the n-gram/radix drafter's proposals, models/spec_decode.py)."),
    "paddle_tpu_serving_spec_accepted_tokens_total": (
        "counter", (),
        "Draft tokens accepted by the device-side longest-agreeing-"
        "prefix verification (each one is a greedy token emitted without "
        "its own decode dispatch)."),
    "paddle_tpu_serving_spec_accept_rate": (
        "gauge", (),
        "Cumulative speculative accept rate: accepted / drafted tokens "
        "since engine construction (0..1)."),
    "paddle_tpu_serving_kv_pool_bytes": (
        "gauge", (),
        "Device bytes held by the engine's paged KV pools (all layers, "
        "values + scales) — the capacity lever quantized int8 pools "
        "halve: equal byte budgets admit ~2x the concurrent requests."),
    # -- serving fleet (serving/fleet.py) --------------------------------
    "paddle_tpu_fleet_requests_total": (
        "counter", (),
        "Requests submitted through the FleetRouter (each is routed to "
        "exactly one replica engine; failover/hedge duplicates are not "
        "re-counted here)."),
    "paddle_tpu_fleet_routed_total": (
        "counter", ("replica",),
        "Routing decisions per replica (least-queue-depth placement; "
        "failover re-routes and hedge duplicates included), labeled by "
        "replica tag."),
    "paddle_tpu_fleet_failovers_total": (
        "counter", (),
        "In-flight requests re-routed to a surviving replica after a "
        "replica death or hang — re-seeded from RequestAborted.tokens "
        "(prompt + partial output re-prefilled), so the caller's final "
        "result is one uninterrupted sequence."),
    "paddle_tpu_fleet_hedges_total": (
        "counter", (),
        "Tail-hedging duplicates spawned: a request past its latency "
        "SLO ran a bounded second copy on another replica (first "
        "finisher wins, loser cancelled)."),
    "paddle_tpu_fleet_hedge_wins_total": (
        "counter", (),
        "Hedged requests whose DUPLICATE finished first (the hedge "
        "paid off; the primary was cancelled)."),
    "paddle_tpu_fleet_healthy_replicas": (
        "gauge", (),
        "Replicas currently in the healthy state (admitting without "
        "restriction)."),
    "paddle_tpu_fleet_replica_state": (
        "gauge", ("replica",),
        "Per-replica health state code: 0=healthy, 1=suspect (stale "
        "heartbeat or half-open probe admission), 2=down (circuit "
        "broken, backing off), 3=draining, 4=parked."),
    "paddle_tpu_fleet_drains_total": (
        "counter", (),
        "Graceful drains completed: admission stopped, queued work "
        "migrated to peers, in-flight work finished, replica parked "
        "with zero lost requests."),
    "paddle_tpu_fleet_replica_inflight": (
        "gauge", ("replica",),
        "Fleet-routed requests in flight per replica (the routing "
        "signal), emitted in the FleetRouter's replica-labeled "
        "/metricsz document (host counters — present with the monitor "
        "off too)."),
    "paddle_tpu_fleet_replica_active": (
        "gauge", ("replica",),
        "Active engine slots per replica (the fleet /metricsz "
        "aggregation document)."),
    "paddle_tpu_fleet_replica_pending": (
        "gauge", ("replica",),
        "Queued (submitted, not yet admitted) engine requests per "
        "replica (the fleet /metricsz aggregation document)."),
    "paddle_tpu_fleet_replica_steps_total": (
        "counter", ("replica",),
        "Engine steps driven per replica since fleet construction "
        "(the fleet /metricsz aggregation document)."),
    # -- paged KV allocator (models/paged_kv.py) -------------------------
    "paddle_tpu_kv_free_blocks": (
        "gauge", (),
        "Free blocks in the most recently updated paged-KV pool."),
    "paddle_tpu_kv_cow_copies_total": (
        "counter", (),
        "Blocks copied by copy-on-write before a shared-tail write."),
    "paddle_tpu_kv_pool_exhausted_total": (
        "counter", (),
        "Allocation attempts that failed because the block pool was empty."),
    "paddle_tpu_kv_prefix_cache_blocks": (
        "gauge", (),
        "KV blocks currently indexed (and pinned) by the radix prefix "
        "cache."),
    "paddle_tpu_kv_prefix_cache_evictions_total": (
        "counter", (),
        "Cache-only blocks released back to the pool under allocation "
        "pressure (LRU order)."),
    "paddle_tpu_kv_spilled_blocks": (
        "gauge", (),
        "Radix-cache blocks currently spilled to host RAM (evicted from "
        "the device pool but restorable on a prefix match)."),
    "paddle_tpu_kv_spill_restores_total": (
        "counter", (),
        "Spilled KV blocks restored from host RAM into freshly "
        "allocated pool blocks (bit-exact round trip)."),
    # -- mesh execution (mesh/spmd_rules.py, mesh/parallelize.py) --------
    "paddle_tpu_mesh_reshards_total": (
        "counter", ("kind",),
        "Explicit redistributions inserted by the SPMD rule engine where "
        "an input's placement disagreed with the op's sharding rule, "
        "labeled by the implied collective (all_gather / all_to_all / "
        "shard)."),
    "paddle_tpu_mesh_optimizer_state_bytes": (
        "gauge", (),
        "Per-replica optimizer-state bytes of the active mesh train step "
        "— the ZeRO-1 lever: shard_optimizer=True shrinks this ~1/dp vs "
        "the replicated layout."),
    "paddle_tpu_mesh_comm_compressed_bytes_total": (
        "counter", (),
        "Per-device wire bytes of the COMPRESSED gradient exchange "
        "(int8/fp8 payload + fp32 scales), summed per mesh train step — "
        "compare against the <op>_bytes attrs on comm.mesh_step spans "
        "for the uncompressed-equivalent baseline."),
    "paddle_tpu_mesh_grad_buckets": (
        "gauge", (),
        "Gradient-communication buckets of the active mesh train step "
        "(size-targeted, reverse-autodiff completion order); 1 = the "
        "single tape-end barrier, >1 = backward-overlapped bucketed "
        "collectives."),
    # -- training checkpoints (checkpoint/manager.py) --------------------
    "paddle_tpu_ckpt_saves_total": (
        "counter", (),
        "Checkpoints COMMITTED (atomic rename landed) by the async "
        "writer thread — a torn or failed write never counts."),
    "paddle_tpu_ckpt_bytes": (
        "gauge", (),
        "Total shard + manifest bytes of the most recently committed "
        "checkpoint."),
    "paddle_tpu_ckpt_save_seconds": (
        "histogram", (),
        "Wall time of one checkpoint save, from the step thread's "
        "device->host copy to the atomic commit, seconds."),
    # -- fault-tolerant training (mesh/trainer.py) -----------------------
    "paddle_tpu_train_recoveries_total": (
        "counter", (),
        "MeshTrainer recover() passes (train-step death, watchdog-"
        "detected hang, or manual drill): epoch bump, flight dump, warm "
        "state reload from the last committed checkpoint."),
    # -- eager collectives (distributed/collective.py) -------------------
    "paddle_tpu_comm_collectives_total": (
        "counter", ("op",),
        "Eager collectives dispatched as real collectives (jax.lax in "
        "the JAX package, torch.distributed in the port) over a group mesh (all_reduce / all_gather / "
        "reduce_scatter / broadcast / alltoall / reduce), labeled by "
        "operation."),
    # -- dataloader (io/dataloader.py) -----------------------------------
    "paddle_tpu_dataloader_batches_total": (
        "counter", (),
        "Batches yielded to the training loop."),
    "paddle_tpu_dataloader_fetch_latency_ns": (
        "histogram", (),
        "Consumer-visible wait for the next staged batch, nanoseconds."),
    # -- the monitor itself ----------------------------------------------
    "paddle_tpu_monitor_samples_total": (
        "counter", (),
        "Timeline samples recorded for chrome-trace counter export."),
    "paddle_tpu_monitor_sanitizer_trips_total": (
        "counter", ("sanitizer",),
        "graftsan sanitizer trips (lock-order inversion, recompile storm, "
        "host-sync-in-span, data race, numerics), labeled by sanitizer; "
        "each trip also raises and flight-dumps (docs/sanitizers.md)."),
    "paddle_tpu_monitor_numsan_checks_total": (
        "counter", ("site",),
        "numsan device-side step-boundary finiteness checks issued while "
        "the numerics sanitizer is on, labeled by step site "
        "(serving.mixed_step / serving.decode_burst / mesh.train_step) — "
        "one compiled reduction and ONE host bool per check."),
    "paddle_tpu_monitor_fault_injections_total": (
        "counter", ("point",),
        "Fault-injection trips (analysis/faultinject.py, "
        "PADDLE_TPU_FAULTS=...), labeled by injection point — a chaos "
        "run's telemetry shows where the drill hit."),
    "paddle_tpu_monitor_scrapes_total": (
        "counter", ("endpoint",),
        "Requests handled by the graftscope debug endpoint "
        "(monitor/server.py), labeled by endpoint path — the scrape "
        "plane's own traffic accounting."),
    "paddle_tpu_monitor_slo_alerts_total": (
        "counter", ("objective",),
        "SLO burn-rate alert EDGES (monitor/slo.py): fast AND slow "
        "windows burning past the threshold, labeled by "
        "objective[/tenant] series. Observational only — alerts never "
        "drive routing."),
    "paddle_tpu_monitor_slo_burn_rate": (
        "gauge", ("objective", "window"),
        "Current burn rate (bad fraction / error budget) per SLO "
        "series and window (fast | slow), refreshed by every "
        "SLOTracker.scan()."),
    # -- graftpilot controller (control/controller.py) -------------------
    "paddle_tpu_control_ticks_total": (
        "counter", (),
        "Controller ticks executed (telemetry snapshot read + rule "
        "evaluation), whether or not any rule fired."),
    "paddle_tpu_control_decisions_total": (
        "counter", ("rule",),
        "Recorded controller decisions by rule (knob moves, hook "
        "actions, fenced errors) — the metric twin of the /controlz "
        "decision record."),
    "paddle_tpu_control_knob_value": (
        "gauge", ("knob",),
        "Current value of each actuated knob (fleet.replicas, "
        "fleet.hedge_after_s, engine.chunk_size, engine.decode_burst, "
        "engine.max_queue), set on every actuation."),
}


def spec(name):
    """(type, labelnames, help) for a cataloged metric name, or None."""
    return METRICS.get(name)


# -- span catalog (monitor/trace.py) ------------------------------------------

# Subsystems a span may belong to (the first dotted token of the name).
SPAN_SUBSYSTEMS = ("dispatch", "jit", "serving", "dataloader", "train",
                   "comm", "monitor", "mesh", "ckpt", "fleet", "control")

SPAN_PATTERN = (
    r"^(" + "|".join(SPAN_SUBSYSTEMS)
    + r")(\.[a-z][a-z0-9_]*)+$"
)

# name -> help text
SPANS = {
    # -- op dispatch (ops/_apply.py) -------------------------------------
    "dispatch.op": (
        "One SAMPLED eager op dispatch (AMP cast + kernel dispatch + tape "
        "record); 1-in-N sampling keeps the span tax off the 40us eager "
        "budget. attrs: op, sample_every."),
    # -- jit (jit/api.py + jit/sot.py) -----------------------------------
    "jit.compile": (
        "to_static signature cache miss: trace + XLA compile + first "
        "execution. attrs: function."),
    "jit.sot_capture": (
        "SOT cold run: eager execution with the op recorder attached, "
        "segmentation + guard extraction included. attrs: function."),
    "jit.sot_replay": (
        "SOT variant replay: compiled segments + guard checks for one "
        "call of a graph-broken signature."),
    # -- serving engine (models/serving.py) ------------------------------
    "serving.request": (
        "Root span of one serving request, open from submit()/add_request "
        "until eviction — ONE trace id per request; children decompose "
        "TTFT. attrs: rid."),
    "serving.queue_wait": (
        "submit() admission-queue wait: enqueue until a slot frees "
        "(child of serving.request)."),
    "serving.prefill": (
        "One request's WHOLE prefill: slot admission to the step that "
        "consumed its last prompt token, recorded at completion (child "
        "of serving.request; the chunk-level view is "
        "serving.prefill_chunk). attrs: slot, prompt_len, chunks, "
        "shared_tokens."),
    "serving.prefill_chunk": (
        "One chunked-prefill contribution to a mixed step: `tokens` "
        "prompt tokens of one request packed alongside the decode lanes "
        "(child of serving.request). attrs: slot, start, tokens."),
    "serving.pack_tokens": (
        "Per-step pack assembly of the mixed continuous-batching step: "
        "how many decode lanes and prefill-chunk lanes filled the token "
        "budget. attrs: n_decode, n_prefill, budget."),
    "serving.decode_step": (
        "One mixed serving step, recorded per active decoding request so "
        "each trace tree carries its own decode timeline. attrs: slot, "
        "n_active."),
    "serving.evict": (
        "Slot eviction: block free + host state clear (child of "
        "serving.request). attrs: slot, tokens."),
    "serving.step": (
        "One whole engine step, OPEN while the step runs — the span a "
        "flight dump names when the driving thread hangs or dies "
        "mid-step. attrs: engine."),
    "serving.recover": (
        "One engine recovery pass: flight dump, in-flight aborts "
        "(typed RequestAborted with partial tokens), warm restart from "
        "the radix cache. attrs: reason, aborted, cold."),
    "serving.preempt": (
        "One request preempted under pool pressure: its KV spilled to "
        "host RAM, its blocks freed, the request requeued (restored "
        "bit-exact on re-admission). attrs: slot, rid, tokens_in_kv."),
    "serving.spec_verify": (
        "One mixed step's speculative verification: draft tokens packed "
        "as extra ragged lanes, accepted by the device-side longest-"
        "agreeing-prefix rule, rejects rolled back by rewinding "
        "seq_lens. attrs: drafted, accepted, lanes."),
    # -- serving fleet (serving/fleet.py) --------------------------------
    "fleet.route": (
        "One FleetRouter routing decision: the admissible replica with "
        "the least queue depth takes the request (prefix-affinity hook "
        "stubbed for the ROADMAP item 4 follow-up). attrs: replica, "
        "depth, frid."),
    "fleet.failover": (
        "One failover pass after a replica death or hang: every "
        "aborted in-flight request re-seeded (prompt + partial tokens) "
        "onto a surviving replica, queued work migrated. attrs: "
        "replica, rerouted, migrated, reason."),
    "fleet.hedge": (
        "One tail-hedging duplicate spawned for a request past its "
        "latency SLO (first finisher wins, loser cancelled). attrs: "
        "frid, primary, hedge."),
    "fleet.drain": (
        "One graceful drain: admission stopped, queued requests "
        "migrated to peers, in-flight work finished, replica parked. "
        "attrs: replica, migrated, waited_ms."),
    "fleet.health": (
        "One replica health-state TRANSITION observed by the fleet "
        "monitor (healthy/suspect/down/draining/parked — scans "
        "themselves are not spanned). attrs: replica, from, to, "
        "reason."),
    # -- dataloader (io/dataloader.py) -----------------------------------
    "dataloader.batch": (
        "Consumer-visible wait for the next staged batch (fetch + "
        "host-to-device staging when unbuffered)."),
    # -- training step (monitor/trace.py training_step, hapi/model.py) ---
    "train.step": (
        "One training step (root of the dataload/forward/backward/"
        "optimizer decomposition). attrs: step."),
    "train.dataload": "Batch fetch portion of a training step.",
    "train.forward": "Forward pass (+ loss) portion of a training step.",
    "train.backward": "Backward pass portion of a training step.",
    "train.optimizer": (
        "Optimizer step + clear_grad portion of a training step."),
    "train.recover": (
        "One MeshTrainer warm-recovery pass (mesh/trainer.py): epoch "
        "bump, flight dump naming the stuck span + the step program's "
        "collective census, state reload from the last committed "
        "checkpoint. attrs: reason, stuck, restored_step."),
    # -- training checkpoints (checkpoint/manager.py) --------------------
    "ckpt.save": (
        "One checkpoint save, recorded at commit time on the writer "
        "thread (the step thread only paid the device->host copy). "
        "attrs: step, shards, bytes."),
    "ckpt.restore": (
        "One digest-verified checkpoint restore (shard re-hash + host "
        "assembly; the trainer re-shards ZeRO rows onto the current dp "
        "degree afterwards). attrs: step, shards, bytes."),
    # -- distributed (distributed/watchdog.py) ---------------------------
    "comm.wait": (
        "Blocking collective/host wait watched by CommWatchdog — open "
        "comm.wait spans in a flight dump are the hang candidates. "
        "attrs: desc."),
    # -- mesh execution (distributed/collective.py, mesh/parallelize.py) -
    "comm.collective": (
        "One eager collective dispatched as a real collective (jax.lax "
        "in the JAX package, torch.distributed in the port) over a group mesh (distributed/collective.py). attrs: "
        "op, group, nranks."),
    "comm.bucket_reduce": (
        "The bucketed gradient exchange of one mesh train-step dispatch "
        "(mesh/parallelize.py, knobs from mesh/comm_opt.py). attrs: "
        "buckets, compression, overlap, compressed_bytes, "
        "uncompressed_bytes."),
    "comm.mesh_step": (
        "One shard_map mesh train-step dispatch (mesh/parallelize.py); "
        "attrs carry the collective census of the compiled program "
        "(all_reduce/all_gather/reduce_scatter/all_to_all counts from "
        "HLO) plus dp degree and the ZeRO knob."),
    "mesh.reshard": (
        "One explicit redistribution inserted by the SPMD rule engine "
        "where an input's placement disagreed with the op's sharding "
        "rule (mesh/spmd_rules.py). attrs: kind, axis."),
    # -- graftsan (analysis/sanitizers.py) -------------------------------
    "monitor.sanitizer_trip": (
        "One graftsan trip (lock-order inversion / recompile storm / "
        "host-sync-in-span / data race), recorded at raise time so the "
        "flight dump shows WHERE in the request/step timeline the hazard "
        "fired. attrs: sanitizer."),
    "monitor.numsan_trip": (
        "One numsan numerics trip: a registered step-boundary region "
        "held a non-finite value; recorded at raise time with the "
        "bisection result so the flight dump names the step AND the "
        "first non-finite region. attrs: site, step, region."),
    "monitor.fault_injection": (
        "One fault-injection trip (analysis/faultinject.py), recorded "
        "at fire time so a chaos run's trace shows where the drill hit. "
        "attrs: point."),
    "monitor.scrape": (
        "One request handled by the graftscope debug endpoint "
        "(monitor/server.py) — the scrape plane's own footprint on the "
        "timeline, so scrape-vs-serve interference is visible in the "
        "same trace it observes. attrs: endpoint, status."),
    "monitor.slo_alert": (
        "One SLO burn-rate alert EDGE (monitor/slo.py): the instant "
        "both windows crossed the threshold, so the alert lands on the "
        "request timeline it indicts. attrs: objective, fast_burn, "
        "slow_burn."),
    "control.tick": (
        "One graftpilot controller cycle (control/controller.py): "
        "telemetry snapshot read, rules evaluated, proposals actuated "
        "— so every knob move lands on the request timeline it "
        "reshapes. attrs: tick, decisions."),
}


def span_spec(name):
    """Help text for a cataloged span name, or None."""
    return SPANS.get(name)
