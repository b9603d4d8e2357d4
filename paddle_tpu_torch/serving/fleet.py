"""A health-checked router over N in-process continuous-batching engines:
the port of paddle_tpu/serving/fleet.py.

Every replica is a :class:`~paddle_tpu_torch.models.serving.ContinuousBatchingEngine`
over one model's weights (N engines, N paged KV pools, one set of
parameters), and the router owns the replica driver threads, so the whole
fleet lives, and is drilled, inside one process. On the card the replicas'
threads share the card (and its default stream); each engine captures its
two programs once, side by side (``_Program``'s thread-local capture).

Four coupled capabilities:

1. **Health.** Each replica's driver thread stamps a heartbeat every loop
   iteration and the engine exposes the start of its step in flight
   (``step_open_since``). States: ``healthy``, ``suspect`` (stale
   heartbeat, or the breaker's half-open window), ``down`` (died or hung;
   capped exponential backoff), ``draining`` and ``parked``. A down replica
   admits nothing; when its backoff elapses it goes suspect and admits one
   probe request; a completed probe closes the breaker, a failure doubles
   the backoff.
2. **Failover.** A replica death (the driver loop's exception path) or hang
   (a per-replica :class:`~paddle_tpu_torch.distributed.watchdog.CommWatchdog`
   with ``hang_timeout``) runs the engine's ``recover()``: typed
   :class:`~paddle_tpu_torch.models.serving.RequestAborted` aborts, a warm
   restart. The router re-seeds every aborted request onto a surviving
   replica from ``RequestAborted.tokens`` (the prompt plus the partial
   output prefill again; greedy continuation is deterministic), so the
   caller receives one uninterrupted result, bit-identical to an
   undisturbed run. Queued work moves through ``withdraw_pending()``.
3. **Tail hedging.** A request older than ``hedge_after_s`` gets a bounded
   duplicate on a second replica (at most ``max_hedges`` at once); the
   first finisher wins and the loser is cancelled (``engine.cancel``).
4. **Graceful drain.** :meth:`FleetRouter.drain` stops admission to a
   replica, moves its queued work to the peers, lets its active slots
   finish and parks it; :meth:`FleetRouter.resume` brings it back.

Routing is least in-flight depth among admissible replicas; the
prefix-affinity hook (:meth:`FleetRouter._affinity_hint`) is a stub, as in
the JAX package. The fault points ``fleet.route``, ``fleet.replica_step``
and ``fleet.health`` fire where the JAX package fires them.

Not ported (the observability and control slice, ROADMAP Queue A item 7):
``slo=`` and ``burn_aware_routing=True`` (they need ``monitor/slo.py``),
``fleet_prometheus_text``, ``fleet_snapshot``, the ``/statusz`` and
``/metricsz`` providers, the fleet metrics and spans, and the controller's
rolling telemetry; each entry point raises ``NotImplementedError``. The
router's lock is a plain ``threading.Lock``.
"""
from __future__ import annotations

import collections
import itertools
import threading
import time

import numpy as np

from ..analysis import faultinject as _fi
from ..models.serving import ContinuousBatchingEngine

__all__ = ["FleetRouter", "FleetUnavailable", "HEALTHY", "SUSPECT", "DOWN", "DRAINING",
           "PARKED"]

HEALTHY = "healthy"      # admitting without restriction
SUSPECT = "suspect"      # stale heartbeat, or half-open probe admission
DOWN = "down"            # circuit broken: backing off, admitting nothing
DRAINING = "draining"    # admission stopped, finishing in-flight work
PARKED = "parked"        # drained and idle (rolling-restart slot)

_ITEM7 = ("belongs to the observability and control slice of the port "
          "(ROADMAP Queue A item 7) and is not ported yet")


class FleetUnavailable(RuntimeError):
    """No admissible replica: every replica is down, draining or parked
    (and a half-open suspect already carries its probe)."""


class _Attempt:
    """One engine submission serving (part of) one fleet request. ``prefix``
    is the partial output the attempt was seeded with (its prompt was
    ``fr.prompt + prefix``), so its engine tokens append to that prefix."""

    __slots__ = ("fr", "rep", "rid", "prefix", "hedge")

    def __init__(self, fr, prefix, hedge):
        self.fr = fr
        self.rep = None
        self.rid = None
        self.prefix = list(prefix)
        self.hedge = hedge


class _FleetRequest:
    """The router's ledger entry for one caller-visible request."""

    __slots__ = ("frid", "prompt", "max_new", "tenant", "t_submit_ns", "t_submit_mono",
                 "done", "tokens", "failovers", "stats_base", "primary", "hedge")

    def __init__(self, frid, prompt, max_new, tenant, t_submit_ns):
        self.frid = frid
        self.prompt = prompt            # np.int32 (L,)
        self.max_new = max_new
        self.tenant = tenant
        self.t_submit_ns = t_submit_ns
        self.t_submit_mono = time.monotonic()
        self.done = False
        self.tokens = None
        self.failovers = 0
        # partial stats of aborted attempts: the fleet TTFT and the chunk and
        # shared-token sums over every attempt
        self.stats_base = {"chunks": 0, "shared_tokens": 0}
        self.primary = None             # _Attempt
        self.hedge = None               # _Attempt or None


class _Replica:
    """One engine replica and the router's view of it."""

    __slots__ = ("idx", "tag", "engine", "state", "suspect_reason", "heartbeat", "failures",
                 "backoff_until", "inflight", "rid2att", "unclaimed", "unclaimed_aborts",
                 "cancelled_rids", "_cancel_order", "thread", "dog", "fail_lock", "steps")

    def __init__(self, idx, engine):
        self.idx = idx
        self.engine = engine
        self.tag = engine._tag
        self.state = HEALTHY
        self.suspect_reason = ""
        self.heartbeat = time.monotonic()
        self.failures = 0
        self.backoff_until = 0.0
        self.inflight = 0               # fleet-routed, not yet resolved
        self.rid2att = {}               # engine rid -> _Attempt
        # results whose mapping was not yet recorded when the driver
        # delivered them (submit records it right after the engine call)
        self.unclaimed = collections.deque(maxlen=1024)
        # the abort-side twin: (rid, tokens, stats) of aborts or withdrawals
        # that raced the same mapping gap, claimed in _submit_attempt
        self.unclaimed_aborts = collections.deque(maxlen=1024)
        # bounded record of cancelled rids (a cancelled request never emits
        # a result that would discard its entry)
        self.cancelled_rids = set()
        self._cancel_order = collections.deque(maxlen=1024)
        self.thread = None
        self.dog = None
        self.fail_lock = threading.Lock()
        self.steps = 0

    def mark_cancelled(self, rid):
        if len(self._cancel_order) == self._cancel_order.maxlen:
            self.cancelled_rids.discard(self._cancel_order[0])
        self._cancel_order.append(rid)
        self.cancelled_rids.add(rid)


class FleetRouter:
    """Drive ``replicas`` continuous-batching engines over one model as a
    health-checked, failover-capable fleet. Knobs:

    - ``engine_kwargs``: forwarded to every replica's engine (leave
      ``max_queue`` unbounded for fleet-level admission control, or bound it
      and ``submit`` passes the engine's typed errors through).
    - ``eos_token_id`` / ``max_new_tokens``: the drive loops' decode
      defaults (a per-request ``max_new_tokens`` overrides; a fleet without
      any token limit cannot re-seed a failover exactly past ``max_len``).
    - ``hang_timeout``: a per-replica ``CommWatchdog`` around each step.
    - ``hedge_after_s`` / ``max_hedges``: the tail-hedging threshold (None
      = off) and the fleet-wide bound on concurrent duplicates.
    - ``suspect_after_s``: heartbeat staleness that demotes a replica to
      suspect until it heartbeats again.
    - ``backoff_base_s`` / ``backoff_cap_s``: the breaker's capped
      exponential backoff between a failure and its half-open probe.
    - ``slo`` and ``burn_aware_routing``: not ported (``NotImplementedError``
      unless None and False).
    """

    def __init__(self, model, replicas=3, *, engines=None, engine_kwargs=None,
                 eos_token_id=None, max_new_tokens=None, hang_timeout=None,
                 hedge_after_s=None, max_hedges=2, suspect_after_s=1.0, backoff_base_s=0.05,
                 backoff_cap_s=2.0, health_poll_s=0.02, poll_s=0.0005, slo=None,
                 burn_aware_routing=False, start=True):
        if slo is not None:
            raise NotImplementedError(f"FleetRouter(slo=...) {_ITEM7}")
        if burn_aware_routing:
            raise NotImplementedError(f"FleetRouter(burn_aware_routing=True) {_ITEM7}")
        if engines is None:
            kw = dict(engine_kwargs or {})
            engines = [ContinuousBatchingEngine(model, **kw) for _ in range(int(replicas))]
        if not engines:
            raise ValueError("a fleet needs at least one replica")
        self._replicas = [_Replica(i, e) for i, e in enumerate(engines)]
        self._eos = eos_token_id
        self._max_new = max_new_tokens
        self._hang_timeout = hang_timeout
        # runtime tunables: the hedging threshold (None disables it; set it
        # after warmup so warmup latency spawns no duplicates) and its bound
        self.hedge_after_s = hedge_after_s
        self.max_hedges = int(max_hedges)
        self._suspect_after = float(suspect_after_s)
        self._backoff_base = float(backoff_base_s)
        self._backoff_cap = float(backoff_cap_s)
        self._health_poll = float(health_poll_s)
        self._poll_s = float(poll_s)
        self.burn_aware_routing = False
        # one router lock guards the ledger, the rid -> attempt maps, the
        # health states and the in-flight counts; no engine call that can
        # block (submit) or touch the card runs under it
        self._lock = threading.Lock()
        self._frids = itertools.count()
        self._requests = {}             # frid -> _FleetRequest (in flight)
        self._results = collections.deque(maxlen=65536)
        self._final_stats = collections.OrderedDict()
        # re-routed work that found no admissible replica (total outage):
        # the health monitor retries it as soon as one heals
        self._stranded = collections.deque()
        self.requests_total = 0
        self.failovers = 0
        self.hedges = 0
        self.hedge_wins = 0
        self.drains = 0
        # bounded transition log: [(tag, old, new, reason)]
        self.state_log = collections.deque(maxlen=1024)
        self._stop = threading.Event()
        self._health_thread = None
        if start:
            self.start()

    # -- lifecycle -----------------------------------------------------------
    def start(self):
        """Start one driver thread per replica and the health monitor
        (idempotent)."""
        self._stop.clear()
        for rep in self._replicas:
            if rep.thread is None or not rep.thread.is_alive():
                if self._hang_timeout is not None and rep.dog is None:
                    from ..distributed.watchdog import CommWatchdog

                    rep.dog = CommWatchdog(timeout=float(self._hang_timeout),
                                           on_timeout=self._make_hang_handler(rep),
                                           flight_key=rep.tag)
                t = threading.Thread(target=self._replica_loop, args=(rep,), daemon=True,
                                     name=f"fleet-replica-{rep.tag}")
                rep.thread = t
                t.start()
        if self._health_thread is None or not self._health_thread.is_alive():
            t = threading.Thread(target=self._health_main, daemon=True, name="fleet-health")
            self._health_thread = t
            t.start()

    def stop(self, timeout=5.0):
        """Stop every driver thread and the health monitor (current steps
        complete first)."""
        self._stop.set()
        for rep in self._replicas:
            if rep.thread is not None and rep.thread.is_alive():
                rep.thread.join(timeout=timeout)
            rep.thread = None
            if rep.dog is not None:
                rep.dog.stop()
                rep.dog = None
        if self._health_thread is not None and self._health_thread.is_alive():
            self._health_thread.join(timeout=timeout)
        self._health_thread = None

    def _make_hang_handler(self, rep):
        def _on_hang(desc, dump):
            del dump
            self._fail_replica(rep, f"watchdog-detected hang: {desc} exceeded "
                                    f"{self._hang_timeout}s")
        return _on_hang

    # -- submission and results ----------------------------------------------
    def submit(self, prompt_ids, max_new_tokens=None, timeout=None, tenant=""):
        """Route one request to the admissible replica with the least depth
        and submit it there (thread-safe). Returns the fleet request id; the
        result arrives through :meth:`pop_results` as one uninterrupted token
        sequence however many failovers or hedges served it. Raises
        :class:`FleetUnavailable` when no replica admits, and passes the
        engine's typed backpressure errors through."""
        _fi.fire("fleet.route")
        prompt = np.asarray(getattr(prompt_ids, "value", prompt_ids), np.int32).reshape(-1)
        with self._lock:
            frid = next(self._frids)
        fr = _FleetRequest(frid, prompt, max_new_tokens, tenant, time.perf_counter_ns())
        att = _Attempt(fr, prefix=(), hedge=False)
        fr.primary = att
        self._submit_attempt(att, timeout=timeout)
        with self._lock:
            if not fr.done:
                # a request the driver already finished (the claimed-result
                # race) must not enter the ledger: nothing would remove it
                self._requests[frid] = fr
        self.requests_total += 1
        return frid

    def pop_results(self):
        """Drain finished ``(frid, tokens)`` pairs (each the caller's single
        uninterrupted result)."""
        out = []
        while True:
            try:
                out.append(self._results.popleft())
            except IndexError:
                return out

    def pop_stats(self, frid):
        """Final merged stats of one finished fleet request: the TTFT across
        failovers (the aborted attempt's first token when it had one, else
        the replacement's, measured from the original fleet submit), prefill
        chunks and shared prefix tokens summed over attempts, and the
        failover and hedge provenance."""
        with self._lock:
            return self._final_stats.pop(frid, None)

    def warmup(self, prompt_ids, max_new_tokens=2, timeout=60.0):
        """Run one request through every non-parked replica at once and wait:
        each engine builds (on the card, captures) its programs before
        traffic. Returns whether every warmup request finished."""
        prompt = np.asarray(getattr(prompt_ids, "value", prompt_ids), np.int32).reshape(-1)
        frs = []
        for rep in self._replicas:
            with self._lock:
                if rep.state == PARKED:
                    continue
                frid = next(self._frids)
            fr = _FleetRequest(frid, prompt, max_new_tokens, "", time.perf_counter_ns())
            att = _Attempt(fr, prefix=(), hedge=False)
            fr.primary = att
            self._submit_attempt(att, rep=rep)
            with self._lock:
                if not fr.done:
                    self._requests[frid] = fr
            frs.append(fr)
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline and not all(fr.done for fr in frs):
            time.sleep(self._poll_s)
        # consume the warmup results so callers only ever see their own
        mine = {fr.frid for fr in frs}
        keep = [r for r in self.pop_results() if r[0] not in mine]
        self._results.extend(keep)
        for fr in frs:
            self.pop_stats(fr.frid)
        return all(fr.done for fr in frs)

    # -- routing -------------------------------------------------------------
    def _affinity_hint(self, prompt, candidates):
        """Prefix-affinity placement hook: a later change returns the
        candidate whose radix cache holds the longest prefix of ``prompt``.
        None keeps routing by depth alone."""
        return None

    def _pick_locked(self, prompt, exclude=()):
        cands = []
        for rep in self._replicas:
            if rep in exclude:
                continue
            if rep.state == HEALTHY:
                cands.append(rep)
            elif rep.state == SUSPECT and rep.inflight == 0:
                # half-open: a suspect carries at most one in-flight probe
                cands.append(rep)
        if not cands:
            return None
        hint = self._affinity_hint(prompt, cands)
        if hint is not None:
            return hint
        return min(cands, key=lambda r: (r.inflight, r.idx))

    def _submit_attempt(self, att, rep=None, timeout=None):
        """Place one attempt: pick a replica (unless pinned), reserve its
        in-flight slot under the lock, submit outside the lock (the engine
        may wait on a bounded queue), then record the rid mapping, claiming
        any result or abort that landed in the gap."""
        fr = att.fr
        exclude = set()
        if att.hedge and fr.primary is not None and fr.primary.rep is not None:
            # a hedge must land on a second replica
            exclude.add(fr.primary.rep)
        if rep is None:
            with self._lock:
                chosen = self._pick_locked(fr.prompt, exclude)
                if chosen is not None:
                    chosen.inflight += 1
            if chosen is None:
                raise FleetUnavailable(
                    "no admissible replica (states: "
                    f"{ {r.tag: r.state for r in self._replicas} })")
        else:
            chosen = rep
            with self._lock:
                chosen.inflight += 1
        lim = fr.max_new if fr.max_new is not None else self._max_new
        max_new2 = None if lim is None else lim - len(att.prefix)
        prompt2 = fr.prompt if not att.prefix else np.concatenate(
            [fr.prompt, np.asarray(att.prefix, np.int32)])
        try:
            rid = chosen.engine.submit(prompt2, max_new_tokens=max_new2, timeout=timeout,
                                       tenant=fr.tenant)
        except Exception:
            # typed engine errors propagate; the reserved slot goes first
            with self._lock:
                chosen.inflight -= 1
            raise
        att.rep = chosen
        att.rid = rid
        claimed = None
        claimed_abort = None
        with self._lock:
            chosen.rid2att[rid] = att
            for pair in list(chosen.unclaimed):
                if pair[0] == rid:
                    chosen.unclaimed.remove(pair)
                    claimed = pair
                    break
            for entry in list(chosen.unclaimed_aborts):
                if entry[0] == rid:
                    chosen.unclaimed_aborts.remove(entry)
                    claimed_abort = entry
                    break
        if claimed is not None:
            # the driver finished this rid before the mapping landed
            with self._lock:
                self._complete_locked(chosen, claimed[0], claimed[1])
        elif claimed_abort is not None:
            # a failover or drain withdrew this rid before the mapping
            # landed: fold the abort in now and re-seed
            with self._lock:
                reroute = self._absorb_abort_locked(chosen, rid, claimed_abort[1],
                                                    claimed_abort[2])
            self._resubmit(reroute)
        return chosen

    # -- replica driver loops ------------------------------------------------
    def _replica_loop(self, rep):
        eng = rep.engine
        poll = self._poll_s
        while not self._stop.is_set():
            rep.heartbeat = time.monotonic()
            st = rep.state
            if st in (PARKED, DOWN):
                time.sleep(poll * 4)
                continue
            if not (eng.num_active or eng.num_pending):
                time.sleep(poll)
                continue
            try:
                # the fleet kill and hang drill site: only when the replica
                # has work, as serving.drive
                _fi.fire("fleet.replica_step")
                if rep.dog is not None:
                    with rep.dog.watch(f"serving.step[{rep.tag}]"):
                        finished = eng.step(self._eos, self._max_new)
                else:
                    finished = eng.step(self._eos, self._max_new)
                rep.steps += 1
                if finished:
                    with self._lock:
                        for rid, toks in finished:
                            self._complete_locked(rep, rid, toks)
            except Exception as e:  # noqa: BLE001 - any replica-loop death
                # fails over and breaks the circuit; the thread never dies
                if self._stop.is_set():
                    return
                self._fail_replica(rep, f"replica {rep.tag} driving loop died: "
                                        f"{type(e).__name__}: {e}")
                continue

    def _complete_locked(self, rep, rid, toks):
        att = rep.rid2att.pop(rid, None)
        if att is None:
            if rid in rep.cancelled_rids:
                rep.cancelled_rids.discard(rid)
            else:
                rep.unclaimed.append((rid, list(toks)))
            return
        rep.inflight -= 1
        fr = att.fr
        st = rep.engine.pop_stats(rid)
        if rep.state == SUSPECT:
            # half-open probe success: close the breaker
            rep.failures = 0
            self._set_state_locked(rep, HEALTHY, "probe success")
        if fr.done:
            return                      # the losing duplicate landed late
        fr.done = True
        fr.tokens = list(att.prefix) + list(toks)
        hedged = fr.hedge is not None
        if hedged:
            loser = fr.primary if att is fr.hedge else fr.hedge
            if att is fr.hedge:
                self.hedge_wins += 1
            if loser is not None and loser.rep is not None:
                self._cancel_attempt_locked(loser.rep, loser.rid)
        self._requests.pop(fr.frid, None)
        self._merge_stats_locked(fr, st, hedged)
        self._results.append((fr.frid, fr.tokens))

    def _cancel_attempt_locked(self, rep, rid):
        """Cancel one placed attempt; idempotent against a completion that
        raced in first (which already removed the mapping)."""
        if rep.rid2att.pop(rid, None) is None:
            return False
        rep.inflight -= 1
        rep.mark_cancelled(rid)
        rep.engine.cancel(rid)
        return True

    def _terminate_attempt(self, att):
        """Last resort for work no replica can take: finish the fleet request
        with the tokens its dead attempt had, so the caller never hangs."""
        with self._lock:
            fr = att.fr
            if fr.done:
                return
            fr.done = True
            fr.tokens = list(att.prefix)
            self._requests.pop(fr.frid, None)
            self._merge_stats_locked(fr, None, False)
            self._results.append((fr.frid, fr.tokens))

    def _merge_stats_locked(self, fr, st, hedged):
        final = {"frid": fr.frid, "tenant": fr.tenant, "prompt_len": len(fr.prompt),
                 "failovers": fr.failovers, "hedged": hedged,
                 "tokens": 0 if fr.tokens is None else len(fr.tokens),
                 "submit_ns": fr.t_submit_ns}
        ttft = fr.stats_base.get("ttft_ns")
        if ttft is None and st is not None and "ttft_ns" in st:
            # the engine measured TTFT from its own submit: shift it onto
            # the fleet clock so queueing and re-routing count too
            ttft = st["ttft_ns"] + st["submit_ns"] - fr.t_submit_ns
        if ttft is not None:
            final["ttft_ns"] = ttft
        final["prefill_chunks"] = fr.stats_base["chunks"] \
            + (0 if st is None else st.get("prefill_chunks", 0))
        final["shared_tokens"] = fr.stats_base["shared_tokens"] \
            + (0 if st is None else st.get("shared_tokens", 0))
        self._final_stats[fr.frid] = final
        while len(self._final_stats) > 4096:
            self._final_stats.popitem(last=False)

    # -- failover ------------------------------------------------------------
    def _fail_replica(self, rep, reason):
        """One replica failure end to end: engine recovery (the warm
        restart), breaker bookkeeping, and re-routing of every in-flight
        request onto the survivors. Concurrent observers of one failure (the
        dying loop, the watchdog scanner) collapse to one pass."""
        if not rep.fail_lock.acquire(blocking=False):
            return
        try:
            rep.engine.recover(reason)
            aborted = rep.engine.pop_aborted()
            withdrawn = rep.engine.withdraw_pending()
            reroute = []
            with self._lock:
                rep.failures += 1
                rep.backoff_until = time.monotonic() + min(
                    self._backoff_base * (2 ** (rep.failures - 1)), self._backoff_cap)
                self._set_state_locked(rep, DOWN, reason)
                for err in aborted:
                    reroute.extend(self._absorb_abort_locked(rep, err.rid, err.tokens,
                                                             err.stats))
                for item in withdrawn:
                    reroute.extend(self._absorb_abort_locked(rep, item["rid"],
                                                             item["outputs"], None))
            self._resubmit(reroute)
        finally:
            rep.fail_lock.release()

    def _resubmit(self, reroute):
        """Place replacement attempts: each lands on a peer, strands for the
        health monitor (total outage), or terminates with its partial tokens;
        withdrawn work is never dropped. Returns how many were placed."""
        rerouted = 0
        for att in reroute:
            att.fr.failovers += 1
            self.failovers += 1
            try:
                self._submit_attempt(att)
                rerouted += 1
            except FleetUnavailable:
                self._stranded.append(att)
            except Exception:  # noqa: BLE001 - a request no replica can take
                # (a re-seeded prompt past its limits) ends with its partial
                # tokens rather than killing the failover pass
                self._terminate_attempt(att)
        return rerouted

    def _absorb_abort_locked(self, rep, rid, tokens, stats):
        """Fold one aborted or withdrawn engine request back into its fleet
        request; returns the replacement attempts to submit (none when a
        live duplicate already covers the work)."""
        att = rep.rid2att.pop(rid, None)
        if att is None:
            if rid in rep.cancelled_rids:
                # a cancelled hedge aborted before its cancel applied
                rep.cancelled_rids.discard(rid)
                return []
            # the mapping has not landed yet: park the abort for
            # _submit_attempt to claim
            rep.unclaimed_aborts.append((rid, list(tokens), stats))
            return []
        rep.inflight -= 1
        fr = att.fr
        if fr.done:
            return []
        if stats:
            if "ttft_ns" in stats and "ttft_ns" not in fr.stats_base:
                fr.stats_base["ttft_ns"] = stats["ttft_ns"] + stats["submit_ns"] \
                    - fr.t_submit_ns
            fr.stats_base["chunks"] += stats.get("prefill_chunks", 0)
            fr.stats_base["shared_tokens"] += stats.get("shared_tokens", 0)
        if att.hedge:
            # the duplicate died; the primary still covers the request
            if fr.hedge is att:
                fr.hedge = None
            return []
        if fr.hedge is not None:
            # the primary died and a live hedge covers the request: promote it
            fr.primary = fr.hedge
            fr.hedge = None
            return []
        # re-seed: the replacement prefills the prompt and every token the
        # dead attempt produced; greedy continuation makes the caller's
        # sequence identical to an undisturbed run
        new = _Attempt(fr, prefix=list(att.prefix) + list(tokens), hedge=False)
        fr.primary = new
        return [new]

    # -- health monitor ------------------------------------------------------
    def _health_main(self):
        """The monitor thread: a failing scan pass is dropped and the loop
        scans again next tick."""
        while not self._stop.is_set():
            try:
                self._health_scan()
            except Exception:  # noqa: BLE001 - scan again next tick
                pass
            if self._stop.wait(self._health_poll):
                return

    def _health_scan(self):
        _fi.fire("fleet.health")
        now = time.monotonic()
        with self._lock:
            for rep in self._replicas:
                if rep.state == DOWN and now >= rep.backoff_until:
                    # half-open: the next routed request is the probe
                    rep.suspect_reason = "probe"
                    self._set_state_locked(rep, SUSPECT, "backoff elapsed (half-open)")
                elif rep.state == HEALTHY and now - rep.heartbeat > self._suspect_after:
                    # the heartbeat is stamped before each step, so a stale one
                    # means a dead thread or one stuck in a step, which
                    # step_open_since tells apart
                    stall = rep.engine.step_open_since
                    why = f"heartbeat stale ({now - rep.heartbeat:.2f}s)"
                    if stall is not None:
                        why += f"; step open {now - stall:.2f}s"
                    rep.suspect_reason = "stale"
                    self._set_state_locked(rep, SUSPECT, why)
                elif rep.state == SUSPECT and rep.suspect_reason == "stale" \
                        and now - rep.heartbeat <= self._suspect_after:
                    self._set_state_locked(rep, HEALTHY, "heartbeat fresh")
        # re-route stranded work once anything admits again
        while self._stranded:
            with self._lock:
                ok = self._pick_locked(None) is not None
            if not ok:
                break
            try:
                att = self._stranded.popleft()
            except IndexError:
                break
            if not att.fr.done:
                try:
                    self._submit_attempt(att)
                except FleetUnavailable:
                    self._stranded.appendleft(att)
                    break
                except Exception:  # noqa: BLE001 - unplaceable on the healed
                    # replica too: end with its partial tokens
                    self._terminate_attempt(att)
        if self.hedge_after_s is not None:
            self._maybe_hedge(now)

    def _maybe_hedge(self, now):
        """Tail hedging: requests older than the threshold get a bounded
        duplicate on a second replica; the first finisher wins."""
        todo = []
        with self._lock:
            live_hedges = sum(1 for fr in self._requests.values()
                              if fr.hedge is not None and not fr.done)
            budget = self.max_hedges - live_hedges
            if budget <= 0:
                return
            for fr in self._requests.values():
                if budget <= 0:
                    break
                if fr.done or fr.hedge is not None:
                    continue
                if now - fr.t_submit_mono < self.hedge_after_s:
                    continue
                todo.append(fr)
                budget -= 1
        for fr in todo:
            primary = fr.primary
            att = _Attempt(fr, prefix=() if primary is None else primary.prefix, hedge=True)
            try:
                rep = self._submit_attempt(att)
            except FleetUnavailable:
                continue                # no second replica: hedge later
            with self._lock:
                if fr.done:
                    # the primary finished while the hedge was placed
                    self._cancel_attempt_locked(rep, att.rid)
                    continue
                fr.hedge = att
            self.hedges += 1

    # -- graceful drain and rolling restart ----------------------------------
    def drain(self, replica, timeout=30.0):
        """Drain one replica for a rolling restart: stop its admission, move
        its queued work to the peers, let its active slots finish, then park
        it. No request is lost. Returns ``{"replica", "migrated",
        "parked"}`` (``parked`` False when ``timeout`` elapsed with work still
        active: the replica stays draining and the call can be repeated)."""
        rep = self._replicas[int(replica)]
        with self._lock:
            if rep.state == PARKED:
                return {"replica": rep.tag, "migrated": 0, "parked": True}
            self._set_state_locked(rep, DRAINING, "drain requested")
        withdrawn = rep.engine.withdraw_pending()
        reroute = []
        with self._lock:
            for item in withdrawn:
                reroute.extend(self._absorb_abort_locked(rep, item["rid"], item["outputs"],
                                                         None))
        for att in reroute:
            # as a failover pass: withdrawn work lands on a peer, strands for
            # the health monitor, or ends with its partial tokens
            try:
                self._submit_attempt(att)
            except FleetUnavailable:
                self._stranded.append(att)
            except Exception:  # noqa: BLE001
                self._terminate_attempt(att)
        deadline = time.monotonic() + float(timeout)
        while time.monotonic() < deadline:
            with self._lock:
                if rep.inflight == 0:
                    break
            time.sleep(self._poll_s)
        parked = False
        with self._lock:
            if rep.inflight == 0 and rep.state == DRAINING:
                self._set_state_locked(rep, PARKED, "drained")
                parked = True
        if parked:
            self.drains += 1
        return {"replica": rep.tag, "migrated": len(reroute), "parked": parked}

    def resume(self, replica):
        """Bring a parked (or down or draining) replica back into rotation."""
        rep = self._replicas[int(replica)]
        rep.heartbeat = time.monotonic()
        with self._lock:
            rep.failures = 0
            self._set_state_locked(rep, HEALTHY, "resumed")

    # -- actuators ------------------------------------------------------------
    def active_replicas(self):
        """Replicas in rotation (every state but parked)."""
        with self._lock:
            return sum(1 for r in self._replicas if r.state != PARKED)

    def scale_to(self, n, drain_timeout=10.0):
        """Move the active replica count to ``n`` (clamped to ``[1,
        len(replicas)]``) through drain and resume: scaling up resumes
        parked replicas (warm engines, nothing rebuilt), scaling down drains
        the highest-index active ones. Returns the active count after."""
        n = max(1, min(int(n), len(self._replicas)))
        with self._lock:
            active = [r for r in self._replicas if r.state != PARKED]
            parked = [r for r in self._replicas if r.state == PARKED]
        cur = len(active)
        if n > cur:
            for rep in parked[:n - cur]:
                self.resume(rep.idx)
        elif n < cur:
            for rep in sorted(active, key=lambda r: -r.idx)[:cur - n]:
                self.drain(rep.idx, timeout=drain_timeout)
        return self.active_replicas()

    def set_engine_knobs(self, **knobs):
        """Stage engine knob changes (``chunk_size``, ``decode_burst``,
        ``max_queue``, ``decode_priority``) on every replica engine; each
        applies them at its next step boundary."""
        for rep in self._replicas:
            rep.engine.request_knobs(**knobs)

    # -- introspection -------------------------------------------------------
    def _set_state_locked(self, rep, new, reason):
        old = rep.state
        if old == new:
            return
        rep.state = new
        self.state_log.append((rep.tag, old, new, reason))

    def states(self):
        """{replica tag: health state} snapshot."""
        with self._lock:
            return {rep.tag: rep.state for rep in self._replicas}

    def replica_snapshot(self):
        """One row a replica: health and breaker state plus the engine's host
        counters."""
        now = time.monotonic()
        with self._lock:
            rows = [{
                "replica": rep.tag,
                "state": rep.state,
                "failures": rep.failures,
                "backoff_remaining_s": round(max(0.0, rep.backoff_until - now), 4)
                if rep.state == DOWN else 0.0,
                "suspect_reason": rep.suspect_reason,
                "inflight": rep.inflight,
                "steps": rep.steps,
                "heartbeat_age_s": round(now - rep.heartbeat, 4),
                "thread_alive": bool(rep.thread is not None and rep.thread.is_alive()),
            } for rep in self._replicas]
        for row, rep in zip(rows, self._replicas):
            # engine counters, read outside the router lock
            row["active"] = rep.engine.num_active
            row["pending"] = rep.engine.num_pending
        return rows

    def status(self):
        """Per-replica health and breaker rows, each engine's own status and
        the router's host counters."""
        rows = self.replica_snapshot()
        admissible = sum(1 for r in rows if r["state"] in (HEALTHY, SUSPECT))
        return {
            "health": "ok" if admissible else "degraded",
            "replicas": rows,
            "engines": {rep.tag: rep.engine.status() for rep in self._replicas},
            "requests_total": self.requests_total,
            "inflight": self.num_inflight,
            "stranded": self.num_stranded,
            "failovers": self.failovers,
            "hedges": self.hedges,
            "hedge_wins": self.hedge_wins,
            "drains": self.drains,
            "hedge_after_s": self.hedge_after_s,
            "max_hedges": self.max_hedges,
            "burn_aware_routing": self.burn_aware_routing,
        }

    def fleet_prometheus_text(self):
        """The fleet's Prometheus document: not ported (the monitor)."""
        raise NotImplementedError(f"fleet_prometheus_text {_ITEM7}")

    def fleet_snapshot(self):
        """The fleet's monitor snapshot: not ported (the monitor)."""
        raise NotImplementedError(f"fleet_snapshot {_ITEM7}")

    @property
    def replicas(self):
        return list(self._replicas)

    @property
    def num_inflight(self):
        with self._lock:
            return len(self._requests)

    @property
    def num_stranded(self):
        return len(self._stranded)
