"""Continuous-batching serving engine: the port of paddle_tpu/models/serving.py.

Chunked prefill and prefix-shared paged KV over two fixed-shape programs:

1. **Token-budget mixed step.** Every step packs up to ``max_step_tokens``
   lanes from decode slots (one token each), draft-verify lanes and prefill
   chunks of admitted requests (up to ``chunk_size`` tokens) into a (2, T)
   pack run by one program (``LlamaDecodeEngine.build_mixed_step``). New
   requests join the running batch without draining it, and prompts never
   pad to buckets.
2. **Decode burst.** When no prefill or admission work is pending, up to
   ``decode_burst`` decode iterations run as one program
   (``LlamaDecodeEngine.build_decode_burst``).
3. **Radix prefix cache.** Full KV blocks are content-hashed at prefill
   (``models/radix_cache.py``); admission maps every shared block read-only
   into the request's table, and a block-aligned full hit re-runs only the
   last prompt token, whose write copies the shared tail block.
4. **Scheduler policy and backpressure.** FCFS or shortest-prefill-first,
   ``decode_priority``, tenant lanes with weighted-fair admission, priority
   shedding and a bounded ``submit()`` queue.
5. **Resilience.** With ``kv_spill`` the radix cache parks evicted blocks in
   host RAM and pool pressure preempts the lowest-priority request that is
   not decoding (its K/V to host RAM, restored bit for bit on re-admission;
   as in the JAX engine, a dry pool with every slot decoding still raises). ``recover()`` aborts
   every in-flight request with a typed :class:`RequestAborted` carrying its
   partial tokens and restarts warm (the radix cache and the captured
   programs survive); ``start_driver()`` runs the engine on a driving thread
   that recovers and relaunches itself when a step dies, and with
   ``hang_timeout`` a watchdog recovers a step that hangs. ``cancel``,
   ``withdraw_pending``, ``request_knobs`` and ``status`` are the surface
   the fleet router (``serving/fleet.py``) drives.

On a CUDA device each program is captured once per engine as a
``torch.cuda.CUDAGraph`` (the port's counterpart of the JAX engine's two
donated ``jax.jit`` programs) over static input buffers; the pools are the
pager's own tensors, written in place, so a spill restore, a recovery or a
copy-on-write changes what the graphs read without a new capture. Host work
(admission, block grants, copy-on-write, the radix cache, routing) runs
between replays; each replay is one host-to-device copy of the pack, device
copies of the tables and lane vectors, the replay and one device-to-host
copy of the result. A capture tolerates other threads' CUDA work (replica
threads of a fleet capture and replay side by side) and a capture that fails
raises: nothing falls back to eager execution on the card. On the CPU the
engine calls the same functions eagerly.

:class:`StaticBatchEngine` keeps the old architecture (batch-synchronous
waves, one bucket-padded prefill per admission through the flash-attention
kernel, lockstep decode) as the baseline the bench compares against. It runs
eagerly.

The fault points ``serving.step``, ``serving.drive``, ``serving.admission``
and ``serving.spec_verify`` fire where the JAX package fires them. Not
ported (the observability slice, ROADMAP Queue A item 7): the monitor
metrics, the trace spans and flight dumps (``last_recovery_dump`` and a
recovery's ``"dump"`` stay ``None``), the sanitizer hooks and the
``/statusz`` registration.
"""
from __future__ import annotations

import collections
import itertools
import threading
import time

import numpy as np
import torch

from ..analysis import faultinject as _fi
from ..incubate.nn.functional import _rope_tables
from ..jit._cuda_graph import _Program
from . import paged_kv as _pk
from .llama_decode import LlamaDecodeEngine, _row_rope_tables
from .radix_cache import PrefixCache
from .spec_decode import SuffixDrafter

__all__ = ["ContinuousBatchingEngine", "StaticBatchEngine", "AdmissionTimeout",
           "RequestShed", "RequestAborted"]

_ENGINE_SEQ = itertools.count()


class AdmissionTimeout(RuntimeError):
    """submit() could not enqueue within the caller's timeout: the admission
    queue stayed full (backpressure: shed load upstream)."""


class RequestShed(AdmissionTimeout):
    """Load-shedding rejection: under overload the engine sheds the lowest
    priority work; this request (or a queued victim, surfaced through
    :meth:`ContinuousBatchingEngine.pop_shed`) was it. ``tenant`` names who
    was shed."""

    def __init__(self, message, tenant="", rid=None):
        super().__init__(message)
        self.tenant = tenant
        self.rid = rid


class RequestAborted(RuntimeError):
    """An in-flight request aborted by engine recovery (a dead or hung
    driving thread). ``tokens`` carries the partial output, so the caller can
    resume instead of hanging, and ``stats`` the request's partial
    ``pop_stats`` record (``ttft_ns`` if the first token had landed, prefill
    chunks, shared prefix tokens), so a router that re-routes the work can
    merge them into the replacement's final stats."""

    def __init__(self, message, rid=None, tokens=(), tenant="", stats=None):
        super().__init__(message)
        self.rid = rid
        self.tokens = list(tokens)
        self.tenant = tenant
        self.stats = stats


class _Request:
    """Host-side state of one admitted request (one slot)."""

    __slots__ = ("rid", "prompt", "prefill_pos", "chunks", "shared_tokens",
                 "max_new", "last_token", "outputs", "t_submit", "t_admit",
                 "t_first", "tenant", "priority", "spill")

    def __init__(self, rid, prompt, max_new, t_submit, tenant="", priority=0):
        self.rid = rid
        self.prompt = prompt            # np.int32 (L,)
        self.prefill_pos = 0            # prompt tokens already in KV
        self.chunks = 0                 # prefill chunks consumed so far
        self.shared_tokens = 0          # prompt tokens served by the cache
        self.max_new = max_new          # per-request cap (None = the step's)
        self.last_token = 0
        self.outputs = []
        self.t_submit = t_submit
        self.t_admit = 0
        self.t_first = 0
        self.tenant = tenant
        self.priority = priority
        # preemption payload (tokens in KV, per-layer host K/V, decode_ready):
        # set between a preemption and the re-admission that restores it
        self.spill = None

    @property
    def prefilled(self):
        return self.prefill_pos >= len(self.prompt)


class _Tenant:
    """One tenant's admission lane: weighted-fair share (stride scheduling
    over ``1 / weight``) within its priority class."""

    __slots__ = ("name", "weight", "priority", "vtime", "queue")

    def __init__(self, name, weight=1.0, priority=0):
        self.name = name
        self.weight = float(weight)
        if self.weight <= 0:
            raise ValueError("tenant weight must be > 0")
        self.priority = int(priority)
        self.vtime = 0.0
        self.queue = collections.deque()


def _drain(dq):
    """Drain a deque that other threads may still be appending to
    (popleft until empty is the atomic deque idiom; no lock)."""
    out = []
    while True:
        try:
            out.append(dq.popleft())
        except IndexError:
            return out


def _pool_layout(pager, kv_int8):
    """The per-layer pool entries and their total device bytes: 4-leaf
    (int8 K/V values + fp32 per-(token, head) scales) when quantized, else
    2-leaf (k, v)."""
    if kv_int8:
        pools = list(zip(pager.k, pager.k_scale, pager.v, pager.v_scale))
    else:
        pools = list(zip(pager.k, pager.v))
    nbytes = int(sum(leaf.numel() * leaf.element_size() for entry in pools for leaf in entry))
    return pools, nbytes


class ContinuousBatchingEngine:
    """Token-budget continuous batching: every step runs one fixed-shape
    program over a pack of decode lanes and chunked-prefill lanes (or, in
    steady decode, the burst program); requests join and leave between
    steps, shared prompt prefixes ride the radix cache.

    Threading contract: ``submit()``, ``cancel()``, ``request_knobs()``,
    ``withdraw_pending()`` and ``recover()`` are thread-safe (queue and book
    surgery under ``_submit_lock``, where nothing blocks and no CUDA work
    runs); ``step()`` and ``add_request()`` change slot, pager and cache
    state and belong to one driving thread (``start_driver()`` runs one)."""

    def __init__(self, model, max_batch=8, max_len=None, block_size=64,
                 chunk_size=32, max_step_tokens=None, policy="fcfs",
                 decode_priority=0.0, decode_burst=4, max_queue=None,
                 prefix_cache=True, prefill_buckets=None, kv_spill=False,
                 spill_capacity_blocks=None, strict_priority=False,
                 kv_cache_dtype=None, spec_lookahead=0, spec_ngram=3,
                 pool_blocks=None):
        """``max_step_tokens`` (default ``max_batch + chunk_size``) is the
        per-step token budget: decode lanes first, prefill chunks fill the
        rest. ``policy`` orders prefill ("fcfs" | "spf", shortest prefill
        first). ``decode_priority`` in [0, 1) caps prefill at ``(1 -
        decode_priority) * max_step_tokens`` lanes a step. ``decode_burst``
        fuses up to that many decode iterations into one program when no
        prefill or admission work is pending (1 disables it). ``max_queue``
        bounds the submit() queue. ``prefill_buckets`` is accepted and
        ignored, as in the JAX engine. ``kv_spill`` turns on the host-RAM
        resilience layer: radix evictions park their K/V in host RAM (at most
        ``spill_capacity_blocks`` blocks, LRU) and a grant the cache cannot
        relieve preempts the lowest-priority request that is not decoding
        instead of failing the step. ``strict_priority`` defers queued work while a strictly
        higher-priority request is active. ``kv_cache_dtype="int8"`` runs the
        whole engine on quantized pools. ``spec_lookahead`` > 0 enables
        self-speculative decoding (``models/spec_decode.py``) with up to that
        many draft lanes a decode slot; ``spec_ngram`` bounds the drafter's
        n-gram length. ``pool_blocks`` overrides the pool size (default:
        ``max_batch`` max-length requests)."""
        del prefill_buckets
        self._inner = LlamaDecodeEngine(model, max_len=max_len, kv_cache_layout="paged",
                                        block_size=block_size,
                                        kv_cache_dtype=kv_cache_dtype)
        e = self._inner
        self.device = e.device
        self.max_batch = int(max_batch)
        self.max_len = e.max_len
        self.block_size = int(block_size)
        self.chunk_size = int(chunk_size)
        if self.chunk_size < 1:
            raise ValueError("chunk_size must be >= 1")
        self.max_step_tokens = int(max_step_tokens or self.max_batch + self.chunk_size)
        if self.max_step_tokens <= self.max_batch:
            raise ValueError(
                f"max_step_tokens ({self.max_step_tokens}) must exceed "
                f"max_batch ({self.max_batch}): every active slot gets a "
                "decode lane and prefill needs at least one more")
        if policy not in ("fcfs", "spf"):
            raise ValueError(f"unknown policy {policy!r} (fcfs | spf)")
        self.policy = policy
        self.decode_priority = float(decode_priority)
        if not 0.0 <= self.decode_priority < 1.0:
            raise ValueError("decode_priority must be in [0, 1)")
        self.decode_burst = max(1, int(decode_burst))
        self.max_queue = None if max_queue is None else int(max_queue)
        self.strict_priority = bool(strict_priority)
        max_blocks = -(-e.max_len // self.block_size)
        num_blocks = self.max_batch * max_blocks + 1 if pool_blocks is None \
            else max(int(pool_blocks), max_blocks + 2)
        self._pager = _pk.PagedKVCache(
            num_layers=len(e.layers), num_blocks=num_blocks, block_size=self.block_size,
            kv_heads=e.num_kv, head_dim=e.head_dim, batch=self.max_batch,
            max_blocks_per_seq=max_blocks, dtype=e.emb.dtype, quantized=e.kv_int8,
            device=self.device)
        self._pools, self.kv_pool_bytes = _pool_layout(self._pager, e.kv_int8)
        self.kv_cache_dtype = kv_cache_dtype
        self.kv_spill = bool(kv_spill)
        self.prefix_cache = PrefixCache(self._pager, spill=self.kv_spill,
                                        spill_capacity_blocks=spill_capacity_blocks) \
            if prefix_cache else None
        self.spec_lookahead = max(0, int(spec_lookahead))
        if self.spec_lookahead:
            self._drafter = SuffixDrafter(lookahead=self.spec_lookahead,
                                          max_ngram=int(spec_ngram),
                                          prefix_cache=self.prefix_cache)
        else:
            self._drafter = None
        self.spec_drafted = 0
        self.spec_accepted = 0
        # per-slot radix-registration cursors (see _register_decode_blocks)
        self._chain_cursors = {}
        # host-side slot state (numpy, so pack assembly vectorizes)
        self.lens = np.zeros(self.max_batch, np.int64)  # tokens in cache
        self._slots = [None] * self.max_batch           # _Request or None
        self._active = np.zeros(self.max_batch, bool)
        self._decode_ready = np.zeros(self.max_batch, bool)
        self._last_tok = np.zeros(self.max_batch, np.int32)
        # device lane vectors keyed by pack composition (steady decode
        # repeats its composition every step)
        self._lane_cache = {}
        self._next_rid = 0
        # the two programs, "step" and "burst", each built (and on CUDA
        # captured) once per engine; a decode_burst knob change drops "burst"
        self._jit_cache = {}
        # the burst runs at the mixed step's T lanes (attending only the lane
        # groups that hold its B rows), so a decode token is computed with the
        # same shapes, and so the same library kernels and rounding, whichever
        # program computes it
        self._burst_rows = self.max_step_tokens
        # the engine's tag in status() and its driving thread's name
        self._tag = f"e{next(_ENGINE_SEQ)}"
        # submit() queues, one lane per tenant; _submit_lock guards the
        # bounded check and append only: nothing blocks under it
        self._tenants = {"": _Tenant("")}
        self._vnow = 0.0                # WFQ virtual clock (last pop)
        self._submit_lock = threading.Lock()
        self._stats = collections.OrderedDict()
        # -- resilience state (recover, the driving thread, shedding) --------
        self._epoch = 0                 # bumped by every recover()
        self._recover_lock = threading.Lock()
        self._shed = collections.deque(maxlen=4096)     # RequestShed
        self._aborted = collections.deque(maxlen=4096)  # RequestAborted
        self._results = collections.deque(maxlen=4096)  # driver-mode results
        self._driver = None
        self._drive_stop = threading.Event()
        self._drive_args = None
        self._dog = None
        # [{reason, ms, aborted, cold, dump}], bounded
        self.recovery_stats = collections.deque(maxlen=256)
        self.last_recovery_dump = None
        # -- the fleet-facing surface -----------------------------------------
        # knob changes staged by request_knobs() under _submit_lock and
        # applied by the driving thread at the top of step()
        self._pending_knobs = {}
        # cancellations (thread-safe enqueue; the driving thread applies them
        # at the next step boundary)
        self._cancel_q = collections.deque()
        self.cancelled = 0
        # host counters of the spill path (the JAX engine's are monitor
        # metrics): preemptions, their restores, and the bytes spilled
        self.preemptions = 0
        self.preempt_restores = 0
        self.spilled_bytes = 0
        # monotonic start of the step in flight (None between steps): the
        # fleet health monitor's step-staleness signal
        self.step_open_since = None

    # -- the two programs ----------------------------------------------------
    def _step_jit(self):
        if "step" not in self._jit_cache:
            self._jit_cache["step"] = _Program(self._inner.build_mixed_step(), self._pools)
        return self._jit_cache["step"]

    def _burst_jit(self):
        if "burst" not in self._jit_cache:
            self._jit_cache["burst"] = _Program(
                self._inner.build_decode_burst(self.decode_burst, rows=self._burst_rows),
                self._pools)
        return self._jit_cache["burst"]

    # -- admission -----------------------------------------------------------
    def _check_prompt(self, prompt_ids):
        prompt = np.asarray(getattr(prompt_ids, "value", prompt_ids), np.int32).reshape(-1)
        L = len(prompt)
        if L == 0 or L >= self.max_len:
            raise ValueError(f"prompt length {L} out of range (1..{self.max_len - 1})")
        # a prompt whose KV can never fit the pool would block the queue
        need = -(-(L + 1) // self.block_size)
        if need > self._pager.num_blocks - 1:  # block 0 is the null block
            raise ValueError(f"prompt needs {need} KV blocks but the pool only has "
                             f"{self._pager.num_blocks - 1}")
        return prompt

    # -- tenants (weighted-fair queuing, priority lanes, load shedding) ------
    def set_tenant(self, name, weight=1.0, priority=0):
        """Configure (or reconfigure) a tenant lane: ``weight`` is its
        weighted-fair share of admissions within its priority class,
        ``priority`` the lane class (higher admits first; the lowest sheds
        first under overload)."""
        with self._submit_lock:
            t = self._tenants.get(name)
            if t is None:
                t = self._tenants[name] = _Tenant(name, weight, priority)
                t.vtime = self._vnow
            else:
                new_w = float(weight)
                if new_w <= 0:
                    raise ValueError("tenant weight must be > 0")
                t.weight = new_w
                t.priority = int(priority)

    def _tenant_locked(self, name):
        t = self._tenants.get(name)
        if t is None:
            t = self._tenants[name] = _Tenant(name)
            t.vtime = self._vnow
        return t

    def _prioritized(self):
        return len({t.priority for t in list(self._tenants.values())}) > 1

    def _shed_victim_locked(self, priority):
        """The queued request shed for a priority-``priority`` arrival: the
        newest request of the lowest-priority non-empty lane strictly below
        the arrival."""
        best = None
        for t in self._tenants.values():
            if not t.queue or t.priority >= priority:
                continue
            if best is None or t.priority < best.priority:
                best = t
        if best is None:
            return None
        return best, best.queue.pop()    # newest: it waited least

    def _shed_locked(self, ten, req, why):
        self._shed.append(RequestShed(
            f"request {req.rid} (tenant {ten.name!r}) shed under overload: {why}",
            tenant=ten.name, rid=req.rid))
        self._stats[req.rid] = {"rid": req.rid, "tenant": ten.name, "shed": True,
                                "prompt_len": len(req.prompt), "submit_ns": req.t_submit}
        while len(self._stats) > 4096:
            self._stats.popitem(last=False)

    def pop_shed(self):
        """Drain the :class:`RequestShed` records of queued requests displaced
        by higher-priority arrivals."""
        return _drain(self._shed)

    def add_request(self, prompt_ids, max_new_tokens=None, tenant=""):
        """Admit one prompt into a free slot; returns the request id, or None
        when the batch is full. The prompt's KV is built by chunked prefill
        inside later step() packs."""
        prompt = self._check_prompt(prompt_ids)
        self._drain_pending()
        slot = self._free_slot()
        if slot is None:
            return None
        with self._submit_lock:
            ten = self._tenant_locked(tenant)
            rid = self._next_rid
            self._next_rid += 1
        req = _Request(rid, prompt, max_new_tokens, time.perf_counter_ns(), tenant=tenant,
                       priority=ten.priority)
        self._admit(slot, req)
        return rid

    def submit(self, prompt_ids, max_new_tokens=None, timeout=None, tenant=""):
        """Always-queueing admission, the engine's thread-safe entry point:
        the request waits host-side until the driving thread's next step()
        (or add_request()) assigns it a slot. With ``max_queue``, a full
        queue first sheds the newest queued request of a strictly
        lower-priority tenant (surfaced through :meth:`pop_shed`); when
        nothing is outranked it raises, at once when ``timeout`` is None,
        else after waiting up to ``timeout`` seconds: :class:`RequestShed`
        when priority lanes are configured, else :class:`AdmissionTimeout`."""
        prompt = self._check_prompt(prompt_ids)
        t_submit = time.perf_counter_ns()
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            with self._submit_lock:
                ten = self._tenant_locked(tenant)
                total = sum(len(t.queue) for t in self._tenants.values())
                victim = None
                if self.max_queue is not None and total >= self.max_queue:
                    victim = self._shed_victim_locked(ten.priority)
                if self.max_queue is None or total < self.max_queue or victim is not None:
                    if victim is not None:
                        self._shed_locked(
                            victim[0], victim[1],
                            f"displaced by a priority-{ten.priority} arrival (queue full "
                            f"at {self.max_queue})")
                    rid = self._next_rid
                    self._next_rid += 1
                    req = _Request(rid, prompt, max_new_tokens, t_submit, tenant=tenant,
                                   priority=ten.priority)
                    if not ten.queue:
                        # an idle lane re-syncs to the virtual clock
                        ten.vtime = max(ten.vtime, self._vnow)
                    ten.queue.append(req)
                    return rid
            if deadline is None or time.monotonic() >= deadline:
                if self._prioritized():
                    raise RequestShed(
                        f"load shed: admission queue full ({self.max_queue} requests) "
                        f"and tenant {tenant!r} (priority {ten.priority}) outranks no "
                        "queued work", tenant=tenant)
                raise AdmissionTimeout(
                    f"admission queue full ({self.max_queue} requests)"
                    + ("" if timeout is None else f" after {timeout}s wait"))
            time.sleep(0.0005)   # poll; the lock is never held while waiting

    def _free_slot(self):
        for b in range(self.max_batch):
            if self._slots[b] is None:
                return b
        return None

    def _pop_pending(self):
        """Next queued request: highest priority class first, weighted-fair
        among that class's tenants, then the policy (fcfs | spf) within the
        chosen tenant's lane."""
        with self._submit_lock:
            ready = [t for t in self._tenants.values() if t.queue]
            if not ready:
                return None
            pmax = max(t.priority for t in ready)
            if self.strict_priority:
                act = [s.priority for s in self._slots if s is not None]
                if act and pmax < max(act):
                    return None
            cands = [t for t in ready if t.priority == pmax]
            ten = min(cands, key=lambda t: (t.vtime, t.name))
            self._vnow = ten.vtime
            ten.vtime += 1.0 / ten.weight
            if self.policy == "spf":
                req = min(ten.queue, key=lambda r: len(r.prompt))
                ten.queue.remove(req)
                return req
            return ten.queue.popleft()

    def _requeue_front(self, req):
        """Head-of-lane requeue of a preempted request (admitted once, it
        resumes before its tenant's new arrivals)."""
        with self._submit_lock:
            self._tenant_locked(req.tenant).queue.appendleft(req)

    def _drain_pending(self):
        """Assign queued requests to free slots (driving thread only)."""
        _fi.fire("serving.admission")
        while True:
            slot = self._free_slot()
            if slot is None:
                return
            req = self._pop_pending()
            if req is None:
                return
            if req.spill is not None:
                if not self._restore(slot, req):
                    # no room to restore the preempted K/V: park it at the
                    # head of its lane and stop admitting until an eviction
                    # frees blocks; refund the WFQ charge _pop_pending took
                    self._requeue_front(req)
                    with self._submit_lock:
                        ten = self._tenant_locked(req.tenant)
                        ten.vtime -= 1.0 / ten.weight
                    return
            else:
                self._admit(slot, req)

    def _admit(self, slot, req):
        req.t_admit = time.perf_counter_ns()
        L = len(req.prompt)
        # radix descent: map every cached prefix block read-only into the new
        # request's table; a full (block-aligned) hit still re-runs the last
        # prompt token, whose write copies the shared tail block
        if self.prefix_cache is not None:
            blocks, shared = self.prefix_cache.match(req.prompt)
            if self.kv_spill:
                # evicted prefixes parked in host RAM rejoin the chain here,
                # written back in place into fresh pool blocks
                blocks, shared, _pools = self.prefix_cache.restore_chain(
                    req.prompt, blocks, shared, self._pools)
            if blocks:
                self._pager.adopt_blocks(slot, blocks)
                req.shared_tokens = shared
                req.prefill_pos = min(shared, L - 1)
        self.lens[slot] = req.prefill_pos
        self._slots[slot] = req
        self._active[slot] = True
        self._decode_ready[slot] = False
        self._chain_cursors.pop(slot, None)
        if self._drafter is not None:
            self._drafter.admit(req.rid, req.prompt)
        with self._submit_lock:
            self._stats[req.rid] = {
                "rid": req.rid, "slot": slot, "prompt_len": L, "tenant": req.tenant,
                "shared_tokens": req.shared_tokens, "submit_ns": req.t_submit}
            if len(self._stats) > 4096:
                self._stats.popitem(last=False)

    def pop_stats(self, rid):
        """Per-request stats (ttft_ns, prefill_chunks, shared prefix tokens,
        tokens), kept until popped."""
        with self._submit_lock:
            return self._stats.pop(rid, None)

    def status(self):
        """Host-readable state (counters, pool headroom, programs built,
        the last recovery): no CUDA work and no lock, safe to call from any
        thread while another drives step(). ``compiled_programs`` counts the
        programs built; on the card each is captured at its first call."""
        pager = self._pager
        free = len(pager._free)
        total = pager.num_blocks - 1          # block 0 is the null block
        doc = {
            "engine": self._tag,
            "health": "ok",
            "active": int(self._active.sum()),
            "pending": self.num_pending,
            "max_batch": self.max_batch,
            "kv": {
                "free_blocks": free,
                "total_blocks": total,
                "headroom": round(free / max(total, 1), 4),
                "pool_bytes": int(self.kv_pool_bytes),
                "dtype": self.kv_cache_dtype or "full",
            },
            "compiled_programs": len(self._jit_cache),
            "epoch": self._epoch,
            "recoveries": len(self.recovery_stats),
            "cancelled": self.cancelled,
            "driver_alive": bool(self._driver is not None and self._driver.is_alive()),
            "knobs": {
                "chunk_size": self.chunk_size,
                "decode_burst": self.decode_burst,
                "decode_priority": self.decode_priority,
                "max_queue": self.max_queue,
            },
        }
        if self.recovery_stats:
            doc["last_recovery"] = dict(self.recovery_stats[-1])
        opened = self.step_open_since
        if opened is not None:
            doc["step_open_s"] = round(time.monotonic() - opened, 4)
        if self._drafter is not None:
            doc["spec"] = {
                "drafted": self.spec_drafted,
                "accepted": self.spec_accepted,
                "accept_rate": round(self.spec_accepted / max(self.spec_drafted, 1), 4),
            }
        if self.prefix_cache is not None:
            doc["kv"]["prefix_cache_blocks"] = len(self.prefix_cache)
        return doc

    # -- preemption and restore (host-RAM K/V spill under pool pressure) -----
    def _preempt_lowest(self, exclude=()):
        """Preempt the lowest-priority active request (ties: the newest): its
        exact K/V goes to host RAM, its blocks back to the pool, and it
        rejoins the head of its tenant's lane, restored bit for bit by
        :meth:`_restore` on re-admission. Returns the freed slot, or None
        when nothing can be preempted."""
        skip = set(int(b) for b in exclude)
        cands = [b for b in range(self.max_batch)
                 if self._slots[b] is not None and b not in skip]
        if not cands:
            return None
        slot = min(cands, key=lambda b: (self._slots[b].priority, -self._slots[b].rid))
        req = self._slots[slot]
        n_tok = int(self.lens[slot])
        nblk = -(-n_tok // self.block_size) if n_tok else 0
        contents = None
        if nblk:
            blocks = [int(b) for b in self._pager._tables_np[slot][:nblk]]
            contents = _pk.read_blocks(self._pools, blocks)
        req.spill = (n_tok, contents, bool(self._decode_ready[slot]))
        self._pager.free_sequence(slot)
        self._slots[slot] = None
        self._active[slot] = False
        self._decode_ready[slot] = False
        self.lens[slot] = 0
        self._chain_cursors.pop(slot, None)
        if self._drafter is not None:
            self._drafter.drop(req.rid)   # _restore admits the context again
        self._requeue_front(req)
        self.preemptions += 1
        self.spilled_bytes += 0 if contents is None else int(sum(
            leaf.numel() * leaf.element_size() for entry in contents for leaf in entry))
        return slot

    def _restore(self, slot, req):
        """Re-admit a preempted request: fresh blocks, the spilled K/V written
        back in place at the same in-block offsets, slot state rebuilt; the
        continuation is bit-identical to an undisturbed run. Returns False,
        leaving the request untouched, when the pool lacks the blocks even
        after cache relief."""
        n_tok, contents, decode_ready = req.spill
        nblk = -(-n_tok // self.block_size) if n_tok else 0
        blks = []
        if nblk:
            blks = self._pager.take_blocks(nblk)
            if blks is None and self.prefix_cache is not None and len(self.prefix_cache):
                self.prefix_cache.evict(nblk, pools=self._pools)
                blks = self._pager.take_blocks(nblk)
            if blks is None:
                return False
        req.t_admit = time.perf_counter_ns()
        if nblk:
            self._pager.place_blocks(slot, blks)
            self._pager.write_block_contents(self._pools, blks, contents)
        req.spill = None
        self.lens[slot] = n_tok
        self._slots[slot] = req
        self._active[slot] = True
        self._decode_ready[slot] = decode_ready
        self._last_tok[slot] = req.last_token
        self._chain_cursors.pop(slot, None)
        if self._drafter is not None:
            # rebuild the draft context (prompt and every token emitted so
            # far), so the restored request speculates as an undisturbed one
            ctx = req.prompt if not req.outputs else np.concatenate(
                [req.prompt, np.asarray(req.outputs, np.int32)])
            self._drafter.drop(req.rid)
            self._drafter.admit(req.rid, ctx)
        with self._submit_lock:
            st = self._stats.get(req.rid)
            if st is None:
                st = self._stats[req.rid] = {
                    "rid": req.rid, "prompt_len": len(req.prompt), "tenant": req.tenant,
                    "shared_tokens": req.shared_tokens, "submit_ns": req.t_submit}
            st["slot"] = slot
            st["restored"] = True
        self.preempt_restores += 1
        return True

    # -- staged knob changes -------------------------------------------------
    _KNOB_NAMES = ("chunk_size", "decode_burst", "decode_priority", "max_queue")

    def request_knobs(self, **knobs):
        """Stage serving-knob changes for the next step boundary
        (thread-safe): ``chunk_size``, ``decode_burst``, ``decode_priority``,
        ``max_queue``. Values are checked here; the driving thread applies
        them at the top of :meth:`step`, so a knob never changes mid-step. A
        ``decode_burst`` change drops the burst program: the next
        burst-eligible step builds (on the card, captures) it once with the
        new K."""
        staged = {}
        for name, v in knobs.items():
            if name not in self._KNOB_NAMES:
                raise ValueError(f"unknown serving knob {name!r} (known: {self._KNOB_NAMES})")
            if name == "max_queue":
                v = None if v is None else max(1, int(v))
            elif name == "decode_priority":
                v = float(v)
                if not 0.0 <= v < 1.0:
                    raise ValueError("decode_priority must be in [0, 1)")
            else:
                v = max(1, int(v))
            staged[name] = v
        with self._submit_lock:
            self._pending_knobs.update(staged)

    def _apply_pending_knobs(self):
        """Apply staged knobs (driving thread, step entry)."""
        with self._submit_lock:
            if not self._pending_knobs:
                return
            knobs, self._pending_knobs = self._pending_knobs, {}
        for name, v in knobs.items():
            if name == "decode_burst" and v != self.decode_burst:
                self._jit_cache.pop("burst", None)
            setattr(self, name, v)

    # -- the step ------------------------------------------------------------
    def step(self, eos_token_id=None, max_new_tokens=None):
        """One step: the mixed program (every prefilled slot decodes one
        token, plus draft-verify lanes; admitted slots consume prefill chunks
        from the rest of the budget) or, in steady decode, the burst.
        Returns the finished (request_id, tokens) pairs evicted this step.

        A step that a recovery superseded (its epoch moved while it was stuck
        at the fault point, in a program call, or crashing on state the
        recovery tore down) returns ``[]``: the new epoch owns the slots."""
        epoch = self._epoch
        self._apply_pending_knobs()
        self.step_open_since = time.monotonic()
        try:
            _fi.fire("serving.step")
            if epoch != self._epoch:
                return []
            try:
                with torch.inference_mode():
                    finished = self._step_impl(eos_token_id, max_new_tokens)
            except Exception:
                if epoch != self._epoch:
                    return []
                raise
            if epoch != self._epoch:
                return []
            return finished
        finally:
            self.step_open_since = None

    def _ensure(self, need):
        """ensure_capacity with radix-cache relief: on pool exhaustion, evict
        the LRU cache-only blocks the grant is short of (spilling them to host
        RAM with ``kv_spill``), then retry once."""
        try:
            self._pager.ensure_capacity(need)
            return
        except RuntimeError:
            if self.prefix_cache is None or not len(self.prefix_cache):
                raise
        pager = self._pager
        owned = (pager._tables_np > 0).sum(axis=1)
        want = -(-np.maximum(np.asarray(need, np.int64), 0) // self.block_size)
        shortfall = int(np.maximum(want - owned, 0).sum()) - len(pager._free)
        self.prefix_cache.evict(max(shortfall, 1), pools=self._pools)
        self._pager.ensure_capacity(need)

    def _step_impl(self, eos_token_id, max_new_tokens):
        # the epoch fence after the program call bounds what a superseded
        # step can touch (the microseconds of pack assembly before it are
        # the accepted window, as in the JAX engine)
        epoch = self._epoch
        # cancellations first: a cancelled queued request must not be
        # admitted below, and a cancelled active slot frees its lane
        self._apply_cancels()
        self._drain_pending()
        if not self._active.any():
            return []
        T = self.max_step_tokens
        decode_slots = np.flatnonzero(self._decode_ready)
        prefill_slots = np.flatnonzero(self._active & ~self._decode_ready).tolist()
        nd = len(decode_slots)
        draft_map = {}
        spec_ok = False
        if self._drafter is not None and nd:
            # the verify site: a flag fault degrades this step to plain
            # one-token decode (drafts are only ever verified)
            _sp = _fi.fire("serving.spec_verify")
            spec_ok = _sp is None or _sp.action != "flag"
        if spec_ok and not prefill_slots:
            # steady state: the spare budget is draft-verify lanes; grant
            # their blocks before the burst gate, so a pool that cannot fund
            # the drafts falls back to the burst
            draft_map = self._collect_drafts(decode_slots, T - nd, max_new_tokens)
            if draft_map:
                base = np.where(self._active, self.lens, 0)
                base[decode_slots] += 1
                _trial, draft_map = self._grant_drafts(base, draft_map)
        K = self.decode_burst
        if K > 1 and not prefill_slots and not draft_map and nd \
                and (self.lens[decode_slots] + K < self.max_len).all() \
                and self._burst_useful(decode_slots, K, max_new_tokens):
            need = np.where(self._active, self.lens, 0)
            need[decode_slots] += K
            try:
                self._ensure(need)
                granted = True
            except RuntimeError:
                if not self.kv_spill:
                    raise
                granted = False   # the single-step path preempts for room
            if granted:
                # every position the burst writes must target an unshared
                # block: copy-on-write runs on the host, so a shared target
                # sends this step down the single-step path
                t = self._pager._tables_np
                first = self.lens[decode_slots] // self.block_size
                last = (self.lens[decode_slots] + K - 1) // self.block_size
                targets = np.concatenate([t[b, f:g + 1] for b, f, g in
                                          zip(decode_slots, first, last)])
                if not (self._pager._refs[targets] > 1).any():
                    return self._burst_impl(decode_slots, eos_token_id, max_new_tokens,
                                            epoch)
        if self.policy == "spf":
            prefill_slots.sort(key=lambda b: (
                -self._slots[b].priority,
                len(self._slots[b].prompt) - self._slots[b].prefill_pos, self._slots[b].rid))
        else:
            # priority lanes first, then admission order
            prefill_slots.sort(key=lambda b: (-self._slots[b].priority, self._slots[b].rid))
        budget = T - nd
        if self.decode_priority > 0.0:
            # bound the prefill share of the pack, never to zero
            budget = min(budget, max(1, int((1.0 - self.decode_priority) * T)))
        # capacity grants: decode slots must proceed; a prefill chunk that
        # cannot get blocks waits a step. With kv_spill, a grant the cache
        # cannot relieve preempts the lowest-priority non-decoding request
        need = np.where(self._active, self.lens, 0)
        need[decode_slots] += 1
        while True:
            try:
                self._ensure(need)
                break
            except RuntimeError:
                if not self.kv_spill:
                    raise
                victim = self._preempt_lowest(exclude=decode_slots)
                if victim is None:
                    raise
                need[victim] = 0
                if victim in prefill_slots:
                    prefill_slots.remove(victim)
        need, draft_map = self._grant_drafts(need, draft_map)
        chunks = []                     # (slot, start, take)
        for b in prefill_slots:
            if budget <= 0:
                break
            req = self._slots[b]
            take = min(len(req.prompt) - req.prefill_pos, self.chunk_size, budget)
            trial = need.copy()
            trial[b] = req.prefill_pos + take
            try:
                self._ensure(trial)
            except RuntimeError:
                continue                # waits for evictions to free blocks
            need = trial
            chunks.append((b, req.prefill_pos, take))
            budget -= take
        if spec_ok and not draft_map and prefill_slots:
            # mixed steps spend prefill first; lanes left over verify drafts
            left = T - nd - sum(take for _b, _s, take in chunks)
            if left > 0:
                draft_map = self._collect_drafts(decode_slots, left, max_new_tokens)
                need, draft_map = self._grant_drafts(need, draft_map)
        if not nd and not chunks:
            if self.kv_spill and self._preempt_lowest() is not None:
                # the pool is pinned and nothing can progress: one request's
                # K/V goes to host RAM, the freed blocks unstick the rest
                # next step and the victim resumes bit for bit later
                return []
            raise RuntimeError("serving step cannot pack any lane: paged KV pool "
                               "exhausted with no evictable prefix-cache blocks")
        # pack assembly: decode lanes (each followed by its draft lanes, so
        # accept chains are contiguous) first, then prefill chunks
        pack_np = np.zeros((2, T), np.int32)
        tok_ids, positions = pack_np[0], pack_np[1]
        if draft_map:
            dec_lanes = []              # (slot, base lane, n drafts)
            lane = 0
            for b in decode_slots:
                d = draft_map.get(int(b))
                kb = 0 if d is None else len(d)
                tok_ids[lane] = self._last_tok[b]
                positions[lane] = self.lens[b]
                if kb:
                    # draft j rides position lens + 1 + j; a rejected draft's
                    # write past the accept fence is rolled back by not
                    # advancing lens
                    tok_ids[lane + 1:lane + 1 + kb] = d
                    positions[lane + 1:lane + 1 + kb] = self.lens[b] + 1 + np.arange(kb)
                dec_lanes.append((int(b), lane, kb))
                lane += 1 + kb
            n_dec_lanes = lane
        else:
            dec_lanes = None
            tok_ids[:nd] = self._last_tok[decode_slots]
            positions[:nd] = self.lens[decode_slots]
            lane = n_dec_lanes = nd
        emit_lanes = {}                 # slot -> lane of its last prompt token
        for b, start, take in chunks:
            req = self._slots[b]
            tok_ids[lane:lane + take] = req.prompt[start:start + take]
            positions[lane:lane + take] = np.arange(start, start + take)
            if start + take == len(req.prompt):
                emit_lanes[b] = lane + take - 1
            lane += take
        n_lanes = lane
        # copy-on-write: a lane writing into a shared block gets a private
        # copy first; the all-refs<=1 guard keeps the unshared state free
        if (self._pager._refs > 1).any():
            rows = np.empty(n_lanes, np.int64)
            if dec_lanes is None:
                rows[:nd] = decode_slots
            else:
                for b, lane0, kb in dec_lanes:
                    rows[lane0:lane0 + 1 + kb] = b
            lane = n_dec_lanes
            for b, _start, take in chunks:
                rows[lane:lane + take] = b
                lane += take
            try:
                self._pager.make_positions_exclusive(rows, positions[:n_lanes], self._pools)
            except _pk.CowPoolExhausted:
                # copies made before the pool ran dry are applied: hand
                # cache-only blocks back and retry
                if self.prefix_cache is None or not len(self.prefix_cache):
                    raise
                self.prefix_cache.evict(n_lanes, pools=self._pools)
                self._pager.make_positions_exclusive(rows, positions[:n_lanes], self._pools)
        key = (decode_slots.tobytes(),
               () if dec_lanes is None else tuple(kb for _b, _l, kb in dec_lanes),
               tuple((b, take) for b, _s, take in chunks))
        cached = self._lane_cache.get(key)
        if cached is None:
            slot_np = np.zeros(T, np.int32)
            valid_np = np.zeros(T, bool)
            chain_np = np.zeros(T, bool)
            if dec_lanes is None:
                slot_np[:nd] = decode_slots
            else:
                for b, lane0, kb in dec_lanes:
                    slot_np[lane0:lane0 + 1 + kb] = b
                    chain_np[lane0 + 1:lane0 + 1 + kb] = True
            lane = n_dec_lanes
            for b, _start, take in chunks:
                slot_np[lane:lane + take] = b
                lane += take
            valid_np[:n_lanes] = True
            cached = tuple(torch.from_numpy(a).to(self.device)
                           for a in (slot_np, valid_np, chain_np))
            if len(self._lane_cache) > 256:
                self._lane_cache.clear()
            self._lane_cache[key] = cached
        out = self._step_jit()(torch.from_numpy(pack_np), self._pager.block_tables,
                               *cached).cpu().numpy()
        if epoch != self._epoch:
            # a recovery superseded this step during the call: its writes
            # went only to blocks its own lanes held, all freed by the
            # recovery; every host-side change now belongs to the new epoch
            return []
        toks, acc = out[0], out[1]
        t1 = time.perf_counter_ns()
        # route decode results: every slot emits its base token plus one
        # token per accepted draft (the longest agreeing prefix)
        finished = []
        n_draft = n_dec_lanes - nd
        n_accept = 0
        if dec_lanes is None:
            for i, b in enumerate(decode_slots):
                pre = int(self.lens[b])
                self.lens[b] += 1
                self._note_token(b, int(toks[i]), eos_token_id, max_new_tokens, finished)
                self._register_decode_blocks(b, pre)
        else:
            for b, lane0, kb in dec_lanes:
                a = int(acc[lane0 + 1:lane0 + 1 + kb].sum()) if kb else 0
                pre = int(self.lens[b])
                routed = 0
                for j in range(a + 1):
                    if self._slots[b] is None:
                        break           # finished mid-verify: the rest of
                    self.lens[b] += 1   # its lane is discarded
                    routed += 1
                    self._note_token(b, int(toks[lane0 + j]), eos_token_id,
                                     max_new_tokens, finished)
                # accepted = draft tokens delivered (an eos mid-chain
                # discards the rest)
                n_accept += max(routed - 1, 0)
                self._register_decode_blocks(b, pre)
        if n_draft:
            self.spec_drafted += n_draft
            self.spec_accepted += n_accept
        # route prefill progress and the first tokens of completed prefills
        for b, start, take in chunks:
            req = self._slots[b]
            req.prefill_pos = start + take
            req.chunks += 1
            self.lens[b] = req.prefill_pos
            if self.prefix_cache is not None:
                self.prefix_cache.register(req.prompt, req.prefill_pos,
                                           self._pager._tables_np[b])
            if req.prefilled:
                req.t_first = t1
                self._decode_ready[b] = True
                with self._submit_lock:
                    st = self._stats.get(req.rid)
                    if st is not None:
                        st["ttft_ns"] = t1 - req.t_submit
                        st["prefill_chunks"] = req.chunks
                self._note_token(b, int(toks[emit_lanes[b]]), eos_token_id,
                                 max_new_tokens, finished)
        return finished

    def _register_decode_blocks(self, slot, pre_lens):
        """With speculation on, generated full blocks join the radix chain
        too, so a repeated prompt drafts its previous run's continuation.
        ``pre_lens=None`` registers unconditionally (the eviction-time
        sweep); otherwise only when this step crossed a block boundary."""
        if self._drafter is None or self.prefix_cache is None:
            return
        req = self._slots[slot]
        if req is None or not req.outputs:
            return
        bs = self.block_size
        if pre_lens is not None and int(self.lens[slot]) // bs == int(pre_lens) // bs:
            return                      # no block filled this step
        # resume the chain walk at the last crossing's cursor, passing only
        # the tokens past the cursor block
        cursor = self._chain_cursors.get(slot, (0, b""))
        start = int(cursor[0]) * bs
        lp = len(req.prompt)
        if start < lp:
            tail = np.concatenate([np.asarray(req.prompt[start:], np.int32),
                                   np.asarray(req.outputs, np.int32)])
        else:
            tail = np.asarray(req.outputs[start - lp:], np.int32)
        _n, cursor = self.prefix_cache.register_from(
            cursor, tail, int(self.lens[slot]), self._pager._tables_np[slot])
        self._chain_cursors[slot] = cursor

    def _collect_drafts(self, decode_slots, budget, max_new_tokens):
        """Up to ``spec_lookahead`` drafted tokens a decode lane, bounded by
        the spare lane budget, the cache capacity and the request's
        remaining token allowance."""
        draft_map = {}
        left = int(budget)
        for b in decode_slots:
            if left <= 0:
                break
            req = self._slots[b]
            cap = min(self.spec_lookahead, left, self.max_len - 1 - int(self.lens[b]))
            limit = req.max_new if req.max_new is not None else max_new_tokens
            if limit is not None:
                cap = min(cap, limit - len(req.outputs) - 1)
            if cap <= 0:
                continue
            d = self._drafter.draft(req.rid, cap)
            if len(d):
                draft_map[int(b)] = d
                left -= len(d)
        return draft_map

    def _grant_drafts(self, need, draft_map):
        """Per-slot best-effort block grants for draft-verify lanes (every
        drafted position may be written). The grant goes to the allocator
        directly, never through the radix relief: speculation must not evict
        the cache blocks its drafts read from."""
        if not draft_map:
            return need, draft_map
        trial = need.copy()
        kept = {}
        for b, d in draft_map.items():
            t2 = trial.copy()
            t2[b] += len(d)
            try:
                self._pager.ensure_capacity(t2)
            except RuntimeError:
                continue
            trial = t2
            kept[b] = d
        return trial, kept

    def _burst_useful(self, decode_slots, K, max_new_tokens):
        """Burst only when at least half the fused lanes would emit kept
        tokens."""
        useful = 0
        for b in decode_slots:
            req = self._slots[b]
            limit = req.max_new if req.max_new is not None else max_new_tokens
            useful += K if limit is None else min(K, max(limit - len(req.outputs), 0))
        return 2 * useful >= K * len(decode_slots)

    def _burst_impl(self, decode_slots, eos_token_id, max_new_tokens, epoch):
        """Steady-state path: K fused decode iterations, one (2, B) upload,
        one (B, K) download."""
        K = self.decode_burst
        pack = np.empty((2, self.max_batch), np.int32)
        pack[0] = self._last_tok
        pack[1] = self.lens
        toks = self._burst_jit()(torch.from_numpy(pack),
                                 self._pager.block_tables).cpu().numpy()   # (B, K)
        if epoch != self._epoch:
            return []                   # superseded mid-call: as the mixed step
        finished = []
        for b in decode_slots:
            pre = int(self.lens[b])
            for i in range(K):
                if self._slots[b] is None:
                    break               # finished mid-burst: the rest of
                self.lens[b] += 1       # its lane is discarded
                self._note_token(b, int(toks[b, i]), eos_token_id, max_new_tokens,
                                 finished)
            self._register_decode_blocks(b, pre)
        return finished

    def _note_token(self, slot, tok, eos_token_id, max_new_tokens, finished):
        req = self._slots[slot]
        req.outputs.append(tok)
        req.last_token = tok
        self._last_tok[slot] = tok
        if self._drafter is not None:
            self._drafter.note(req.rid, tok)
        limit = req.max_new if req.max_new is not None else max_new_tokens
        if (eos_token_id is not None and tok == eos_token_id) \
                or (limit is not None and len(req.outputs) >= limit) \
                or self.lens[slot] + 1 >= self.max_len:
            finished.append((req.rid, list(req.outputs)))
            self._evict(slot)

    def _evict(self, slot):
        req = self._slots[slot]
        with self._submit_lock:
            st = self._stats.get(req.rid)
            if st is not None:
                st["tokens"] = len(req.outputs)
        # last chance to chain the generation's tail blocks before the row
        # is freed
        self._register_decode_blocks(slot, None)
        self._pager.free_sequence(slot)
        self._slots[slot] = None
        self._active[slot] = False
        self._decode_ready[slot] = False
        self.lens[slot] = 0
        self._chain_cursors.pop(slot, None)
        if self._drafter is not None:
            self._drafter.drop(req.rid)

    @property
    def num_active(self):
        return int(self._active.sum())

    @property
    def num_pending(self):
        return sum(len(t.queue) for t in list(self._tenants.values()))

    # -- the fleet-facing surface (cancellation, queue withdrawal) -----------
    def cancel(self, rid):
        """Request cancellation of one request (thread-safe, a pure enqueue).
        The driving thread applies it at the next step boundary: a queued
        request leaves its lane, an active one is evicted (its blocks freed)
        without a result. A finished request is unaffected: its result
        stands. The tail-hedging loser's exit (``serving/fleet.py``)."""
        self._cancel_q.append(rid)

    def _apply_cancels(self):
        """Driving thread only: apply every pending cancellation."""
        rids = set(_drain(self._cancel_q))
        if not rids:
            return
        n = 0
        with self._submit_lock:
            for ten in self._tenants.values():
                for req in [r for r in ten.queue if r.rid in rids]:
                    ten.queue.remove(req)
                    rids.discard(req.rid)
                    self._stats.pop(req.rid, None)
                    n += 1
        for b in range(self.max_batch):
            req = self._slots[b]
            if req is not None and req.rid in rids:
                self._evict(b)          # frees blocks; no result emitted
                with self._submit_lock:
                    self._stats.pop(req.rid, None)
                n += 1
        self.cancelled += n

    def withdraw_pending(self):
        """Pull every queued (not yet admitted) request out of the tenant
        lanes (thread-safe: queue surgery under the submit lock; slot and
        pager state are untouched). Returns ``{"rid", "prompt", "max_new",
        "tenant", "outputs"}`` dicts (``outputs`` is non-empty for a
        preempted request queued again mid-generation): what a fleet router
        moves off a draining or failed replica."""
        out = []
        with self._submit_lock:
            for ten in self._tenants.values():
                while ten.queue:
                    req = ten.queue.popleft()
                    self._stats.pop(req.rid, None)
                    out.append({"rid": req.rid, "prompt": req.prompt, "max_new": req.max_new,
                                "tenant": req.tenant, "outputs": list(req.outputs)})
        return out

    # -- crash and hang recovery ---------------------------------------------
    def recover(self, reason="", stuck=""):
        """Tear down the slot state of a dead or hung epoch and restart warm:
        every in-flight request is aborted with a typed
        :class:`RequestAborted` carrying its partial tokens and stats
        (drained by :meth:`pop_aborted`), slots and pager rows are freed, and
        the radix cache survives, so re-submissions of the same prompts hit
        it (with ``kv_spill``, spilled prefixes restore from host RAM).
        Queued requests stay queued; the captured programs stay valid (the
        pools and tables are the same tensors). Thread-safe: concurrent
        observers of one failure (the dying driving thread, the hang
        watchdog) collapse to one recovery, the loser returns None. A step
        this recovery supersedes sees the new epoch and applies nothing.
        ``stuck`` names the stuck section (kept for the flight dump of the
        observability slice). Returns the number of aborted requests."""
        del stuck
        if not self._recover_lock.acquire(blocking=False):
            return None
        try:
            t0 = time.perf_counter_ns()
            # the epoch moves first: a step stuck at its fault point wakes,
            # sees it, and returns without touching what this recovery owns
            self._epoch += 1
            aborted = 0
            for b in range(self.max_batch):
                req = self._slots[b]
                if req is None:
                    continue
                # the partial stats ride the typed abort (popped: nobody
                # would pop the dead rid's record again)
                with self._submit_lock:
                    st = self._stats.pop(req.rid, None)
                    if st is not None:
                        st["aborted"] = True
                        st["tokens"] = len(req.outputs)
                self._aborted.append(RequestAborted(
                    f"request {req.rid} aborted by engine recovery: {reason}",
                    rid=req.rid, tokens=req.outputs, tenant=req.tenant, stats=st))
                aborted += 1
                self._pager.free_sequence(b)
                self._slots[b] = None
                if self._drafter is not None:
                    self._drafter.drop(req.rid)
            self._active[:] = False
            self._decode_ready[:] = False
            self.lens[:] = 0
            self._last_tok[:] = 0
            self._lane_cache.clear()
            self._chain_cursors.clear()
            # kept: the programs, the admission queues, and the radix cache
            # with its pinned blocks; that is what makes the restart warm
            cold = self.prefix_cache is None or not len(self.prefix_cache)
            self.recovery_stats.append({
                "reason": reason, "ms": (time.perf_counter_ns() - t0) / 1e6,
                "aborted": aborted, "cold": cold, "dump": None})
            return aborted
        finally:
            self._recover_lock.release()

    def pop_aborted(self):
        """Drain the :class:`RequestAborted` records of requests a recovery
        cut short (each carries the partial ``tokens``)."""
        return _drain(self._aborted)

    # -- the driving thread --------------------------------------------------
    def start_driver(self, eos_token_id=None, max_new_tokens=None, hang_timeout=None,
                     poll_s=0.0005):
        """Start the engine's driving thread: it admits and steps whenever
        work is pending and parks finished ``(rid, tokens)`` pairs for
        :meth:`pop_results`; producers keep calling :meth:`submit` from any
        thread. If the thread dies (anything step() raises), it runs
        :meth:`recover` and starts a new driving thread, warm. With
        ``hang_timeout`` a watchdog recovers a step stuck longer than that
        many seconds from its scanner thread (the stuck step returns empty
        when it wakes). Idempotent while the thread lives."""
        if self._driver is not None and self._driver.is_alive():
            return
        self._drive_args = (eos_token_id, max_new_tokens, float(poll_s))
        self._drive_stop.clear()
        if hang_timeout is not None:
            from ..distributed.watchdog import CommWatchdog

            self._dog = CommWatchdog(timeout=float(hang_timeout), on_timeout=self._on_hang,
                                     flight_key=self._tag)
        self._spawn_driver()

    def stop_driver(self, timeout=5.0):
        """Stop the driving thread (its current step completes first)."""
        self._drive_stop.set()
        drv = self._driver
        if drv is not None and drv.is_alive():
            drv.join(timeout=timeout)
        if self._dog is not None:
            self._dog.stop()
            self._dog = None
        self._driver = None

    def pop_results(self):
        """Drain the finished ``(rid, tokens)`` pairs the driving thread
        collected."""
        return _drain(self._results)

    def _spawn_driver(self):
        t = threading.Thread(target=self._drive_loop, daemon=True,
                             name=f"serving-driver-{self._tag}")
        self._driver = t
        t.start()

    def _on_hang(self, desc, dump):
        """Watchdog callback: a watched step exceeded the hang timeout."""
        del dump
        self.recover(f"watchdog-detected hang: {desc} exceeded {self._dog.timeout}s",
                     stuck=desc)

    def _drive_loop(self):
        eos, max_new, poll = self._drive_args
        while not self._drive_stop.is_set():
            try:
                if not (self._active.any() or self.num_pending):
                    time.sleep(poll)
                    continue
                # the kill drill's site: before a step that has work (an idle
                # poll never spends the trigger count)
                _fi.fire("serving.drive")
                if self._dog is not None:
                    with self._dog.watch("serving.step"):
                        finished = self.step(eos, max_new)
                else:
                    finished = self.step(eos, max_new)
                self._results.extend(finished)
            except Exception as e:  # noqa: BLE001 - any driving-thread death
                # recovers and relaunches warm
                if self._drive_stop.is_set():
                    return
                point = getattr(e, "point", "")
                self.recover(f"driving thread died: {type(e).__name__}: {e}",
                             stuck=point or "serving.step")
                if not self._drive_stop.is_set():
                    self._spawn_driver()
                return


class StaticBatchEngine:
    """The batch-synchronous baseline the continuous engine is measured
    against, at equal batch capacity: admit a full wave, prefill each prompt
    as its own bucket-padded call (on the card, the flash-attention kernel
    once a layer), decode every wave slot in lockstep until the wave's last
    request finishes, then evict all and admit the next wave. Runs eagerly."""

    def __init__(self, model, max_batch=8, max_len=None, block_size=64,
                 prefill_buckets=(32, 64, 128, 256, 512, 1024, 2048), kv_cache_dtype=None):
        self._inner = LlamaDecodeEngine(model, max_len=max_len, kv_cache_layout="paged",
                                        block_size=block_size,
                                        kv_cache_dtype=kv_cache_dtype)
        e = self._inner
        self.device = e.device
        self.max_batch = int(max_batch)
        self.max_len = e.max_len
        self.block_size = int(block_size)
        self._buckets = tuple(b for b in sorted(prefill_buckets) if b <= e.max_len) \
            or (e.max_len,)
        max_blocks = -(-e.max_len // self.block_size)
        self._pager = _pk.PagedKVCache(
            num_layers=len(e.layers), num_blocks=self.max_batch * max_blocks + 1,
            block_size=self.block_size, kv_heads=e.num_kv, head_dim=e.head_dim,
            batch=self.max_batch, max_blocks_per_seq=max_blocks, dtype=e.emb.dtype,
            quantized=e.kv_int8, device=self.device)
        self._pools, self.kv_pool_bytes = _pool_layout(self._pager, e.kv_int8)
        self.kv_cache_dtype = kv_cache_dtype
        self.lens = np.zeros(self.max_batch, np.int64)
        self._slots = [None] * self.max_batch
        self._done = np.zeros(self.max_batch, bool)
        self._pending = collections.deque()
        self._next_rid = 0
        self._stats = collections.OrderedDict()

    # -- the two paths: per-bucket prefill, lockstep ragged decode -----------
    def _prefill_slot(self, ids, row_tables, length):
        """One bucket-padded prompt (1, S) through every layer into the
        slot's blocks; the greedy token after its ``length`` real tokens."""
        e = self._inner
        S = ids.shape[1]
        x = e.emb[ids]
        rope = _rope_tables(S, e.head_dim, e.theta, x.dtype, x.device, every_two=False)
        lens1 = torch.full((1,), length, dtype=torch.int32, device=x.device)
        t = torch.arange(S, device=x.device)
        pos_mask = (t[None, None, :] <= t[None, :, None]).expand(1, S, S)
        for p, pool in zip(e.layers, self._pools):
            x = e._block_paged_prefill(p, x, pool, row_tables, lens1, rope, pos_mask)
        return torch.argmax(e._logits(x[:, :length]), dim=-1)

    def _step_all(self, tokens, tables, lens):
        """One lockstep decode step of every row at its own position."""
        e = self._inner
        x = e.emb[tokens]
        rope = _row_rope_tables(lens, e.head_dim, e.theta, x.dtype, x.device)
        plan = _pk._decode_plan(tables, lens, self.block_size)
        for p, pool in zip(e.layers, self._pools):
            x = e._block_paged_decode(p, x, pool, tables, lens, rope, plan)
        return torch.argmax(e._logits(x), dim=-1)

    # -- API (the continuous engine's driving surface) -----------------------
    def submit(self, prompt_ids, max_new_tokens=None):
        prompt = np.asarray(getattr(prompt_ids, "value", prompt_ids), np.int32).reshape(-1)
        L = len(prompt)
        if L == 0 or L >= self.max_len:
            raise ValueError(f"prompt length {L} out of range (1..{self.max_len - 1})")
        rid = self._next_rid
        self._next_rid += 1
        req = _Request(rid, prompt, max_new_tokens, time.perf_counter_ns())
        self._pending.append(req)
        self._stats[rid] = {"rid": rid, "prompt_len": L, "submit_ns": req.t_submit}
        if len(self._stats) > 4096:
            self._stats.popitem(last=False)
        return rid

    def pop_stats(self, rid):
        return self._stats.pop(rid, None)

    def _admit_wave(self):
        for b in range(self.max_batch):
            if not self._pending:
                break
            req = self._pending.popleft()
            L = len(req.prompt)
            bucket = next((k for k in self._buckets if k >= L), self.max_len)
            padded = np.zeros((1, bucket), np.int64)
            padded[0, :L] = req.prompt
            need = np.where([s is not None for s in self._slots], self.lens + 1, 0)
            need[b] = L + 1
            self._pager.ensure_capacity(need)
            tok = int(self._prefill_slot(torch.from_numpy(padded).to(self.device),
                                         self._pager.block_tables[b:b + 1], L))
            req.prefill_pos = L
            req.last_token = tok
            req.outputs = [tok]
            req.t_first = time.perf_counter_ns()
            self._slots[b] = req
            self.lens[b] = L
            self._done[b] = False
            st = self._stats.get(req.rid)
            if st is not None:
                st["ttft_ns"] = req.t_first - req.t_submit
                st["tokens"] = 1

    def step(self, eos_token_id=None, max_new_tokens=None):
        """One wave-synchronous step. With no wave in flight it admits (and
        prefills) the next wave; otherwise it decodes every wave slot in
        lockstep, finished rows burning their lane until the wave ends."""
        with torch.inference_mode():
            return self._step(eos_token_id, max_new_tokens)

    def _step(self, eos_token_id, max_new_tokens):
        finished = []
        active = [b for b in range(self.max_batch) if self._slots[b] is not None]
        if not active:
            if not self._pending:
                return []
            self._admit_wave()
            active = [b for b in range(self.max_batch) if self._slots[b] is not None]
            # first tokens may already complete single-token requests
            for b in active:
                self._check_done(b, eos_token_id, max_new_tokens)
            return self._maybe_drain_wave(active, finished)
        tokens = np.zeros((self.max_batch, 1), np.int64)
        for b in active:
            tokens[b, 0] = self._slots[b].last_token
        need = np.where([s is not None for s in self._slots], self.lens + 1, 0)
        self._pager.ensure_capacity(need)
        toks = self._step_all(torch.from_numpy(tokens).to(self.device),
                              self._pager.block_tables,
                              torch.from_numpy(self.lens.astype(np.int32)).to(self.device))
        toks = toks.cpu().numpy()
        for b in active:
            req = self._slots[b]
            if self._done[b]:
                # a finished row burns its lane until the wave drains, at a
                # frozen position
                continue
            self.lens[b] += 1
            tok = int(toks[b])
            req.outputs.append(tok)
            req.last_token = tok
            st = self._stats.get(req.rid)
            if st is not None:
                st["tokens"] = len(req.outputs)
            self._check_done(b, eos_token_id, max_new_tokens)
        return self._maybe_drain_wave(active, finished)

    def _check_done(self, b, eos_token_id, max_new_tokens):
        req = self._slots[b]
        limit = req.max_new if req.max_new is not None else max_new_tokens
        tok = req.outputs[-1]
        if (eos_token_id is not None and tok == eos_token_id) \
                or (limit is not None and len(req.outputs) >= limit) \
                or self.lens[b] + 1 >= self.max_len:
            self._done[b] = True

    def _maybe_drain_wave(self, active, finished):
        if active and all(self._done[b] for b in active):
            for b in active:
                req = self._slots[b]
                finished.append((req.rid, list(req.outputs)))
                self._pager.free_sequence(b)
                self._slots[b] = None
                self.lens[b] = 0
                self._done[b] = False
        return finished

    @property
    def num_active(self):
        return sum(1 for s in self._slots if s is not None)

    @property
    def num_pending(self):
        return len(self._pending)
