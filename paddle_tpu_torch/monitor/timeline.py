"""Span-timeline perf analytics: graftscope's analysis wing.

The trace layer records WHAT happened (spans with explicit parent/trace
links in a bounded ring); this module answers the derived perf questions
of that record:

- **per-train-step phase breakdown** — how one ``train.step`` window
  splits across dataload / forward / backward / optimizer child stages
  plus the ``comm.*`` spans that landed inside it;
- **bubble fraction** — the idle gap per step: time inside a step window
  covered by NO child stage and no comm span;
- **comm-overlap fraction** — ``comm.*`` span time overlapped with
  compute spans: ``|union(comm) ∩ union(compute)| / |union(comm)|``;
- **serving TTFT decomposition** — from the request trees: one
  ``serving.request`` root per request with ``serving.queue_wait`` /
  ``serving.prefill`` children, so TTFT splits into queue wait +
  chunked prefill + the (small) scheduling gap, components summing to
  the measured TTFT by construction;
- **MFU** — tokens x flops-per-token vs wall against a peak-FLOP/s
  denominator.

Everything here is pure computation over span DICTS (``Span.to_dict()``
shape, or ``span_dump()`` output) — no torch, no framework import, no
clock reads, so analytics over a flight dump work offline in any
process, and the same span dicts give the same results as the JAX
package's ``paddle_tpu.monitor.timeline``. :func:`perf_report`
assembles every section the live ring can support and backs the debug
server's ``/perfz`` endpoint (``monitor/server.py``).

The spans are host time: with asynchronous CUDA launches and replayed
CUDA graphs a span ends when the host returns (``monitor/trace.py``).

The modeled schedule over a traced mesh step (``modeled_step_timeline``,
``modeled_overlap_report`` in the JAX package) walks the program of the
mesh train step, which the port does not have yet: both raise
``NotImplementedError`` naming ROADMAP Queue A item 10.
"""
from __future__ import annotations

import statistics

__all__ = [
    "comm_overlap", "step_phases", "bubble_fraction",
    "ttft_decomposition", "mfu", "transformer_flops_per_token",
    "perf_report", "modeled_step_timeline", "modeled_overlap_report",
    "COMPUTE_SPAN_NAMES", "TRAIN_STAGES",
]

# wall-clock span names that count as device/compute work for the
# overlap formula (the modeled schedule adds its own "compute" spans)
COMPUTE_SPAN_NAMES = frozenset({
    "train.forward", "train.backward", "train.optimizer", "compute",
})

TRAIN_STAGES = ("dataload", "forward", "backward", "optimizer")


# -- span plumbing -----------------------------------------------------------

def _as_dict(sp):
    if isinstance(sp, dict):
        return sp
    return sp.to_dict()


def _closed(spans):
    """Completed spans as dicts (open spans have no t1 and are skipped)."""
    out = []
    for sp in spans:
        d = _as_dict(sp)
        if d.get("t1_ns") is not None:
            out.append(d)
    return out


def _union(intervals):
    """Merge [t0, t1) intervals into a sorted disjoint list."""
    ivs = sorted((t0, t1) for t0, t1 in intervals if t1 > t0)
    out = []
    for t0, t1 in ivs:
        if out and t0 <= out[-1][1]:
            if t1 > out[-1][1]:
                out[-1] = (out[-1][0], t1)
        else:
            out.append((t0, t1))
    return out


def _total(union_ivs):
    return sum(t1 - t0 for t0, t1 in union_ivs)


def _intersect(a, b):
    """Total overlap length of two DISJOINT-SORTED interval lists."""
    i = j = 0
    total = 0
    while i < len(a) and j < len(b):
        lo = max(a[i][0], b[j][0])
        hi = min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] <= b[j][1]:
            i += 1
        else:
            j += 1
    return total


def _clip(ivs, t0, t1):
    return [(max(a, t0), min(b, t1)) for a, b in ivs
            if min(b, t1) > max(a, t0)]


# -- comm/compute overlap ----------------------------------------------------

def comm_overlap(spans, comm_prefix="comm.",
                 compute_names=COMPUTE_SPAN_NAMES):
    """The comm-overlap fraction of a span set.

    Formula (docs/introspection.md): with ``C = union of [t0, t1) over
    spans named comm.*`` and ``X = union over compute spans``,

        overlap_fraction = |C ∩ X| / |C|

    Both unions merge their own overlaps first, so concurrent comm spans
    never double-count. Returns zeros (fraction 0.0) when no comm span
    completed.
    """
    closed = _closed(spans)
    comm = _union((d["t0_ns"], d["t1_ns"]) for d in closed
                  if d["name"].startswith(comm_prefix))
    compute = _union((d["t0_ns"], d["t1_ns"]) for d in closed
                     if d["name"] in compute_names)
    comm_ns = _total(comm)
    overlapped = _intersect(comm, compute)
    return {
        "comm_ns": comm_ns,
        "compute_ns": _total(compute),
        "overlapped_ns": overlapped,
        "overlap_fraction": overlapped / comm_ns if comm_ns else 0.0,
    }


# -- train-step phase breakdown + bubble -------------------------------------

def _children_of(closed, root):
    return [d for d in closed if d.get("parent_id") == root["span_id"]]


def _comm_in_window(closed, t0, t1):
    return [(d["t0_ns"], d["t1_ns"]) for d in closed
            if d["name"].startswith("comm.")
            and min(d["t1_ns"], t1) > max(d["t0_ns"], t0)]


def step_phases(spans, root="train.step"):
    """Per-step phase breakdown over every completed ``root`` span.

    Child-stage time is summed by name (``train.forward`` -> "forward");
    ``comm.*`` spans are attributed by WINDOW overlap (clipped to the
    step) because collective spans are recorded unparented. Returns
    ``{"steps", "rows": [per-step dicts], "mean_ns": {stage: mean}}``.
    """
    closed = _closed(spans)
    rows = []
    for rd in closed:
        if rd["name"] != root:
            continue
        t0, t1 = rd["t0_ns"], rd["t1_ns"]
        phases = {}
        for ch in _children_of(closed, rd):
            stage = ch["name"].split(".", 1)[-1]
            phases[stage] = phases.get(stage, 0) \
                + (ch["t1_ns"] - ch["t0_ns"])
        comm = _union(_clip(_comm_in_window(closed, t0, t1), t0, t1))
        if comm:
            phases["comm"] = _total(comm)
        row = {"step_ns": t1 - t0, "phases": phases}
        if rd.get("attrs"):
            row["step"] = rd["attrs"].get("step")
        rows.append(row)
    stages = sorted({k for r in rows for k in r["phases"]})
    mean_ns = {
        s: statistics.fmean([r["phases"].get(s, 0) for r in rows])
        for s in stages
    } if rows else {}
    return {"steps": len(rows), "rows": rows, "mean_ns": mean_ns}


def bubble_fraction(spans, root="train.step"):
    """The idle-gap ("bubble") fraction of every completed ``root``
    span: step time covered by NO direct child span and no ``comm.*``
    span clipped into the window, over total step time —

        bubble_fraction = sum(step_ns - |union(children ∪ comm)|)
                          / sum(step_ns)

    The pipeline-parallelism primitive: a microbatch schedule's bubble
    is exactly the per-step time no stage span covers.
    """
    closed = _closed(spans)
    busy_ns = step_ns = 0
    steps = 0
    for rd in closed:
        if rd["name"] != root:
            continue
        t0, t1 = rd["t0_ns"], rd["t1_ns"]
        ivs = [(c["t0_ns"], c["t1_ns"]) for c in _children_of(closed, rd)]
        ivs += _comm_in_window(closed, t0, t1)
        busy = _total(_union(_clip(ivs, t0, t1)))
        busy_ns += busy
        step_ns += t1 - t0
        steps += 1
    return {
        "steps": steps,
        "step_ns": step_ns,
        "busy_ns": busy_ns,
        "bubble_ns": step_ns - busy_ns,
        "bubble_fraction": (step_ns - busy_ns) / step_ns if step_ns
        else 0.0,
    }


# -- serving TTFT decomposition ----------------------------------------------

def ttft_decomposition(spans):
    """Per-request TTFT decomposition from the request trees.

    For every ``serving.request`` root whose ``serving.prefill`` child
    completed (the prefill span's end IS the first-token time):

        ttft       = prefill.t1 - root.t0
        queue_wait = the serving.queue_wait child's duration (0 for the
                     add_request path, which has no queue)
        prefill    = the serving.prefill child's duration
        gap        = ttft - queue_wait - prefill

    so the three components sum to the measured TTFT exactly; ``gap`` is
    the submit->enqueue plus admit-bookkeeping slack (small by
    construction: queue_wait ends and prefill starts on the SAME
    admission timestamp). ``decode_ns`` (total serving.decode_step time
    after the first token) is reported alongside but is not a TTFT
    component. Returns per-request rows plus p50 medians in ms.
    """
    closed = _closed(spans)
    by_trace = {}
    for d in closed:
        by_trace.setdefault(d["trace_id"], []).append(d)
    rows = []
    for tid, group in sorted(by_trace.items()):
        root = next((d for d in group if d["name"] == "serving.request"),
                    None)
        if root is None:
            continue
        prefill = next((d for d in group
                        if d["name"] == "serving.prefill"), None)
        if prefill is None:
            continue
        qw = next((d for d in group
                   if d["name"] == "serving.queue_wait"), None)
        ttft = prefill["t1_ns"] - root["t0_ns"]
        queue_wait = (qw["t1_ns"] - qw["t0_ns"]) if qw else 0
        prefill_ns = prefill["t1_ns"] - prefill["t0_ns"]
        rows.append({
            "trace_id": tid,
            "rid": (root.get("attrs") or {}).get("rid"),
            "ttft_ns": ttft,
            "queue_wait_ns": queue_wait,
            "prefill_ns": prefill_ns,
            "gap_ns": ttft - queue_wait - prefill_ns,
            "decode_ns": sum(d["t1_ns"] - d["t0_ns"] for d in group
                             if d["name"] == "serving.decode_step"),
            "prefill_chunks": sum(1 for d in group
                                  if d["name"] == "serving.prefill_chunk"),
        })
    p50 = {}
    if rows:
        for k in ("ttft_ns", "queue_wait_ns", "prefill_ns", "gap_ns",
                  "decode_ns"):
            p50[k[:-3] + "_ms"] = round(
                statistics.median(r[k] for r in rows) / 1e6, 4)
    return {"requests": len(rows), "rows": rows, "p50_ms": p50}


# -- MFU ---------------------------------------------------------------------

def transformer_flops_per_token(n_params, num_layers=0, hidden=0, seq=0):
    """The decoder-transformer train-step FLOPs/token formula the JAX
    package's bench stamps MFU with: ``6 * n_params`` (fwd+bwd matmuls)
    plus the attention term ``12 * L * H * seq``."""
    return 6 * int(n_params) + 12 * int(num_layers) * int(hidden) \
        * int(seq)


def mfu(tokens, wall_s, flops_per_token, peak_flops):
    """Model-FLOPs utilization: ``tokens * flops_per_token / (wall_s *
    peak_flops)`` — the fraction of the chip's peak matmul throughput
    the measured pass sustained."""
    if wall_s <= 0 or peak_flops <= 0:
        return 0.0
    return tokens * flops_per_token / (wall_s * peak_flops)


# -- the assembled report (/perfz) -------------------------------------------

def perf_report(spans=None):
    """Every analytics section the given span set (default: the live
    trace ring's completed spans) supports — the document behind the
    debug server's ``/perfz``. Sections are present only when their
    spans are: ``train`` (phase breakdown + bubble + comm overlap) when
    a ``train.step`` completed, ``serving`` (TTFT decomposition) when a
    request tree did."""
    from .provenance import provenance as _provenance
    if spans is None:
        from . import trace as _trace

        spans = _trace.spans()
    closed = _closed(spans)
    doc = {
        "provenance": _provenance(),
        "clock": "perf_counter_ns",
        "span_count": len(closed),
    }
    names = {d["name"] for d in closed}
    if "train.step" in names:
        doc["train"] = {
            "phases": step_phases(closed),
            "bubble": bubble_fraction(closed),
            "comm_overlap": comm_overlap(closed),
        }
    elif any(n.startswith("comm.") for n in names):
        doc["comm_overlap"] = comm_overlap(closed)
    if "serving.request" in names:
        doc["serving"] = {"ttft": ttft_decomposition(closed)}
    return doc


# -- the modeled two-stream schedule over a traced program -------------------

def modeled_step_timeline(program, *, flops_per_s=1e12, bytes_per_s=1e11):
    """The synthetic two-stream span set of one traced mesh step: the walk
    needs the mesh step's program, which the port does not have yet."""
    raise NotImplementedError(
        "modeled_step_timeline: the mesh train step's program is not ported "
        "(ROADMAP Queue A item 10)")


def modeled_overlap_report(program, *, flops_per_s=1e12, bytes_per_s=1e11):
    """The modeled comm-overlap report of one traced mesh step: needs the
    mesh step's program, which the port does not have yet."""
    raise NotImplementedError(
        "modeled_overlap_report: the mesh train step's program is not ported "
        "(ROADMAP Queue A item 10)")
