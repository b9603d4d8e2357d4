"""paddle.geometric: graph message passing and segment reductions, the port of
``paddle_tpu/geometric.py``.

Reference analog: python/paddle/geometric/ (message_passing/send_recv.py
send_u_recv/send_ue_recv, math segment_{sum,mean,max,min}, sampling) over
dedicated scatter CUDA kernels.

The reductions are ops of the port's dispatch with the JAX names
(``geometric.segment_reduce``, ``geometric.send_u_recv``,
``geometric.send_ue_recv``, ``graph_send_uv``): a gather (``index_select``)
and a scatter, ``index_add`` for sum and mean and ``scatter_reduce`` for max
and min, on the tensors' device. They keep ``jax.ops.segment_*``'s
arithmetic: a mean divides by ``max(count, 1)`` in the data's dtype, and an
empty segment's max (min) is the dtype's lowest (highest) value, ``-inf``
(``inf``) for floats. Segment ids must lie in ``[0, count)``. Without
``count`` the segment count is ``max(ids) + 1``, read on the host.

``reindex_graph``/``reindex_heter_graph`` and the neighbour samplers are host
numpy, as in the JAX package (their output sizes depend on the data): the
samplers draw from ``np.random.RandomState()`` as the JAX functions do, and
the outputs are int64 tensors on the device of the input tensor (the port's
default device for numpy inputs).
"""
from __future__ import annotations

import numpy as np
import torch

from .ops._apply import defop

Tensor = torch.Tensor


def _lowest(dtype, op):
    if dtype.is_floating_point:
        return float("-inf") if op == "max" else float("inf")
    info = torch.iinfo(dtype)
    return info.min if op == "max" else info.max


def _scatter(msgs, ids, n, op):
    """Rows of ``msgs`` reduced onto ``n`` segments by ``ids``."""
    ids = ids.long()
    shape = (n,) + tuple(msgs.shape[1:])
    if op in ("sum", "mean"):
        out = msgs.new_zeros(shape).index_add(0, ids, msgs)
        if op == "mean":
            cnt = msgs.new_zeros((n,)).index_add(0, ids, msgs.new_ones((msgs.shape[0],)))
            out = out / cnt.clamp(min=1.0).reshape((n,) + (1,) * (msgs.dim() - 1))
        return out
    idx = ids.reshape((-1,) + (1,) * (msgs.dim() - 1)).expand_as(msgs)
    init = torch.full(shape, _lowest(msgs.dtype, op), dtype=msgs.dtype, device=msgs.device)
    return init.scatter_reduce(0, idx, msgs, "amax" if op == "max" else "amin",
                               include_self=True)


@defop("geometric.segment_reduce")
def _segment_reduce(data, segment_ids, num_segments=0, pool_type="sum"):
    if pool_type not in ("sum", "mean", "max", "min"):
        raise ValueError(f"unknown pool_type {pool_type!r}")
    return _scatter(data, segment_ids, int(num_segments), pool_type)


def _segments_from(ids, count):
    """The segment count: the caller's ``count``, or max(ids) + 1 read on
    the host."""
    if count is not None:
        return int(count)
    return int(torch.as_tensor(ids).max()) + 1


def segment_sum(data, segment_ids, count=None, name=None):
    return _segment_reduce(data, segment_ids,
                           num_segments=_segments_from(segment_ids, count),
                           pool_type="sum")


def segment_mean(data, segment_ids, count=None, name=None):
    return _segment_reduce(data, segment_ids,
                           num_segments=_segments_from(segment_ids, count),
                           pool_type="mean")


def segment_max(data, segment_ids, count=None, name=None):
    return _segment_reduce(data, segment_ids,
                           num_segments=_segments_from(segment_ids, count),
                           pool_type="max")


def segment_min(data, segment_ids, count=None, name=None):
    return _segment_reduce(data, segment_ids,
                           num_segments=_segments_from(segment_ids, count),
                           pool_type="min")


@defop("geometric.send_u_recv")
def _send_u_recv(x, src_index, dst_index, reduce_op="sum", out_size=0):
    if reduce_op not in ("sum", "mean", "max", "min"):
        raise ValueError(f"unknown reduce_op {reduce_op!r}")
    msgs = x.index_select(0, src_index.long())          # gather source features
    n = int(out_size) if out_size else x.shape[0]
    return _scatter(msgs, dst_index, n, reduce_op)


def send_u_recv(x, src_index, dst_index, reduce_op="sum", out_size=None, name=None):
    """Gather x[src] and scatter-reduce onto dst
    (reference send_recv.py send_u_recv)."""
    return _send_u_recv(x, src_index, dst_index, reduce_op=reduce_op,
                        out_size=int(out_size) if out_size else 0)


@defop("geometric.send_ue_recv")
def _send_ue_recv(x, e, src_index, dst_index, message_op="add", reduce_op="sum",
                  out_size=0):
    msgs = x.index_select(0, src_index.long())
    if message_op == "add":
        msgs = msgs + e
    elif message_op == "mul":
        msgs = msgs * e
    else:
        raise ValueError(f"unknown message_op {message_op!r}")
    if reduce_op not in ("sum", "mean", "max"):
        raise ValueError(f"unknown reduce_op {reduce_op!r}")
    n = int(out_size) if out_size else x.shape[0]
    return _scatter(msgs, dst_index, n, reduce_op)


def send_ue_recv(x, e, src_index, dst_index, message_op="add", reduce_op="sum",
                 out_size=None, name=None):
    """Edge-featured message passing (reference send_recv.py send_ue_recv)."""
    return _send_ue_recv(x, e, src_index, dst_index, message_op=message_op,
                         reduce_op=reduce_op, out_size=int(out_size) if out_size else 0)


@defop("graph_send_uv")
def _send_uv(x, y, src_index, dst_index, message_op="add"):
    xs = x.index_select(0, src_index.long())
    yd = y.index_select(0, dst_index.long())
    if message_op == "add":
        return xs + yd
    if message_op == "sub":
        return xs - yd
    if message_op == "mul":
        return xs * yd
    if message_op == "div":
        return xs / yd
    raise ValueError(f"unknown message_op {message_op!r}")


def send_uv(x, y, src_index, dst_index, message_op="add", name=None):
    """Per-edge message from source and destination node features
    (reference geometric/message_passing/send_recv.py:413 send_uv):
    out[i] = op(x[src_index[i]], y[dst_index[i]])."""
    return _send_uv(x, y, src_index, dst_index, message_op=message_op)


def _host(x):
    """A flat numpy copy of a tensor, array or sequence."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy().reshape(-1)
    return np.asarray(x).reshape(-1)


def _out_device(*xs):
    """The device of the first tensor among ``xs``, else the port's default."""
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    from . import resolve_device

    return resolve_device(None)


def _reindex(x_np, neigh_np, count_np=None):
    """Renumber: input nodes first, then neighbors by first appearance.
    Returns (reindex_src, reindex_dst, out_nodes); reindex_dst is None when
    count_np is (the heterogeneous caller builds its own per-type repeat)."""
    mapping = {int(v): i for i, v in enumerate(x_np)}
    out_nodes = list(x_np)
    reindex_src = np.empty(len(neigh_np), np.int64)
    for i, v in enumerate(neigh_np):
        v = int(v)
        idx = mapping.get(v)
        if idx is None:
            idx = len(out_nodes)
            mapping[v] = idx
            out_nodes.append(v)
        reindex_src[i] = idx
    reindex_dst = (np.repeat(np.arange(len(x_np), dtype=np.int64), count_np)
                   if count_np is not None else None)
    return reindex_src, reindex_dst, np.asarray(out_nodes, x_np.dtype)


def reindex_graph(x, neighbors, count, value_buffer=None, index_buffer=None, name=None):
    """Renumber sampled subgraph nodes from 0 (reference reindex.py:34):
    input nodes first, then neighbors in order of first appearance. Returns
    (reindex_src, reindex_dst, out_nodes). Host-side by nature — the output
    size is data-dependent (graph sampling is a data-pipeline step)."""
    dev = _out_device(x, neighbors, count)
    rs, rd, out = _reindex(_host(x), _host(neighbors), _host(count))
    return tuple(torch.from_numpy(a).to(dev) for a in (rs, rd, out))


def reindex_heter_graph(x, neighbors, count, value_buffer=None, index_buffer=None,
                        name=None):
    """reference reindex.py:153 — reindex a heterogeneous sampled graph:
    per-edge-type neighbor/count lists share ONE node renumbering."""
    dev = _out_device(x, *neighbors)
    x_np = _host(x)
    neighs = [_host(n) for n in neighbors]
    counts = [_host(c) for c in count]
    # each edge type carries its own per-input-node count vector; the dst
    # index is the per-type repeat, concatenated in type order
    rd = np.concatenate([np.repeat(np.arange(len(x_np), dtype=np.int64), c) for c in counts])
    rs, _, out = _reindex(x_np, np.concatenate(neighs))
    return tuple(torch.from_numpy(a).to(dev) for a in (rs, rd, out))


def _sample_from_csc(row, colptr, input_nodes, sample_size, eids=None, weights=None,
                     seed=None):
    rng = np.random.RandomState(seed)
    out_n, out_c, out_e = [], [], []
    for node in input_nodes:
        beg, end = int(colptr[node]), int(colptr[node + 1])
        idx = np.arange(beg, end)
        if 0 <= sample_size < len(idx):
            if weights is not None:
                w = np.asarray(weights[beg:end], np.float64)
                p = w / w.sum() if w.sum() > 0 else None
                idx = rng.choice(idx, size=sample_size, replace=False, p=p)
            else:
                idx = rng.choice(idx, size=sample_size, replace=False)
        out_n.append(row[idx])
        out_c.append(len(idx))
        if eids is not None:
            out_e.append(eids[idx])
    dt = np.asarray(row).dtype
    neigh = np.concatenate(out_n) if out_n else np.empty(0, dt)
    cnt = np.asarray(out_c, dt)
    es = None
    if eids is not None:  # empty input_nodes still yields an empty eids
        es = np.concatenate(out_e) if out_e else np.empty(0, dt)
    return neigh, cnt, es


def _sampled(row, neigh, cnt, es, return_eids):
    dev = _out_device(row)
    outs = (torch.from_numpy(neigh).to(dev), torch.from_numpy(cnt).to(dev))
    if return_eids:
        return (*outs, torch.from_numpy(es).to(dev))
    return outs


def sample_neighbors(row, colptr, input_nodes, sample_size=-1, eids=None,
                     return_eids=False, perm_buffer=None, name=None):
    """Uniform neighbor sampling over a CSC graph (reference
    sampling/neighbors.py:30). Returns (out_neighbors, out_count[, out_eids]).
    Host-side: output size is data-dependent."""
    if return_eids and eids is None:
        raise ValueError("return_eids=True needs eids")
    e_np = _host(eids) if eids is not None else None
    neigh, cnt, es = _sample_from_csc(_host(row), _host(colptr), _host(input_nodes),
                                      int(sample_size), e_np)
    return _sampled(row, neigh, cnt, es, return_eids)


def weighted_sample_neighbors(row, colptr, edge_weight, input_nodes, sample_size=-1,
                              eids=None, return_eids=False, name=None):
    """Weight-proportional neighbor sampling without replacement (reference
    sampling/neighbors.py weighted_sample_neighbors)."""
    if return_eids and eids is None:
        raise ValueError("return_eids=True needs eids")
    e_np = _host(eids) if eids is not None else None
    neigh, cnt, es = _sample_from_csc(_host(row), _host(colptr), _host(input_nodes),
                                      int(sample_size), e_np, weights=_host(edge_weight))
    return _sampled(row, neigh, cnt, es, return_eids)
