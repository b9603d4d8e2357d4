"""Graph sampling operators: the port of ``paddle_tpu/incubate/graph_ops.py``.

Reference analogs: python/paddle/incubate/operators/{graph_khop_sampler,
graph_sample_neighbors, graph_reindex}.py — CSR-graph neighbor sampling for
GNN mini-batching. Host-side numpy, as in the JAX package: sampling is data
preparation, and the gathered subgraph tensors then feed
``paddle_tpu_torch.geometric``'s message passing. The outputs are tensors on
the device of the input tensors (the port's default device for numpy
inputs).

Each ``graph_sample_neighbors`` call seeds its ``np.random.RandomState`` with
one draw from the port's CPU generator (``_draw_seed``), so ``paddle.seed``
fixes the samples, on the card and on the CPU alike. The JAX package draws
that seed from its PRNG key stream instead, so the two packages' samples
agree when both seed draws are given the same value.
"""
from __future__ import annotations

import numpy as np
import torch

from ..geometric import _host as _np, _out_device as _device


def _draw_seed():
    """One seed for a sampling call, from the CPU's default generator."""
    return int(torch.randint(0, 2 ** 31 - 1, (), generator=torch.default_generator))


def graph_sample_neighbors(row, colptr, input_nodes, sample_size=-1, eids=None,
                           return_eids=False, perm_buffer=None, flag_perm_buffer=False,
                           name=None):
    """operators/graph_sample_neighbors.py: sample up to sample_size
    neighbors of each input node from the CSC graph (row, colptr). Draws ride
    the port's generator stream (paddle.seed), fresh per call."""
    rng = np.random.RandomState(_draw_seed())
    dev = _device(row, input_nodes)
    rows = _np(row)
    ptr = _np(colptr)
    nodes = _np(input_nodes)
    eids_np = _np(eids) if eids is not None else None  # one host copy
    out_nb, out_cnt, out_eid = [], [], []
    for n in nodes.ravel():
        lo, hi = int(ptr[n]), int(ptr[n + 1])
        nb = rows[lo:hi]
        ids = np.arange(lo, hi)
        if sample_size >= 0 and len(nb) > sample_size:
            pick = rng.choice(len(nb), sample_size, replace=False)
            nb, ids = nb[pick], ids[pick]
        out_nb.append(nb)
        out_eid.append(eids_np[ids] if eids_np is not None else ids)
        out_cnt.append(len(nb))
    neighbors = torch.from_numpy(np.concatenate(out_nb) if out_nb
                                 else np.zeros(0, rows.dtype)).to(dev)
    counts = torch.from_numpy(np.asarray(out_cnt, np.int32)).to(dev)
    if return_eids:
        return neighbors, counts, torch.from_numpy(
            np.concatenate(out_eid) if out_eid else np.zeros(0, np.int64)).to(dev)
    return neighbors, counts


def graph_reindex(x, neighbors, count, value_buffer=None, index_buffer=None,
                  flag_buffer_hashtable=False, name=None):
    """operators/graph_reindex.py: map (x | neighbors) node ids onto a dense
    0..n-1 index space, x first."""
    dev = _device(x, neighbors)
    xs = _np(x).ravel()
    nb = _np(neighbors).ravel()
    order = {}
    for v in list(xs) + list(nb):
        v = int(v)
        if v not in order:
            order[v] = len(order)
    reindex_src = np.asarray([order[int(v)] for v in nb], np.int64)
    counts = _np(count).ravel()
    reindex_dst = np.repeat(np.arange(len(xs), dtype=np.int64), counts)
    out_nodes = np.asarray(sorted(order, key=order.get), np.int64)
    return tuple(torch.from_numpy(a).to(dev) for a in (reindex_src, reindex_dst, out_nodes))


def graph_khop_sampler(row, colptr, input_nodes, sample_sizes, sorted_eids=None,
                       return_eids=False, name=None):
    """operators/graph_khop_sampler.py: multi-hop sampling = repeated
    one-hop sampling + reindex over the union frontier."""
    dev = _device(row, input_nodes)
    frontier = _np(input_nodes).ravel()
    all_nb, all_cnt, all_eid = [], [], []
    sampled_centers = []          # one center per count entry, hop order
    seen_set = set(int(v) for v in frontier)
    seen = [int(v) for v in frontier]
    for size in sample_sizes:
        if len(frontier) == 0:
            break                 # frontier exhausted: no further hops
        if return_eids:
            nb, cnt, eid = graph_sample_neighbors(
                row, colptr, frontier, sample_size=size, eids=sorted_eids,
                return_eids=True)
            all_eid.append(_np(eid))
        else:
            nb, cnt = graph_sample_neighbors(row, colptr, frontier, sample_size=size)
        nbv = _np(nb)
        all_nb.append(nbv)
        all_cnt.append(_np(cnt))
        sampled_centers.extend(int(v) for v in frontier)
        new = []
        for v in nbv:              # dedupe within the hop AND against seen
            v = int(v)
            if v not in seen_set:
                seen_set.add(v)
                seen.append(v)
                new.append(v)
        frontier = np.asarray(new, frontier.dtype)
    neighbors = np.concatenate(all_nb) if all_nb else np.zeros(0, np.int64)
    counts = np.concatenate(all_cnt) if all_cnt else np.zeros(0, np.int32)
    centers = torch.from_numpy(np.asarray(sampled_centers, np.int64)).to(dev)
    src, dst, nodes = graph_reindex(centers, neighbors, counts)
    counts_t = torch.from_numpy(counts).to(dev)
    if return_eids:
        eid_all = np.concatenate(all_eid) if all_eid else np.zeros(0, np.int64)
        return src, dst, nodes, counts_t, torch.from_numpy(eid_all).to(dev)
    return src, dst, nodes, counts_t
