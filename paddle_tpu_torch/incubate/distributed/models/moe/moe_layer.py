"""MoELayer: mixture of experts (the port of
paddle_tpu/incubate/distributed/models/moe/moe_layer.py, single device).

The routing is the JAX layer's (``gate._topk_dispatch``). The JAX layer then
builds dense (T, E, C) one-hot dispatch and combine tensors and contracts
them with einsums, which under ``NaiveGate`` (C = T) grows as T^2 * E. The
port works by index instead, with the same result:

  1. every kept (token, choice) is ordered by (expert, slot) with one stable
     sort, and its token's row is gathered into an expert-major buffer;
  2. each expert runs on its own contiguous rows (one host read of the E
     counts a layer, for the split);
  3. the outputs, times the differentiable combine weights, are scattered
     back with ``index_add`` into a float32 (T, d) accumulator, as the JAX
     combine contracts ``expert_out.astype("float32")``, and cast back to the
     input's dtype.
Every (expert, slot) holds at most one token, so each output row is the same
sum as the dense form's; only the order of the float32 sums over k differs.
The routing is not differentiable; the router's gradient flows through the
combine weights (the top-k softmax probabilities of the kept slots,
renormalised by their sum + 1e-9) and the gate's balance loss.

An expert that gets no token still runs on zero rows, so its parameters get
zero gradients, as the JAX experts get from their empty capacity slots.
Expert parallelism (``mesh=``) waits for the distributed slice.
"""
from __future__ import annotations

import torch
from torch import nn

from .....nn import functional as F
from .....nn.layer.container import LayerList
from .....nn.layer.layers import Layer
from .gate import BaseGate, GShardGate, NaiveGate, SwitchGate, _topk_dispatch

_EP_SLICE = ("expert parallelism (MoELayer(mesh=...)) is not ported yet: it belongs to "
             "the distributed slice of the port (ROADMAP Queue A item 10)")


class MoELayer(Layer):
    """paddle.incubate.distributed.models.moe.MoELayer: ``gate`` is a
    ``BaseGate``, a dict ``{"type": "gshard"|"switch"|"naive", "top_k": k}``
    or one of those names (default GShard top-2); the gate's aux loss of the
    last forward is at ``self.gate.loss``."""

    def __init__(self, d_model, experts, gate=None, moe_group=None, mp_group=None,
                 recompute_interval=0, recompute_ctx=None, mesh=None, expert_axis="ep",
                 *, device=None, dtype=None):
        super().__init__()
        if mesh is not None:
            raise NotImplementedError(_EP_SLICE)
        self.d_model = d_model
        if isinstance(experts, (list, tuple, nn.ModuleList)) and not isinstance(experts,
                                                                                LayerList):
            experts = LayerList(list(experts))
        if not isinstance(experts, LayerList):
            raise TypeError("experts must be a LayerList")
        self.experts = experts
        self.num_expert = len(self.experts)
        self.recompute_interval = recompute_interval

        if gate is None:
            gate = {"type": "gshard", "top_k": 2}
        if isinstance(gate, str):
            gate = {"type": gate, "top_k": 1 if gate == "switch" else 2}
        if isinstance(gate, dict):
            kind = gate.get("type", "gshard")
            topk = gate.get("top_k", 2)
            kw = dict(topk=topk, device=device, dtype=dtype)
            if kind == "gshard":
                gate = GShardGate(d_model, self.num_expert, **kw)
            elif kind == "switch":
                gate = SwitchGate(d_model, self.num_expert, **kw)
            elif kind in ("naive", None):
                gate = NaiveGate(d_model, self.num_expert, **kw)
            else:
                raise ValueError(f"unknown gate type {kind!r}")
        if not isinstance(gate, BaseGate):
            raise TypeError(f"gate must be a BaseGate, got {type(gate)}")
        self.gate = gate
        self.top_k = gate.top_k
        #: the E token counts of the last forward (host ints), for the split
        self.last_counts = None
        #: (dropped, routed) of the last forward, device int64 scalars: the
        #: routed (token, choice) slots (weight > 0) and those capacity dropped
        self.last_drops = None

    def _run_experts(self, rows, counts):
        """rows: the kept tokens' rows, expert-major; each expert on its own."""
        chunks = torch.split(rows, counts, dim=0)
        return torch.cat([expert(chunk) for expert, chunk in zip(self.experts, chunks)], 0)

    def route(self, x):
        """(logits, slot, topi, kept) of (T, d) tokens under this layer's gate
        and mode (the routing ``forward`` uses)."""
        T = x.shape[0]
        capacity = (self.gate.capacity_for(T, self.training)
                    if hasattr(self.gate, "capacity_for") else T)
        logits = self.gate(x)                                   # (T, E)
        sample = (isinstance(self.gate, GShardGate) and self.gate.random_routing
                  and self.training)
        slot, topw, topi, kept = _topk_dispatch(logits, top_k=self.top_k, capacity=capacity,
                                                sample=sample)
        routed = topw > 0.0
        self.last_drops = ((routed & ~kept).sum(), routed.sum())
        return logits, slot, topi, kept

    def forward(self, inp):
        """inp: (..., d_model) -> same shape. Gate aux loss at self.gate.loss."""
        orig_shape = inp.shape
        x = inp.reshape(-1, self.d_model)
        T, K, E = x.shape[0], self.top_k, self.num_expert
        logits, slot, topi, kept = self.route(x)
        # combine weights, differentiable: the kept top-k probabilities,
        # renormalised (the reference renormalises the kept top-2 gates)
        probs = F.softmax(logits.float(), axis=-1)
        w_tk = probs.gather(1, topi) * kept.float()
        w_tk = w_tk / (w_tk.sum(-1, keepdim=True) + 1e-9)

        with torch.no_grad():
            kept_flat = kept.reshape(-1)
            e_flat = topi.reshape(-1)
            span = T * K + 1        # every position is below T * K
            key = torch.where(kept_flat, e_flat * span + slot.reshape(-1),
                              torch.full_like(e_flat, E * span))
            order = torch.sort(key, stable=True).indices
            counts = torch.zeros(E, dtype=torch.int64, device=x.device).index_add_(
                0, e_flat, kept_flat.long()).tolist()                       # host read
            sel = order[:sum(counts)]
            tok = torch.div(sel, K, rounding_mode="floor")
        self.last_counts = counts
        rows = x.index_select(0, tok)
        if self.recompute_interval and self.training:
            # the reference's recompute_interval > 0 checkpoints the expert segment
            from .....distributed.fleet.recompute import recompute

            out = recompute(self._run_experts, rows, counts)
        else:
            out = self._run_experts(rows, counts)
        w = w_tk.reshape(-1).index_select(0, sel)
        y = torch.zeros(T, self.d_model, dtype=torch.float32, device=x.device)
        y = y.index_add(0, tok, out.float() * w[:, None])
        return y.to(inp.dtype).reshape(orig_shape)
