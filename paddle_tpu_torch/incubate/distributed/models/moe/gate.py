"""MoE gates: naive top-k, GShard top-2, Switch top-1 (the port of
paddle_tpu/incubate/distributed/models/moe/gate.py).

The routing is the JAX gate's, token for token: expert ids are the top-k of
the float32 softmax with ties to the lower index (a stable descending sort:
``torch.topk`` promises no tie order), every first choice claims capacity
before any second choice, a token's position in its expert is a cumsum over
the tokens in order, and a slot is kept while ``pos < capacity`` and its
weight is positive. Where the JAX gate returns a dense (T, E, C) dispatch
tensor, ``_topk_dispatch`` returns each slot's position in its expert, which
is what ``MoELayer`` gathers and scatters by.

Random draws (GShard's second-choice sampling, Switch's noise) come from the
device's default generator in training only, which per-layer recompute
(``checkpoint(preserve_rng_state=True)``) restores, so a recomputed forward
routes as the forward did. They cannot match the JAX package's threefry bits.
"""
from __future__ import annotations

import math

import torch

from ..... import ops
from .....nn import functional as F
from .....nn.layer.common import Linear
from .....nn.layer.layers import Layer
from .....ops._apply import defop


class BaseGate(Layer):
    def __init__(self, num_expert, world_size=1):
        super().__init__()
        self.world_size = world_size
        self.num_expert = num_expert
        self.tot_expert = num_expert * world_size
        self.loss = None

    def get_loss(self, clear=True):
        loss = self.loss
        if clear:
            self.loss = None
        return loss

    def _balance_loss(self, logits):
        """GShard §3.2 / Switch §2.2: E * sum_e(mean_gate_e * frac_top1_e)."""
        E = logits.shape[-1]
        probs = F.softmax(ops.cast(logits, "float32"), axis=-1)
        top1 = ops.argmax(probs, axis=-1)
        ce = ops.mean(ops.cast(F.one_hot(top1, E), "float32"), axis=0)
        me = ops.mean(probs, axis=0)
        return ops.sum(me * ce.detach()) * float(E)


@defop("moe_topk_dispatch", differentiable=False)
def _topk_dispatch(logits, top_k=2, capacity=0, sample=False):
    """Routing on (T, E) logits: (slot (T, K) int64, top-k weights (T, K),
    top-k expert ids (T, K), kept mask (T, K)). A kept (t, k) sits at
    position ``slot[t, k]`` of expert ``topi[t, k]``, as the JAX dispatch
    tensor's one at ``[t, topi[t, k], slot[t, k]]``."""
    T, E = logits.shape
    probs = torch.softmax(logits.float(), dim=-1)
    topi = torch.sort(probs, dim=-1, descending=True, stable=True).indices[:, :top_k]
    topw = probs.gather(1, topi)
    if sample and top_k >= 2:
        # GShard random routing: keep the 2nd expert with prob ~ 2 * its weight
        keep2 = torch.rand(T, device=logits.device) < 2.0 * topw[:, 1]
        topw[:, 1] = torch.where(keep2, topw[:, 1], torch.zeros_like(topw[:, 1]))
    cap = int(capacity)
    prev_counts = torch.zeros(E, dtype=torch.int64, device=logits.device)
    slots, kept = [], []
    # slot-major priority: all 1st choices claim capacity before any 2nd choice
    for k in range(top_k):
        idx = topi[:, k]
        onehot = torch.nn.functional.one_hot(idx, E)                    # (T, E) int64
        pos = (torch.cumsum(onehot, dim=0) * onehot).sum(-1) - 1 + prev_counts[idx]
        active = topw[:, k] > 0.0
        kept.append((pos < cap) & active)
        slots.append(pos)
        prev_counts = prev_counts + (onehot * active[:, None]).sum(0)
    return torch.stack(slots, 1), topw, topi, torch.stack(kept, 1)


class NaiveGate(BaseGate):
    """Dense softmax top-k gate, no aux loss (naive_gate.py)."""

    def __init__(self, d_model, num_expert, world_size=1, topk=2, *, device=None,
                 dtype=None):
        super().__init__(num_expert, world_size)
        self.gate = Linear(d_model, self.tot_expert, device=device, dtype=dtype)
        self.top_k = topk

    def forward(self, inp):
        logits = self.gate(inp)
        self.loss = None
        return logits

    def capacity_for(self, num_tokens, training=True):
        # no capacity pressure: every token keeps all its top-k slots
        return int(num_tokens)


class _CappedGate(BaseGate):
    def capacity_for(self, num_tokens, training=True):
        factor = self.capacity_factor[0 if training else 1]
        return max(1, int(math.ceil(factor * num_tokens * self.top_k / self.tot_expert)))


class GShardGate(_CappedGate):
    """Top-2 gate with GShard aux loss + capacity + random routing
    (gshard_gate.py)."""

    def __init__(self, d_model, num_expert, world_size=1, topk=2, capacity=(1.2, 2.4),
                 random_routing=True, group=None, *, device=None, dtype=None):
        super().__init__(num_expert, world_size)
        if topk != 2:
            raise ValueError("GShardGate supports topk=2 only (reference parity)")
        self.gate = Linear(d_model, self.tot_expert, device=device, dtype=dtype)
        self.top_k = topk
        self.capacity_factor = capacity
        self.random_routing = random_routing

    def forward(self, inp):
        logits = self.gate(inp)
        self.loss = self._balance_loss(logits)
        return logits


class SwitchGate(_CappedGate):
    """Top-1 gate with the Switch-Transformer noise + aux loss (switch_gate.py)."""

    def __init__(self, d_model, num_expert, world_size=1, topk=1, switch_eps=0.1,
                 capacity=(1.2, 2.4), group=None, *, device=None, dtype=None):
        super().__init__(num_expert, world_size)
        if topk != 1:
            raise ValueError("SwitchGate supports topk=1 only (reference parity)")
        self.gate = Linear(d_model, self.tot_expert, device=device, dtype=dtype)
        self.top_k = topk
        self.switch_eps = switch_eps
        self.capacity_factor = capacity

    def forward(self, inp):
        logits = self.gate(inp)
        if self.training and self.switch_eps > 0:
            eps = self.switch_eps
            noise = torch.rand(logits.shape, dtype=torch.float32, device=logits.device)
            logits = logits + (noise * (2.0 * eps) - eps)
        self.loss = self._balance_loss(logits)
        return logits
