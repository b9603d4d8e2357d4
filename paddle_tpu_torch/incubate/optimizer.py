"""LookAhead and ModelAverage: the port of paddle_tpu/incubate/optimizer.py
(reference: python/paddle/incubate/optimizer/{lookahead,modelaverage}.py).

Both wrap the parameters' trajectory on the host side of the step (the inner
update stays the port's fused foreach pass); the weights are written in
place, under ``torch.no_grad()``.
"""
from __future__ import annotations

import torch

from ..optimizer.optimizer import LBFGS  # noqa: F401  (exported here as in the reference)

__all__ = ["LookAhead", "ModelAverage", "LBFGS"]


class LookAhead:
    """LookAhead(inner_optimizer, alpha, k): every k steps the slow weights
    move alpha of the way toward the fast weights and the fast weights reset
    to them."""

    def __init__(self, inner_optimizer, alpha=0.5, k=5, name=None):
        self.inner_optimizer = inner_optimizer
        self.alpha = float(alpha)
        self.k = int(k)
        self._step_count = 0
        self._slow = {}

    def _params(self):
        return self.inner_optimizer._parameter_list

    @torch.no_grad()
    def step(self):
        self.inner_optimizer.step()
        self._step_count += 1
        if self._step_count % self.k:
            return
        for p in self._params():
            slow = self._slow.get(id(p))
            if slow is None:
                slow = p.detach().clone()  # first sync: slow starts at the fast weights
            slow = slow + self.alpha * (p - slow)
            self._slow[id(p)] = slow
            p.copy_(slow)

    def clear_grad(self, set_to_zero=True):
        self.inner_optimizer.clear_grad(set_to_zero)

    def get_lr(self):
        return self.inner_optimizer.get_lr()

    def state_dict(self):
        return self.inner_optimizer.state_dict()

    def minimize(self, loss, **kw):
        loss.backward()
        self.step()
        self.clear_grad()


class ModelAverage:
    """A running sum of the parameters over a bounded window; ``apply()``
    swaps the averaged weights in (for evaluation), ``restore()`` swaps the
    trained ones back."""

    def __init__(self, average_window_rate, parameters=None, min_average_window=10000,
                 max_average_window=10000, name=None):
        self.rate = float(average_window_rate)
        self.min_average_window = int(min_average_window)
        self.max_average_window = int(max_average_window)
        self._parameters = list(parameters or [])
        self._sum = {id(p): torch.zeros_like(p) for p in self._parameters}
        self._count = 0
        self._backup = None

    @torch.no_grad()
    def step(self):
        self._count += 1
        for p in self._parameters:
            self._sum[id(p)] = self._sum[id(p)] + p
        # bound the accumulation window (modelaverage.py's window restart)
        window = max(self.min_average_window,
                     min(self.max_average_window, int(self._count * self.rate) or 1))
        if self._count > window:
            for p in self._parameters:
                self._sum[id(p)] = self._sum[id(p)] * (window / self._count)
            self._count = window

    @torch.no_grad()
    def apply(self, executor=None, need_restore=True):
        if self._count == 0:
            return
        self._backup = {id(p): p.detach().clone() for p in self._parameters}
        for p in self._parameters:
            p.copy_(self._sum[id(p)] / self._count)

    @torch.no_grad()
    def restore(self, executor=None):
        if self._backup is None:
            return
        for p in self._parameters:
            p.copy_(self._backup[id(p)])
        self._backup = None
