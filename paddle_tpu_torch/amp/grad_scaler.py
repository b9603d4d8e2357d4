"""GradScaler: dynamic loss scaling, the port of
``paddle_tpu/amp/grad_scaler.py`` (reference python/paddle/amp/grad_scaler.py).

The scale is a host float, as in the JAX package. ``unscale_`` multiplies
every gradient of the optimizer's parameters by ``1 / scale`` and finds
whether any was non-finite in one multi-tensor pass on the device
(``torch._amp_foreach_non_finite_check_and_unscale_``), then reads that one
flag on the host: one host read a step. ``step`` skips the optimizer's step
when it was set, so the parameters, the optimizer's state and its step count
stay as they were; ``update`` then halves the scale (never below 1) after
``decr_every_n_nan_or_inf`` such steps, or doubles it after
``incr_every_n_steps`` good ones. ``unscale_`` runs once a step, before the
optimizer's gradient clipping.
"""
from __future__ import annotations

import torch

from ..ops.math import scale as _scale_op


class GradScaler:
    def __init__(
        self,
        enable=True,
        init_loss_scaling=2.0**15,
        incr_ratio=2.0,
        decr_ratio=0.5,
        incr_every_n_steps=1000,
        decr_every_n_nan_or_inf=1,
        use_dynamic_loss_scaling=True,
    ):
        self._enable = enable
        self._scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every_n_steps = incr_every_n_steps
        self._decr_every_n_nan_or_inf = decr_every_n_nan_or_inf
        self._use_dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        self._unscaled = False

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._use_dynamic

    def scale(self, var):
        if not self._enable:
            return var
        return _scale_op(var, scale=self._scale)

    def unscale_(self, optimizer):
        if not self._enable or self._unscaled:
            return
        grads = [p.grad for p in optimizer._params if p.grad is not None]
        found = False
        if grads:
            # one pass: flag non-finite values, then multiply by 1 / scale
            flag = torch.zeros(1, dtype=torch.float32, device=grads[0].device)
            inv = torch.full((1,), 1.0 / self._scale, dtype=torch.float32,
                             device=grads[0].device)
            torch._amp_foreach_non_finite_check_and_unscale_(grads, flag, inv)
            found = bool(flag.item())
        self._found_inf = found
        self._unscaled = True

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()
        self._cached_found_inf = self._found_inf

    def update(self):
        if not self._enable or not self._use_dynamic:
            self._unscaled = False
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every_n_nan_or_inf:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every_n_steps:
                self._scale *= self._incr_ratio
                self._good_steps = 0
        self._unscaled = False
        self._found_inf = False

    def minimize(self, optimizer, scaled_loss):
        scaled_loss.backward()
        self.step(optimizer)
        self.update()

    def get_loss_scaling(self, place=None):
        """The scale as a 0-d float32 tensor (on the card unless ``place``
        or ``set_device`` says otherwise)."""
        from .. import to_tensor

        return to_tensor(self._scale, dtype="float32", place=place)

    def set_init_loss_scaling(self, v):
        self._scale = float(v)

    def state_dict(self):
        return {
            "scale": self._scale,
            "incr_ratio": self._incr_ratio,
            "decr_ratio": self._decr_ratio,
            "incr_every_n_steps": self._incr_every_n_steps,
            "decr_every_n_nan_or_inf": self._decr_every_n_nan_or_inf,
            "good_steps": self._good_steps,
            "bad_steps": self._bad_steps,
        }

    def load_state_dict(self, state):
        self._scale = state["scale"]
        self._good_steps = state.get("good_steps", 0)
        self._bad_steps = state.get("bad_steps", 0)


AmpScaler = GradScaler
