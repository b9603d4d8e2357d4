"""Gradient clipping: the port of paddle_tpu/nn/clip.py (reference:
python/paddle/nn/clip.py).

A clipper is a callable over ``[(param, grad), ...]`` that returns new
pairs; the optimizer calls it before the update (``grad_clip=``), and
``param.grad`` itself is left as it was, as in the JAX package. The formulas
are the JAX package's, which are not torch's:
  * ``ClipGradByGlobalNorm``: every gradient times ``clip / max(norm,
    clip)``, the norm over all gradients with squares taken in float32;
  * ``ClipGradByNorm``: each gradient times ``min(clip / max(norm, 1e-12),
    1)``, its own norm;
  * ``clip_grad_norm_``: in place, times ``min(max / max(total, 1e-6), 1)``
    rounded to the gradient's dtype.
A parameter whose ``need_clip`` is False is passed through unclipped (and
left out of the global norm). Norms stay on the device (``torch._foreach_norm``
in float32): clipping makes no host sync.
"""
from __future__ import annotations

import torch

__all__ = ["ClipGradBase", "ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm",
           "clip_grad_norm_", "clip_grad_value_"]


def _clipped(params_grads):
    """Indices of the pairs that are clipped."""
    return [i for i, (p, g) in enumerate(params_grads)
            if g is not None and getattr(p, "need_clip", True)]


def _replace(params_grads, idx, grads):
    out = list(params_grads)
    for i, g in zip(idx, grads):
        out[i] = (params_grads[i][0], g)
    return out


class ClipGradBase:
    def __call__(self, params_grads):
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):  # noqa: A002
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def __call__(self, params_grads):
        idx = _clipped(params_grads)
        return _replace(params_grads, idx,
                        [params_grads[i][1].clamp(self.min, self.max) for i in idx])


class ClipGradByNorm(ClipGradBase):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        idx = _clipped(params_grads)
        grads = [params_grads[i][1] for i in idx]
        if not grads:
            return list(params_grads)
        # each gradient's own norm, in its dtype as in the JAX package
        norms = torch._foreach_norm(grads)
        torch._foreach_clamp_min_(norms, 1e-12)
        scales = torch._foreach_reciprocal(norms)
        torch._foreach_mul_(scales, self.clip_norm)
        torch._foreach_clamp_max_(scales, 1.0)
        return _replace(params_grads, idx, torch._foreach_mul(grads, scales))


def global_norm(grads):
    """sqrt of the sum of squares of every gradient, in float32, on the
    device."""
    norms = torch._foreach_norm(grads, 2, dtype=torch.float32)
    return torch.linalg.vector_norm(torch.stack(norms))


class ClipGradByGlobalNorm(ClipGradBase):
    def __init__(self, clip_norm, group_name="default_group", auto_skip_clip=False):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def __call__(self, params_grads):
        idx = _clipped(params_grads)
        grads = [params_grads[i][1] for i in idx]
        if not grads:
            return list(params_grads)
        scale = self.clip_norm / global_norm(grads).clamp(min=self.clip_norm)
        # float32 scale: a low-precision gradient is multiplied in float32
        # and rounded to its dtype (the JAX package's astype round trip)
        return _replace(params_grads, idx, torch._foreach_mul(grads, scale))


def _as_list(parameters):
    return [parameters] if isinstance(parameters, torch.Tensor) else list(parameters)


def clip_grad_norm_(parameters, max_norm, norm_type=2.0, error_if_nonfinite=False):
    """Scale every ``param.grad`` in place so that their total ``norm_type``
    norm is at most ``max_norm``; returns the total norm (a device tensor)."""
    grads = [p.grad for p in _as_list(parameters) if p.grad is not None]
    if not grads:
        return torch.zeros(())
    if norm_type == float("inf"):
        total = torch.stack(torch._foreach_norm(grads, float("inf"))).max()
    else:
        total = torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(grads, norm_type, dtype=torch.float32)),
            norm_type)
    scale = (max_norm / total.clamp(min=1e-6)).clamp(max=1.0)
    for g in grads:
        g.mul_(scale.to(g.dtype))
    return total


def clip_grad_value_(parameters, clip_value):
    """Clamp every ``param.grad`` to [-clip_value, clip_value] in place."""
    for p in _as_list(parameters):
        if p.grad is not None:
            p.grad.clamp_(-clip_value, clip_value)
