"""Global-norm gradient clipping aware of expert parallelism (the port of
paddle_tpu/incubate/distributed/models/moe/grad_clip.py).

On one device every parameter is whole, so the plain global-norm sum is the
global value and no cross-group correction applies; the class keeps the
reference's constructor surface (``is_expert_param_func``, ``moe_group``).
"""
from __future__ import annotations

import torch


class ClipGradForMOEByGlobalNorm:
    def __init__(self, clip_norm, is_expert_param_func=None, moe_group=None,
                 group_name="default_moe_group"):
        self.clip_norm = float(clip_norm)
        self.is_expert_param_func = is_expert_param_func
        self.moe_group = moe_group
        self.group_name = group_name

    def __call__(self, params_grads):
        sq = None
        for _, g in params_grads:
            if g is None:
                continue
            g32 = g.float()
            s = torch.sum(g32 * g32)
            sq = s if sq is None else sq + s
        if sq is None:
            return params_grads
        clip = torch.tensor(self.clip_norm, dtype=torch.float32, device=sq.device)
        scale = clip / torch.maximum(torch.sqrt(sq), clip)
        return [(p, g if g is None else (g.float() * scale).to(g.dtype))
                for p, g in params_grads]
