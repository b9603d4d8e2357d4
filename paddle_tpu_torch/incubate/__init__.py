"""Fused ops, experimental optimizers and the functional autograd surface of
the port (counterpart of paddle_tpu.incubate): ``nn`` (the fused functionals
and layers), ``asp`` (n:m sparsity), the graph ops, the geometric segment ops
under their incubate names, ``softmax_mask_fuse*`` and ``identity_loss``, and
``inference`` (the port's ``inference`` module). ``incubate.distributed`` (the
MoE layer) is not ported yet: it belongs to ROADMAP Queue A item 8's MoE
entry.
"""
import torch as _torch

from . import nn  # noqa: F401
from . import autograd  # noqa: F401
from . import asp  # noqa: F401

# geometric segment ops surfaced under incubate (reference incubate/__init__)
from ..geometric import segment_max, segment_mean, segment_min, segment_sum  # noqa: F401,E402


def graph_send_recv(x, src_index, dst_index, pool_type="sum", out_size=None, name=None):
    """incubate.graph_send_recv == geometric.send_u_recv (renamed upstream)."""
    from ..geometric import send_u_recv

    return send_u_recv(x, src_index, dst_index, reduce_op=pool_type, out_size=out_size)


def identity_loss(x, reduction="none"):
    """incubate.identity_loss: mark a tensor as a loss (IPU artifact in the
    reference); numerically the identity with optional reduction."""
    if reduction in (0, "sum"):
        return x.sum()
    if reduction in (1, "mean"):
        return x.mean()
    return x


def softmax_mask_fuse(x, mask, name=None):
    """incubate.softmax_mask_fuse: softmax(x + mask) in one op."""
    return _softmax_mask(x, mask)


def softmax_mask_fuse_upper_triangle(x):
    """softmax with the causal upper-triangle mask fused."""
    return _softmax_mask_triu(x)


from ..ops._apply import defop as _defop  # noqa: E402


@_defop("softmax_mask_fuse")
def _softmax_mask(x, mask):
    return _torch.softmax(x + mask, dim=-1)


@_defop("softmax_mask_fuse_upper_triangle")
def _softmax_mask_triu(x):
    causal = _torch.ones((x.shape[-2], x.shape[-1]), dtype=_torch.bool,
                         device=x.device).tril()
    return _torch.softmax(_torch.where(causal, x, -1e30), dim=-1)


from .optimizer import LookAhead, ModelAverage  # noqa: F401,E402
from . import graph_ops  # noqa: F401,E402
from .graph_ops import (  # noqa: F401,E402
    graph_khop_sampler,
    graph_reindex,
    graph_sample_neighbors,
)
from .. import inference  # noqa: F401,E402  (paddle.incubate.inference alias)

_MOE_SLICE = ("paddle_tpu_torch.incubate.distributed (the MoE layer) is not ported yet: "
              "it belongs to ROADMAP Queue A item 8's MoE entry, with LlamaMoEMLP")


def __getattr__(name):
    if name == "distributed":
        raise AttributeError(_MOE_SLICE)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
