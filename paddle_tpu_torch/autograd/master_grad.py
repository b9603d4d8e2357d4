"""Master gradients (``amp.decorate(master_grad=True)``): the port of the JAX
tape's master-grad mode (``paddle_tpu/autograd/tape.py`` ``_master_vjp``).

The contract: every op whose inputs are float16 or bfloat16 has its pullback
run again in float32, at its inputs upcast to float32; cotangents stay
float32 from end to end, a ``cast`` passes a float32 cotangent straight
through, and the reduced-precision parameters' gradients are float32 (the
optimizer reads them as master gradients).

PyTorch's engine casts every gradient to the dtype of the tensor it flows
into, so float32 cotangents cannot ride the engine's own edges between
bfloat16 activations. Here they travel beside them. Under the mode the
dispatch (``ops/_apply.py`` ``apply``) runs such an op as ``_MasterFn``, a
``torch.autograd.Function``:

- its forward is the op's function on the op's own inputs, under no-grad,
  so the outputs, their dtypes and the operator stats are what they are
  without the mode;
- its backward takes the float32 cotangents the consumers left on the node
  (``pt_cots``, one slot an output, summed over fan-out) plus whatever the
  engine brings (from code outside the dispatch), reruns the op's function
  at the float32-upcast inputs with the dispatch's AMP cast, scan and stats
  off, and pulls the cotangents back in float32;
- it hands each reduced-precision input's float32 cotangent to the input's
  producer's slot when the producer is a ``_MasterFn`` node, and returns
  nothing to the engine for it; the engine still runs the producer after
  every consumer (it counts the edges), so the slot is whole when read.
  Other inputs get their gradient through the engine: a leaf with
  ``grad_dtype`` float32 (``decorate`` sets it on the parameters it casts)
  keeps it float32, an input made by code outside the dispatch gets it
  in its own dtype.

An op whose inputs are all float32 runs as it does without the mode (its
pullback is float32 already), and so does an op with no input that needs
grad. Not covered, as the engine cannot carry it: a bfloat16 tensor made by
torch code outside the dispatch, which takes its gradient in bfloat16, and
the inputs ``paddle.grad`` asks for, whose gradients torch captures at
their engine edges (``engine_edges_only``).
"""
from __future__ import annotations

import contextlib

import torch
from torch.utils import _pytree as pytree

from ..ops import _apply

_REDUCED = (torch.float16, torch.bfloat16)
_TENSOR = object()  # an output's slot for a tensor, in ``_Call.out_leaves``
#: the mode's switch, read by ``apply``
_MODE = _apply._MASTER_GRAD
#: [hand float32 cotangents to their producers' slots]; off inside
#: ``paddle.grad``, where torch captures each requested input's gradient at
#: its engine edge
_ROUTE = [True]


def set_master_grad(mode):
    """The process-wide switch (``amp.decorate(level="O2",
    master_grad=...)`` sets it from its argument)."""
    _MODE[0] = bool(mode)


def master_grad_enabled():
    return _MODE[0]


@contextlib.contextmanager
def master_grad():
    """Run inside this context with master gradients on."""
    prev = _MODE[0]
    _MODE[0] = True
    try:
        yield
    finally:
        _MODE[0] = prev


@contextlib.contextmanager
def engine_edges_only():
    """Every cotangent through torch's engine (``paddle.grad`` under the
    mode): the ops' pullbacks still run in float32, and a reduced-precision
    input that is not a float32-gradient leaf takes its gradient in its own
    dtype."""
    prev = _ROUTE[0]
    _ROUTE[0] = False
    try:
        yield
    finally:
        _ROUTE[0] = prev


@contextlib.contextmanager
def _plain_dispatch():
    """The op's function as a pure function: no AMP cast, no NaN/Inf scan,
    no operator stats and no master mode for the ops it calls."""
    amp = list(_apply._AMP_STATE)
    stats, mode, nan = _apply._OP_STATS[0], _MODE[0], _apply._NAN_FLAG["value"]
    _apply._AMP_STATE.clear()
    _apply._OP_STATS[0] = None
    _MODE[0] = False
    _apply._NAN_FLAG["value"] = False
    try:
        yield
    finally:
        _apply._AMP_STATE[:] = amp
        _apply._OP_STATS[0] = stats
        _MODE[0] = mode
        _apply._NAN_FLAG["value"] = nan


def _grad_leaf(v):
    return isinstance(v, torch.Tensor) and v.requires_grad and v.is_floating_point()


class _Call:
    """One op call: the op, its flattened arguments with the tensors that
    need grad taken out (``idx``), and the output structure."""
    __slots__ = ("opdef", "leaves", "spec", "idx", "dtypes", "producers", "out_spec",
                 "out_leaves")

    def __init__(self, opdef, leaves, spec, idx, tensors):
        self.opdef, self.leaves, self.spec, self.idx = opdef, leaves, spec, idx
        self.dtypes = [t.dtype for t in tensors]
        self.producers = [_producer(t) if t.dtype in _REDUCED else None for t in tensors]
        self.out_spec = self.out_leaves = None

    def call(self, tensors, upcast=False):
        leaves = list(self.leaves)
        for i, t in zip(self.idx, tensors):
            leaves[i] = t
        if upcast:
            leaves = [v.float() if isinstance(v, torch.Tensor) and v.dtype in _REDUCED
                      else v for v in leaves]
        args, kwargs = pytree.tree_unflatten(leaves, self.spec)
        return self.opdef.fn(*args, **kwargs)


def _producer(t):
    node = t.grad_fn
    if node is not None and getattr(node, "pt_cots", None) is not None:
        return node, t.output_nr
    return None


class _MasterFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, call, *tensors):
        out = call.call(tensors)
        leaves, call.out_spec = pytree.tree_flatten(out)
        is_t = [isinstance(v, torch.Tensor) for v in leaves]
        call.out_leaves = [_TENSOR if t else v for t, v in zip(is_t, leaves)]
        outs = tuple(v for v, t in zip(leaves, is_t) if t)
        ctx.mark_non_differentiable(*[o for o in outs if not o.is_floating_point()])
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(*tensors)
        ctx.call = call
        ctx.pt_cots = [None] * len(outs)
        return outs

    @staticmethod
    def backward(ctx, *grads):
        call = ctx.call
        cots = []
        for side, g in zip(ctx.pt_cots, grads):
            if g is not None:
                g = g.float() if g.dtype in _REDUCED else g
                side = g if side is None else side + g
            cots.append(side)
        ctx.pt_cots = [None] * len(cots)
        n = len(call.idx)
        if all(c is None for c in cots):
            return (None,) * (n + 1)
        tensors = ctx.saved_tensors  # may rerun a checkpointed segment: before the switch
        if call.opdef.name == "cast":
            # the identity between floating dtypes: the float32 cotangent
            # passes straight through
            in_grads = [cots[0]]
        else:
            with torch.enable_grad(), _plain_dispatch():
                xs = [t.detach().float() if t.dtype in _REDUCED else t.detach()
                      for t in tensors]
                for x in xs:
                    x.requires_grad_(True)
                outs = [v for v in pytree.tree_leaves(call.call(xs, upcast=True))
                        if isinstance(v, torch.Tensor)]
                pairs = [(o, c.to(o.dtype)) for o, c in zip(outs, cots)
                         if c is not None and o.requires_grad]
                if pairs:
                    in_grads = torch.autograd.grad([o for o, _ in pairs], xs,
                                                   [c for _, c in pairs], allow_unused=True)
                else:
                    in_grads = [None] * n
        res = []
        for g, dt, prod in zip(in_grads, call.dtypes, call.producers):
            if g is None:
                res.append(None)
            elif dt in _REDUCED:
                g = g.float()
                if prod is not None and _ROUTE[0]:
                    node, nr = prod
                    slot = node.pt_cots
                    slot[nr] = g if slot[nr] is None else slot[nr] + g
                    res.append(None)
                else:
                    res.append(g)
            else:
                res.append(g.to(dt))
        return (None, *res)


def master_call(opdef, args, kwargs):
    """Run one differentiable op under the mode (``apply`` calls this with
    grad enabled)."""
    leaves, spec = pytree.tree_flatten((args, kwargs))
    idx = [i for i, v in enumerate(leaves) if _grad_leaf(v)]
    if not idx or not (opdef.name == "cast" or any(
            isinstance(v, torch.Tensor) and v.dtype in _REDUCED for v in leaves)):
        return opdef.fn(*args, **kwargs)
    tensors = [leaves[i] for i in idx]
    taken = set(idx)
    call = _Call(opdef, [None if i in taken else v for i, v in enumerate(leaves)], spec, idx,
                 tensors)
    outs = _MasterFn.apply(call, *tensors)
    it = iter(outs)
    merged = [next(it) if v is _TENSOR else v for v in call.out_leaves]
    call.out_leaves = None
    return pytree.tree_unflatten(merged, call.out_spec)


_apply._MASTER_CALL[0] = master_call
