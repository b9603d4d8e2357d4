"""PyLayer: user-defined autograd functions, the port of
``paddle_tpu/autograd/py_layer.py`` as a ``torch.autograd.Function``.

The JAX semantics hold: the user's ``forward`` runs under no-grad with a
``PyLayerContext``; its outputs need grad only when grad is enabled and a
tensor input needs grad; the user's ``backward`` runs under no-grad, and a
backward that returns fewer gradients than there are tensor inputs, or
``None`` for one, gives zeros for the rest. ``ctx.save_for_backward`` saves
through torch's context, so ``saved_tensors_hooks`` see those tensors.
"""
from __future__ import annotations

import torch


class PyLayerContext:
    def __init__(self):
        self._fctx = None
        self._saved = ()
        self.not_inplace_tensors = ()
        self.materialize_grads = True

    def save_for_backward(self, *tensors):
        if self._fctx is not None and all(isinstance(t, torch.Tensor) for t in tensors):
            self._fctx.save_for_backward(*tensors)
            self._saved = None
        else:
            self._saved = tensors

    def saved_tensor(self):
        if self._saved is None:
            return tuple(self._fctx.saved_tensors)
        return self._saved

    saved_tensors = property(saved_tensor)

    def mark_not_inplace(self, *tensors):
        self.not_inplace_tensors = tensors

    def mark_non_differentiable(self, *tensors):
        self._fctx.mark_non_differentiable(*tensors)

    def set_materialize_grads(self, value):
        self.materialize_grads = bool(value)


class _PyLayerFn(torch.autograd.Function):
    @staticmethod
    def forward(fctx, cls, ctx, args, kwargs, n_in, *tensors):
        ctx._fctx = fctx
        fctx.pt_ctx, fctx.pt_cls = ctx, cls
        fctx.pt_inputs = [(t.shape, t.dtype, t.device, t.requires_grad) for t in tensors]
        outs = cls.forward(ctx, *args, **kwargs)
        single = not isinstance(outs, (tuple, list))
        out_list = [outs] if single else list(outs)
        fctx.pt_structure = (single, type(outs),
                             [isinstance(o, torch.Tensor) for o in out_list], out_list)
        fctx.set_materialize_grads(ctx.materialize_grads)
        # an output that is an input is returned as a view of it by torch
        return tuple(o for o in out_list if isinstance(o, torch.Tensor))

    @staticmethod
    def backward(fctx, *grads):
        ctx, cls = fctx.pt_ctx, fctx.pt_cls
        with torch.no_grad():
            got = cls.backward(ctx, *grads)
        if not isinstance(got, (tuple, list)):
            got = (got,)
        got = list(got) + [None] * (len(fctx.pt_inputs) - len(got))
        out = []
        for g, (shape, dtype, device, needs) in zip(got, fctx.pt_inputs):
            if g is None and needs:
                g = torch.zeros(shape, dtype=dtype, device=device)
            out.append(g)
        return (None, None, None, None, None, *out)


class PyLayer:
    """paddle.autograd.PyLayer: subclass with static ``forward(ctx, ...)``
    and ``backward(ctx, *grads)``, call ``apply``."""

    @staticmethod
    def forward(ctx, *args, **kwargs):
        raise NotImplementedError

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError

    @classmethod
    def apply(cls, *args, **kwargs):
        ctx = PyLayerContext()
        tensors = [a for a in args if isinstance(a, torch.Tensor)] + [
            v for v in kwargs.values() if isinstance(v, torch.Tensor)]
        outs = _PyLayerFn.apply(cls, ctx, args, kwargs, len(tensors), *tensors)
        single, kind, is_tensor, out_list = ctx._fctx.pt_structure if ctx._fctx else (
            None, None, None, None)
        if single is None:
            raise RuntimeError("PyLayer.apply: forward did not run")
        ctx._fctx.pt_structure = None  # drop the references to the outputs
        it = iter(outs if isinstance(outs, tuple) else (outs,))
        merged = [next(it) if t else o for t, o in zip(is_tensor, out_list)]
        if single:
            return merged[0]
        return kind(merged) if kind in (tuple, list) else tuple(merged)


class LegacyPyLayer(PyLayer):
    pass
