"""paddle.nn.utils of the port: the port of paddle_tpu/nn/utils/__init__.py.

``weight_norm`` and ``spectral_norm`` reparameterize a layer's weight with a
forward pre-hook that recomputes it from the trained parameters before every
call (in eval too), with the JAX parameter names, shapes and order:
``weight_norm`` trains ``{name}_v`` (the weight) and ``{name}_g`` (its norm
over every dim but ``dim``, the reduced dims kept, so ``Linear``'s
``weight_g`` is ``[in, 1]`` at ``dim=0``; a scalar at ``dim=None``), and
``w = g * v * max(|v|^2, 1e-24)^-1/2``; ``spectral_norm`` trains
``{name}_orig`` and divides it by ``u^T W v``, ``u`` and ``v`` from
``n_power_iterations`` of the power method, ``u`` starting from
``np.random.RandomState(0).randn`` and carried from call to call on the
hook (not in the ``state_dict``, as in JAX). A JAX ``state_dict`` of a
reparameterized layer therefore loads into the port's. The derived weight is
a plain attribute of the layer; ``remove_weight_norm`` folds it back into a
parameter. ``copy.deepcopy`` of such a layer copies the derived weight as a
detached tensor (the copy's next call recomputes it), since torch cannot
deep-copy a tensor with a history.

``parameters_to_vector`` concatenates detached values;
``vector_to_parameters`` writes the slices back in place under ``no_grad``.
The clippers are ``nn/clip.py``'s.
"""
from __future__ import annotations

import copy
import functools

import numpy as np
import torch

from ...framework import Parameter
from ..clip import clip_grad_norm_, clip_grad_value_  # noqa: F401

__all__ = ["weight_norm", "remove_weight_norm", "spectral_norm", "parameters_to_vector",
           "vector_to_parameters", "clip_grad_norm_", "clip_grad_value_"]


def _other_dims(v, dim):
    return [i for i in range(v.dim()) if i != dim]


def _deepcopy_reparameterized(layer, memo):
    """``copy.deepcopy`` of a layer with derived weights: the derived ones
    are copied detached (module docstring)."""
    d = layer.__dict__
    names = d["_derived_weights"]
    saved = {n: d.pop(n) for n in names if n in d}
    copier = d.pop("__deepcopy__")
    try:
        twin = copy.deepcopy(layer, memo)
    finally:
        d.update(saved)
        d["__deepcopy__"] = copier
    for n, w in saved.items():
        twin.__dict__[n] = w.detach().clone()
    twin.__dict__["__deepcopy__"] = functools.partial(_deepcopy_reparameterized, twin)
    return twin


def _derive(layer, name):
    """Mark ``name`` as a weight the layer's pre-hook recomputes."""
    d = layer.__dict__
    d.setdefault("_derived_weights", set()).add(name)
    d["__deepcopy__"] = functools.partial(_deepcopy_reparameterized, layer)


class _WeightNormHook:
    def __init__(self, layer, name, dim):
        self.name = name
        self.dim = dim
        v = getattr(layer, name).detach().clone()
        with torch.no_grad():
            g = (torch.sqrt((v * v).sum()) if dim is None
                 else torch.sqrt((v * v).sum(_other_dims(v, dim), keepdim=True)))
        layer.add_parameter(name + "_v", Parameter(v))
        layer.add_parameter(name + "_g", Parameter(g))
        # the weight becomes a derived tensor, recomputed before every call
        del layer._parameters[name]
        _derive(layer, name)
        self._recompute(layer)

    def _recompute(self, layer):
        v = getattr(layer, self.name + "_v")
        g = getattr(layer, self.name + "_g")
        norm = ((v * v).sum() if self.dim is None
                else (v * v).sum(_other_dims(v, self.dim), keepdim=True))
        setattr(layer, self.name, g * v * norm.clamp(min=1e-24) ** -0.5)

    def __call__(self, layer, inputs):
        self._recompute(layer)
        return inputs


def weight_norm(layer, name="weight", dim=0):
    """w = g * v / ||v||, with g and v trained in w's place (module
    docstring)."""
    hook = _WeightNormHook(layer, name, dim)
    handle = layer.register_forward_pre_hook(hook)
    hooks = layer.__dict__.setdefault("_weight_norm_hooks", {})
    hooks[name] = (hook, handle)
    return layer


def remove_weight_norm(layer, name="weight"):
    """Fold g * v / ||v|| back into a plain trained parameter ``name``."""
    hooks = layer.__dict__.get("_weight_norm_hooks", {})
    if name not in hooks:
        raise ValueError(f"weight_norm was not applied to {name!r}")
    hook, handle = hooks.pop(name)
    hook._recompute(layer)
    w = getattr(layer, name).detach().clone()
    handle.remove()
    del layer._parameters[name + "_v"]
    del layer._parameters[name + "_g"]
    delattr(layer, name)
    layer.__dict__["_derived_weights"].discard(name)
    if not layer.__dict__["_derived_weights"]:
        del layer.__dict__["_derived_weights"], layer.__dict__["__deepcopy__"]
    layer.add_parameter(name, Parameter(w))
    return layer


class _SpectralNormHook:
    def __init__(self, layer, name, n_power_iterations, eps, dim):
        self.name = name
        self.n = max(1, int(n_power_iterations))
        self.eps = float(eps)
        self.dim = dim
        orig = layer._parameters[name + "_orig"]
        rows = self._as_matrix(orig).shape[0]
        self.u = torch.from_numpy(np.random.RandomState(0).randn(rows)).to(orig.device,
                                                                             orig.dtype)

    def _as_matrix(self, w):
        if self.dim != 0:
            w = w.movedim(self.dim, 0)
        return w.reshape(w.shape[0], -1)

    def __call__(self, layer, inputs):
        orig = layer._parameters[self.name + "_orig"]
        with torch.no_grad():
            mat = self._as_matrix(orig.detach())
            u = self.u.to(mat.device, mat.dtype)
            for _ in range(self.n):
                v = mat.t() @ u
                v = v / torch.clamp(torch.linalg.vector_norm(v), min=self.eps)
                u = mat @ v
                u = u / torch.clamp(torch.linalg.vector_norm(u), min=self.eps)
            self.u = u
            # sigma = u^T W v = sum(W * (u (x) v)), u and v held constant
            outer = torch.outer(u, v)
            if self.dim != 0:
                outer = outer.reshape(orig.movedim(self.dim, 0).shape).movedim(0, self.dim)
            else:
                outer = outer.reshape(orig.shape)
        sigma = (orig * outer.to(orig.dtype)).sum()
        setattr(layer, self.name, orig * sigma ** -1.0)
        return inputs


def spectral_norm(layer, name="weight", n_power_iterations=1, eps=1e-12, dim=0):
    """Divide the weight by its largest singular value (power iteration)
    before every forward (module docstring)."""
    w = getattr(layer, name)
    layer.add_parameter(name + "_orig", Parameter(w.detach().clone()))
    del layer._parameters[name]
    _derive(layer, name)
    hook = _SpectralNormHook(layer, name, n_power_iterations, eps, dim)
    layer.register_forward_pre_hook(hook)
    hook(layer, ())  # the normalized weight before the first call
    return layer


def parameters_to_vector(parameters, name=None):
    """The parameters' values, flattened and concatenated (detached)."""
    vals = [p.detach().reshape(-1) for p in parameters]
    return torch.cat(vals) if vals else torch.zeros(0)


def vector_to_parameters(vec, parameters, name=None):
    """Write consecutive slices of ``vec`` into the parameters, in place."""
    v = torch.as_tensor(vec)
    parameters = list(parameters)
    sizes = [p.numel() for p in parameters]
    if sum(sizes) != v.shape[0]:
        raise ValueError(f"vector length {v.shape[0]} != total parameter size {sum(sizes)}")
    off = 0
    with torch.no_grad():
        for p, n in zip(parameters, sizes):
            p.copy_(v[off:off + n].reshape(p.shape).to(p.device, p.dtype))
            off += n
