"""``Layer``, the module base class: the port of paddle_tpu/nn/layer/layers.py.

``Layer`` is a ``torch.nn.Module`` that adds paddle's methods: a user's
``Layer`` is a torch module to every other reader (optimizers, autograd,
``torch.func``, Dynamo under ``jit.to_static``, ``torch.export`` under
``jit.save`` and ``inference``, CUDA graphs), and ``Module.__call__`` is
left alone, so the hooks are torch's own. What it adds:

  * ``create_parameter`` (through ``ParamAttr``, the global initializer and
    the defaults ``XavierUniform`` for a weight and ``Constant(0)`` for a
    bias; the parameter is a named ``framework.Parameter`` carrying the
    attribute's learning-rate multiplier, regularizer and ``need_clip``, and
    ``requires_grad`` is ``trainable``), ``add_parameter``, ``add_sublayer``
    and ``register_buffer(persistable=)``; parameters are built on
    ``self._device`` (None: the card unless ``set_device("cpu")``);
  * paddle's traversals (``named_parameters``/``parameters(include_sublayers)``,
    ``named_sublayers``/``sublayers(include_self)``, ``children``,
    ``buffers``), each also taking torch's keywords, so torch's own callers
    get torch's answers; ``apply`` visits the layer before its sublayers,
    as the JAX ``Layer`` does (torch's visits them first);
  * ``register_forward_pre_hook``/``register_forward_post_hook`` over
    torch's hooks, removed through ``HookRemoveHelper``;
  * ``state_dict``/``set_state_dict`` with the JAX keys and order (every
    parameter once, then the persistable buffers); called with torch's
    keywords (``prefix``, ``keep_vars``; a torch module's own recursion into
    its children) ``state_dict`` is torch's;
  * ``functional_state``/``load_functional_state``: the parameters as
    ``(names, values)``, the pair ``torch.func.functional_call(layer,
    dict(zip(names, values)), args)`` runs a pure step on;
  * ``to`` with paddle's device and dtype names, ``astype``, ``full_name``,
    ``clear_gradients``, ``create_tensor``.
"""
from __future__ import annotations

import collections

import numpy as np
import torch
from torch import nn

from ...framework import Parameter
from ...framework import dtype as dtype_mod
from ..initializer import _GLOBAL_INIT, Constant, ParamAttr, XavierUniform

__all__ = ["Layer", "HookRemoveHelper"]


class HookRemoveHelper:
    """The handle a hook registration returns: ``remove()`` takes the hook
    out."""

    def __init__(self, handle):
        self._handle = handle

    def remove(self):
        self._handle.remove()


def _device_arg(d):
    """paddle's device names ("gpu", "gpu:1") as torch's."""
    if isinstance(d, str):
        name, _, num = d.lower().partition(":")
        if name == "gpu":
            return torch.device("cuda", int(num) if num else 0)
    return d


def _to_tensor(v, like):
    """``v`` (a tensor, a numpy array, bfloat16 ones included, or a list) as
    a tensor of ``like``'s dtype on its device."""
    if not isinstance(v, torch.Tensor):
        arr = np.asarray(v)
        if arr.dtype.name == "bfloat16":
            v = torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
        else:
            v = torch.from_numpy(np.ascontiguousarray(arr))
    return v.detach().to(device=like.device, dtype=like.dtype)


class Layer(nn.Module):
    def __init__(self, name_scope=None, dtype="float32"):
        super().__init__()
        self._dtype = dtype
        self._name_scope = name_scope or self.__class__.__name__.lower()
        self._device = None

    # -- construction helpers ------------------------------------------------
    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None):
        attr = ParamAttr._to_attr(attr)
        if attr is False:
            return None
        dtype = dtype or self._dtype or "float32"
        init = attr.initializer or default_initializer
        if init is None:
            init = _GLOBAL_INIT[1 if is_bias else 0]
        if init is None:
            init = Constant(0.0) if is_bias else XavierUniform()
        with torch.no_grad():
            value = init(list(shape), dtype, device=self._device)
        p = Parameter(value, requires_grad=bool(attr.trainable), name=attr.name)
        p.optimize_attr["learning_rate"] = attr.learning_rate
        p.regularizer = attr.regularizer
        p.need_clip = attr.need_clip
        return p

    def create_tensor(self, name=None, persistable=None, dtype=None):
        from ... import resolve_device

        return torch.zeros((), dtype=dtype_mod.convert_dtype(dtype or "float32"),
                           device=resolve_device(self._device))

    def add_parameter(self, name, parameter):
        self.register_parameter(str(name), parameter)
        return parameter

    def add_sublayer(self, name, sublayer):
        self.add_module(str(name), sublayer)
        return sublayer

    def register_buffer(self, name, tensor, persistable=True, persistent=None):
        super().register_buffer(name, tensor,
                                persistent=persistable if persistent is None else persistent)
        return tensor

    # -- traversal -----------------------------------------------------------
    def named_parameters(self, prefix="", include_sublayers=True, recurse=None,
                         remove_duplicate=True):
        return super().named_parameters(
            prefix=prefix, recurse=include_sublayers if recurse is None else recurse,
            remove_duplicate=remove_duplicate)

    def parameters(self, include_sublayers=True, recurse=None):
        return [p for _, p in self.named_parameters(include_sublayers=include_sublayers,
                                                    recurse=recurse)]

    def named_sublayers(self, prefix="", include_self=False):
        """Every sublayer, depth first, the layer itself first when
        ``include_self`` (a layer reached twice is yielded twice, as in the
        JAX package)."""
        first = True
        for name, layer in self.named_modules(prefix=prefix, remove_duplicate=False):
            if first:
                first = False
                if not include_self:
                    continue
            yield name, layer

    def sublayers(self, include_self=False):
        return [layer for _, layer in self.named_sublayers(include_self=include_self)]

    def children(self):
        return list(super().children())

    def named_children(self):
        return list(super().named_children())

    def named_buffers(self, prefix="", include_sublayers=True, recurse=None,
                      remove_duplicate=True):
        return super().named_buffers(
            prefix=prefix, recurse=include_sublayers if recurse is None else recurse,
            remove_duplicate=remove_duplicate)

    def buffers(self, include_sublayers=True, recurse=None):
        return [b for _, b in self.named_buffers(include_sublayers=include_sublayers,
                                                 recurse=recurse)]

    def apply(self, fn):
        for layer in self.sublayers(include_self=True):
            fn(layer)
        return self

    # -- state dict ----------------------------------------------------------
    def state_dict(self, destination=None, include_sublayers=True, use_hook=True,
                   structured_name_prefix="", *, prefix=None, keep_vars=None):
        if prefix is not None or keep_vars is not None:
            return super().state_dict(destination=destination,
                                      prefix="" if prefix is None else prefix,
                                      keep_vars=bool(keep_vars))
        dest = destination if destination is not None else collections.OrderedDict()
        for name, p in self.named_parameters(prefix=structured_name_prefix,
                                             include_sublayers=include_sublayers):
            dest[name] = p.detach()
        for name, layer in self.named_sublayers(prefix=structured_name_prefix,
                                                include_self=True):
            for bname, b in layer._buffers.items():
                if b is None or bname in layer._non_persistent_buffers_set:
                    continue
                dest[f"{name}.{bname}" if name else bname] = b.detach()
            if not include_sublayers:
                break
        return dest

    def set_state_dict(self, state_dict, use_structured_name=True):
        """Copy each value into the tensor of its key, cast to its dtype;
        returns ``(missing, unexpected)``. A shape that differs raises."""
        own = self.state_dict()
        missing, unexpected = [], []
        with torch.no_grad():
            for k, v in state_dict.items():
                if k not in own:
                    unexpected.append(k)
                    continue
                tgt = own[k]
                val = _to_tensor(v, tgt)
                if tuple(val.shape) != tuple(tgt.shape):
                    raise ValueError(f"shape mismatch for {k}: {tuple(val.shape)} vs "
                                     f"{tuple(tgt.shape)}")
                tgt.copy_(val)
        for k in own:
            if k not in state_dict:
                missing.append(k)
        return missing, unexpected

    set_dict = set_state_dict
    load_dict = set_state_dict

    # -- functional bridge ---------------------------------------------------
    def functional_state(self):
        """``(names, values)`` of the parameters (module docstring)."""
        names, values = [], []
        for n, p in self.named_parameters():
            names.append(n)
            values.append(p.detach())
        return names, values

    def load_functional_state(self, names, values):
        lookup = dict(zip(names, values))
        with torch.no_grad():
            for n, p in self.named_parameters():
                if n in lookup:
                    p.copy_(_to_tensor(lookup[n], p))

    # -- dtype/device moves --------------------------------------------------
    def to(self, *args, **kwargs):
        """torch's ``to``, also taking paddle's ``(device, dtype, blocking)``
        and its names ("gpu", "gpu:0", "cpu", "float16", ...)."""
        kwargs.pop("blocking", None)
        out = []
        for a in args:
            if isinstance(a, str) and a.lower() in dtype_mod._STR2DTYPE:
                a = dtype_mod.convert_dtype(a)
            out.append(_device_arg(a))
        if "device" in kwargs:
            kwargs["device"] = _device_arg(kwargs["device"])
        if isinstance(kwargs.get("dtype"), str):
            kwargs["dtype"] = dtype_mod.convert_dtype(kwargs["dtype"])
        if kwargs.get("device", 0) is None:
            kwargs.pop("device")
        if kwargs.get("dtype", 0) is None:
            kwargs.pop("dtype")
        out = [a for a in out if a is not None]
        return super().to(*out, **kwargs)

    def astype(self, dtype):
        return self.to(dtype=dtype_mod.convert_dtype(dtype))

    # -- hooks ---------------------------------------------------------------
    def register_forward_pre_hook(self, hook, **kwargs):
        return HookRemoveHelper(super().register_forward_pre_hook(hook, **kwargs))

    def register_forward_post_hook(self, hook):
        return HookRemoveHelper(super().register_forward_hook(hook))

    # -- misc ----------------------------------------------------------------
    def full_name(self):
        return self._name_scope

    def clear_gradients(self):
        for p in self.parameters():
            p.grad = None
