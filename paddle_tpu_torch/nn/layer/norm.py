"""Norm layers: the port of paddle_tpu/nn/layer/norm.py (``LayerNorm``,
``RMSNorm``, ``BatchNorm``/``1D``/``2D``/``3D`` with the running buffers
``_mean`` and ``_variance``, ``SyncBatchNorm``, ``GroupNorm``,
``InstanceNorm1D``/``2D``/``3D``, ``LocalResponseNorm``, ``SpectralNorm``),
each a ``Layer`` over the functionals of ``nn/functional/norm.py``.

``SyncBatchNorm`` normalises over the batch it is given: the cross-process
reduction of its statistics comes with the distributed slice (ROADMAP Queue
A item 10), and a single process computes what it would. ``SpectralNorm``'s
power-iteration vectors ``weight_u`` and ``weight_v`` are parameters without
gradient, updated in place by each forward, as the JAX layer updates them.
``RMSNorm`` (and, for the LLaMA, every layer here) also takes ``device=``
and ``dtype=``.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import functional as F
from ..initializer import Constant, Normal
from .layers import Layer

__all__ = ["LayerNorm", "RMSNorm", "BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D",
           "SyncBatchNorm", "GroupNorm", "InstanceNorm1D", "InstanceNorm2D",
           "InstanceNorm3D", "LocalResponseNorm", "SpectralNorm"]


class _Placed(Layer):
    def __init__(self, device=None, dtype=None):
        super().__init__()
        self._device = device
        if dtype is not None:
            self._dtype = dtype


class LayerNorm(_Placed):
    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None, bias_attr=None,
                 name=None, *, device=None, dtype=None):
        super().__init__(device, dtype)
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        self.weight = self.create_parameter(self._normalized_shape, attr=weight_attr,
                                            default_initializer=Constant(1.0))
        self.bias = self.create_parameter(self._normalized_shape, attr=bias_attr, is_bias=True)

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight, self.bias, self._epsilon)

    def extra_repr(self):
        return f"normalized_shape={self._normalized_shape}, epsilon={self._epsilon}"


class RMSNorm(_Placed):
    """Paddle's RMSNorm: weight from ``Constant(1.0)`` (or ``weight_attr``),
    no bias."""

    def __init__(self, normalized_shape, epsilon=1e-6, weight_attr=None, name=None, *,
                 device=None, dtype=None):
        super().__init__(device, dtype)
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        self.weight = self.create_parameter(self._normalized_shape, attr=weight_attr,
                                            default_initializer=Constant(1.0))

    def forward(self, x):
        return F.rms_norm(x, self.weight, None, self._epsilon,
                          begin_norm_axis=x.dim() - len(self._normalized_shape))

    def extra_repr(self):
        return f"normalized_shape={self._normalized_shape}, epsilon={self._epsilon}"


class _BatchNormBase(_Placed):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, data_format="NCHW", use_global_stats=None, name=None, *,
                 device=None, dtype=None):
        super().__init__(device, dtype)
        from ... import resolve_device

        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        self.weight = self.create_parameter([num_features], attr=weight_attr,
                                            default_initializer=Constant(1.0))
        self.bias = self.create_parameter([num_features], attr=bias_attr, is_bias=True)
        dev = resolve_device(device)
        self.register_buffer("_mean", torch.zeros(num_features, device=dev))
        self.register_buffer("_variance", torch.ones(num_features, device=dev))

    def forward(self, x):
        return F.batch_norm(x, self._mean, self._variance, self.weight, self.bias,
                            training=self.training, momentum=self._momentum,
                            epsilon=self._epsilon, data_format=self._data_format,
                            use_global_stats=self._use_global_stats)

    def extra_repr(self):
        return f"num_features={self._num_features}, momentum={self._momentum}"


class BatchNorm(_BatchNormBase):
    pass


class BatchNorm1D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, data_format="NCL", use_global_stats=None, name=None, **kw):
        super().__init__(num_features, momentum, epsilon, weight_attr, bias_attr,
                         "NCL" if data_format in ("NCL", "NC") else data_format,
                         use_global_stats, name, **kw)


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, data_format="NCDHW", use_global_stats=None, name=None, **kw):
        super().__init__(num_features, momentum, epsilon, weight_attr, bias_attr,
                         data_format, use_global_stats, name, **kw)


class SyncBatchNorm(_BatchNormBase):
    """Batch norm whose statistics would span every process (module
    docstring: one process here)."""

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        out = layer
        if isinstance(layer, _BatchNormBase) and not isinstance(layer, SyncBatchNorm):
            out = SyncBatchNorm(layer._num_features, layer._momentum, layer._epsilon,
                                data_format=layer._data_format,
                                device=layer._mean.device)
            out.weight = layer.weight
            out.bias = layer.bias
            out._mean, out._variance = layer._mean, layer._variance
        for name, sub in list(layer._modules.items()):
            layer._modules[name] = cls.convert_sync_batchnorm(sub)
        return out


class GroupNorm(_Placed):
    def __init__(self, num_groups, num_channels, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, data_format="NCHW", name=None, *, device=None, dtype=None):
        super().__init__(device, dtype)
        self._num_groups = num_groups
        self._epsilon = epsilon
        self._data_format = data_format
        self.weight = self.create_parameter([num_channels], attr=weight_attr,
                                            default_initializer=Constant(1.0))
        self.bias = self.create_parameter([num_channels], attr=bias_attr, is_bias=True)

    def forward(self, x):
        return F.group_norm(x, self._num_groups, self._epsilon, self.weight, self.bias,
                            self._data_format)


class InstanceNorm1D(_Placed):
    def __init__(self, num_features, epsilon=1e-5, momentum=0.9, weight_attr=None,
                 bias_attr=None, data_format="NCL", name=None, *, device=None, dtype=None):
        super().__init__(device, dtype)
        self._epsilon = epsilon
        self._data_format = data_format
        self.scale = self.create_parameter([num_features], attr=weight_attr,
                                           default_initializer=Constant(1.0))
        self.bias = self.create_parameter([num_features], attr=bias_attr, is_bias=True)

    def forward(self, x):
        return F.instance_norm(x, weight=self.scale, bias=self.bias, eps=self._epsilon,
                               data_format=self._data_format)


class InstanceNorm2D(InstanceNorm1D):
    def __init__(self, num_features, epsilon=1e-5, momentum=0.9, weight_attr=None,
                 bias_attr=None, data_format="NCHW", name=None, **kw):
        super().__init__(num_features, epsilon, momentum, weight_attr, bias_attr,
                         data_format, name, **kw)


class InstanceNorm3D(InstanceNorm1D):
    def __init__(self, num_features, epsilon=1e-5, momentum=0.9, weight_attr=None,
                 bias_attr=None, data_format="NCDHW", name=None, **kw):
        super().__init__(num_features, epsilon, momentum, weight_attr, bias_attr,
                         data_format, name, **kw)


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0, data_format="NCHW", name=None):
        super().__init__()
        self.args = (size, alpha, beta, k, data_format)

    def forward(self, x):
        return F.local_response_norm(x, *self.args)


def _l2_normalize(x, epsilon):
    return x / torch.clamp(torch.sqrt(torch.sum(x * x, dim=0, keepdim=True)), min=epsilon)


class SpectralNorm(_Placed):
    """``weight / sigma``, sigma the largest singular value of ``weight``
    (its ``dim`` axis first, the rest flattened) estimated by
    ``power_iters`` rounds of power iteration from ``weight_u`` and
    ``weight_v``."""

    def __init__(self, weight_shape, dim=0, power_iters=1, epsilon=1e-12, name=None, *,
                 device=None, dtype=None):
        super().__init__(device, dtype)
        self._dim = dim
        self._power_iters = power_iters
        self._epsilon = epsilon
        h = weight_shape[dim]
        w = int(np.prod(weight_shape)) // h
        self.weight_u = self.create_parameter([h], default_initializer=Normal(0, 1))
        self.weight_v = self.create_parameter([w], default_initializer=Normal(0, 1))
        self.weight_u.requires_grad_(False)
        self.weight_v.requires_grad_(False)

    def forward(self, weight):
        dim = self._dim
        mat = weight
        if dim != 0:
            mat = weight.permute([dim] + [i for i in range(weight.dim()) if i != dim])
        mat = mat.reshape(mat.shape[0], -1)
        u, v = self.weight_u, self.weight_v
        with torch.no_grad():
            for _ in range(self._power_iters):
                v.copy_(_l2_normalize(mat.T @ u, self._epsilon))
                u.copy_(_l2_normalize(mat @ v, self._epsilon))
        sigma = torch.sum(u * (mat @ v))
        return weight / sigma
