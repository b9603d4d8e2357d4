"""Weight initializers and ``ParamAttr``: the port of
``paddle_tpu/nn/initializer/__init__.py``.

Each initializer is a callable ``(shape, dtype=None, device=None)`` -> a
``torch.Tensor`` on ``device`` (the card unless the caller asks for the CPU,
``resolve_device``), applied when ``Layer.create_parameter`` builds a
parameter. The fans follow paddle's convention (``_fan_in_out``): a 2-D
weight is ``[in, out]``, so fan_in is ``shape[0]`` and fan_out ``shape[1]``,
each times the receptive field of a conv weight.

The random ones draw from the device's default generator
(``framework/random.py`` ``generator``), which ``paddle_tpu_torch.seed``
sets: a seed fixes every draw. The JAX package seeds a numpy Philox from its
PRNG key; the port's streams are torch's, so the same seed gives other
values with the same distribution (the tests compare statistics).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ...framework import dtype as dtype_mod
from ...framework import random as rng

__all__ = ["Initializer", "Constant", "Normal", "TruncatedNormal", "Uniform",
           "XavierNormal", "XavierUniform", "KaimingNormal", "KaimingUniform", "Assign",
           "Orthogonal", "Dirac", "Bilinear", "calculate_gain", "set_global_initializer",
           "ParamAttr", "constant", "normal", "uniform"]


def calculate_gain(nonlinearity, param=None):
    recommended = {
        "sigmoid": 1.0,
        "linear": 1.0,
        "conv1d": 1.0,
        "conv2d": 1.0,
        "conv3d": 1.0,
        "tanh": 5.0 / 3,
        "relu": math.sqrt(2.0),
        "leaky_relu": math.sqrt(2.0 / (1 + (param if param is not None else 0.01) ** 2)),
        "selu": 3.0 / 4,
    }
    if nonlinearity not in recommended:
        raise ValueError(f"unsupported nonlinearity {nonlinearity}")
    return recommended[nonlinearity]


def _fan_in_out(shape):
    shape = tuple(shape)
    if len(shape) < 2:
        return (shape[0] if shape else 1), (shape[0] if shape else 1)
    receptive = int(np.prod(shape[2:])) if len(shape) > 2 else 1
    # paddle convention: fan_in from shape[0], fan_out from shape[1] for 2-D weights
    return shape[0] * receptive, shape[1] * receptive


def _target(dtype, device):
    from ... import resolve_device

    return (dtype_mod.convert_dtype(dtype) or dtype_mod.get_default_dtype(),
            resolve_device(device))


def _normal(shape, dev, mean=0.0, std=1.0):
    """float32 draws of N(mean, std^2) from the device's generator."""
    x = torch.randn(tuple(shape), generator=rng.generator(dev), device=dev,
                    dtype=torch.float32)
    return x * std + mean


def _uniform(shape, dev, low, high):
    x = torch.rand(tuple(shape), generator=rng.generator(dev), device=dev,
                   dtype=torch.float32)
    return x * (high - low) + low


def _truncnorm(shape, dev, a, b, mean=0.0, std=1.0):
    """Standard normals redrawn where they fall outside [a, b] (at most 8
    rounds, as the JAX sampler), the rest through the inverse CDF."""
    g = rng.generator(dev)
    x = torch.randn(tuple(shape), generator=g, device=dev, dtype=torch.float32)
    for _ in range(8):
        bad = (x < a) | (x > b)
        if not bool(bad.any()):
            break
        x = torch.where(bad, torch.randn(x.shape, generator=g, device=dev,
                                         dtype=torch.float32), x)
    bad = (x < a) | (x > b)
    if bool(bad.any()):
        lo, hi = (torch.special.ndtr(torch.tensor(float(v), dtype=torch.float64))
                  for v in (a, b))
        u = torch.rand(x.shape, generator=g, device=dev, dtype=torch.float64)
        inv = torch.special.ndtri(lo.to(dev) + u * (hi - lo).to(dev)).to(torch.float32)
        x = torch.where(bad, inv, x)
    return x * std + mean


class Initializer:
    def __call__(self, shape, dtype=None, device=None):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, shape, dtype=None, device=None):
        d, dev = _target(dtype, device)
        return torch.full(tuple(shape), self.value, dtype=d, device=dev)


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype=None, device=None):
        d, dev = _target(dtype, device)
        return _normal(shape, dev, self.mean, self.std).to(d)


class TruncatedNormal(Initializer):
    def __init__(self, mean=0.0, std=1.0, a=-2.0, b=2.0):
        self.mean, self.std, self.a, self.b = mean, std, a, b

    def __call__(self, shape, dtype=None, device=None):
        d, dev = _target(dtype, device)
        return _truncnorm(shape, dev, self.a, self.b, self.mean, self.std).to(d)


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def __call__(self, shape, dtype=None, device=None):
        d, dev = _target(dtype, device)
        return _uniform(shape, dev, self.low, self.high).to(d)


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype=None, device=None):
        d, dev = _target(dtype, device)
        fi, fo = _fan_in_out(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        return _normal(shape, dev, 0.0, self.gain * math.sqrt(2.0 / (fi + fo))).to(d)


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype=None, device=None):
        d, dev = _target(dtype, device)
        fi, fo = _fan_in_out(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        limit = self.gain * math.sqrt(6.0 / (fi + fo))
        return _uniform(shape, dev, -limit, limit).to(d)


class KaimingNormal(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in, self.negative_slope, self.nonlinearity = fan_in, negative_slope, nonlinearity

    def __call__(self, shape, dtype=None, device=None):
        d, dev = _target(dtype, device)
        fi, _ = _fan_in_out(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        gain = calculate_gain(self.nonlinearity, self.negative_slope)
        return _normal(shape, dev, 0.0, gain / math.sqrt(fi)).to(d)


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in, self.negative_slope, self.nonlinearity = fan_in, negative_slope, nonlinearity

    def __call__(self, shape, dtype=None, device=None):
        d, dev = _target(dtype, device)
        fi, _ = _fan_in_out(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        gain = calculate_gain(self.nonlinearity, self.negative_slope)
        limit = gain * math.sqrt(3.0 / fi)
        return _uniform(shape, dev, -limit, limit).to(d)


class Assign(Initializer):
    """The given value (an array, a list or a tensor) of exactly ``shape``."""

    def __init__(self, value):
        self.value = value

    def __call__(self, shape, dtype=None, device=None):
        from ... import resolve_device

        v = self.value
        arr = v.detach() if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
        d = dtype_mod.convert_dtype(dtype)
        arr = arr.to(device=resolve_device(device), dtype=d if d is not None else arr.dtype)
        if tuple(arr.shape) != tuple(shape):
            raise ValueError(f"Assign shape {tuple(arr.shape)} != {tuple(shape)}")
        return arr.clone()


class Orthogonal(Initializer):
    """``gain`` times a (semi-)orthogonal matrix over the last axis (rows:
    the product of the other axes), from the QR of a normal draw with the
    signs of R's diagonal folded in: JAX's ``orthogonal`` initializer."""

    def __init__(self, gain=1.0):
        self.gain = gain

    def __call__(self, shape, dtype=None, device=None):
        d, dev = _target(dtype, device)
        shape = tuple(int(s) for s in shape)
        if len(shape) < 2:
            raise ValueError("Orthogonal needs a shape of two or more axes")
        n_cols = shape[-1]
        n_rows = int(np.prod(shape)) // n_cols
        flip = n_rows < n_cols
        a = _normal((n_cols, n_rows) if flip else (n_rows, n_cols), dev)
        q, r = torch.linalg.qr(a)
        q = q * torch.sign(torch.diagonal(r))
        if flip:
            q = q.T
        return (self.gain * q.reshape(shape)).to(d)


class Dirac(Initializer):
    def __init__(self, groups=1):
        self.groups = groups

    def __call__(self, shape, dtype=None, device=None):
        d, dev = _target(dtype, device)
        arr = np.zeros(tuple(shape), np.float32)
        out_c, in_c = shape[0], shape[1]
        per = out_c // self.groups
        for g in range(self.groups):
            for i in range(min(per, in_c)):
                center = tuple(s // 2 for s in shape[2:])
                arr[(g * per + i, i) + center] = 1.0
        return torch.from_numpy(arr).to(device=dev, dtype=d)


class Bilinear(Initializer):
    """Bilinear-interpolation kernel for transposed-conv upsampling: a conv
    weight (C_out, C_in, k...) gets the bilinear kernel on its spatial axes."""

    def __call__(self, shape, dtype=None, device=None):
        d, dev = _target(dtype, device)
        shape = tuple(int(s) for s in shape)
        if len(shape) < 3:
            raise ValueError(
                f"Bilinear initializer needs a conv weight (>=3D), got {shape}")
        w = np.zeros(shape, dtype="float64")
        grids = []
        for k in shape[2:]:
            f = (k + 1) // 2
            c = (2 * f - 1 - f % 2) / (2.0 * f)
            grids.append(1 - np.abs(np.arange(k) / f - c))
        kernel = grids[0]
        for g in grids[1:]:
            kernel = np.multiply.outer(kernel, g)
        w[...] = kernel  # every (c_out, c_in) gets the spatial kernel
        return torch.from_numpy(w).to(device=dev, dtype=d)


# paddle-style lowercase aliases
constant = Constant
normal = Normal
uniform = Uniform


class ParamAttr:
    """Parameter attribute bundle (reference: python/paddle/base/param_attr.py):
    the name, the initializer, the learning-rate multiplier
    (``optimize_attr["learning_rate"]``, read by the optimizers), the
    regularizer, ``trainable`` (False: ``requires_grad`` False) and
    ``need_clip`` (False: the clippers pass the gradient through)."""

    def __init__(self, name=None, initializer=None, learning_rate=1.0, regularizer=None,
                 trainable=True, do_model_average=True, need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(attr):
        if attr is None:
            return ParamAttr()
        if isinstance(attr, ParamAttr):
            return attr
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        if isinstance(attr, Initializer):
            return ParamAttr(initializer=attr)
        if attr is False:
            return False
        return ParamAttr()


#: [weight initializer, bias initializer] that ``create_parameter`` takes
#: where neither the attribute nor the layer names one
_GLOBAL_INIT = [None, None]


def set_global_initializer(weight_init, bias_init=None):
    _GLOBAL_INIT[0] = weight_init
    _GLOBAL_INIT[1] = bias_init
