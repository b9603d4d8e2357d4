"""Normalisation functionals: the port of paddle_tpu/nn/functional/norm.py
(``layer_norm``, ``rms_norm``, ``batch_norm``, ``instance_norm``,
``group_norm``, ``local_response_norm``), each an op under the JAX op's
name and AMP category (black-listed but ``lrn_op``), with the JAX
arithmetic:

  * ``batch_norm`` in training normalises by the batch statistics over
    every axis but the channel axis of ``data_format``, the variance the
    biased ``E[x^2] - mean^2``, and updates the running buffers in place by
    paddle's rule, ``momentum`` weighting the old value: ``running =
    momentum * running + (1 - momentum) * batch``, the variance's batch
    value the unbiased one (``n / (n - 1)``). torch's ``F.batch_norm``
    takes momentum the other way round and is not used. Without training
    (or with ``use_global_stats``) it normalises by the running buffers;
  * ``instance_norm`` and ``group_norm`` take the biased variance per
    sample (and group), channels first (``NC...``) or last;
  * ``rms_norm`` normalises in float32 (float64 stays float64), casts back
    to x's dtype, and only then scales and shifts: the JAX order, which
    decides the bf16 rounding.
"""
from __future__ import annotations

import torch

from ...ops._apply import defop

__all__ = ["layer_norm", "rms_norm", "batch_norm", "instance_norm", "group_norm",
           "local_response_norm"]


@defop("layer_norm", amp_category="black")
def _layer_norm(x, weight=None, bias=None, epsilon=1e-5, begin_norm_axis=None):
    axes = tuple(range(begin_norm_axis, x.dim()))
    mean = x.mean(dim=axes, keepdim=True)
    var = (x - mean).square().mean(dim=axes, keepdim=True)
    out = (x - mean) * torch.rsqrt(var + epsilon)
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5, name=None):
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    begin = x.dim() - len(normalized_shape)
    return _layer_norm(x, weight, bias, epsilon=float(epsilon), begin_norm_axis=begin)


@defop("rms_norm", amp_category="black")
def _rms_norm(x, weight=None, bias=None, epsilon=1e-6, begin_norm_axis=-1):
    begin = begin_norm_axis % x.dim()
    dims = tuple(range(begin, x.dim()))
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    ms = xf.square().mean(dim=dims, keepdim=True)
    out = (xf * torch.rsqrt(ms + epsilon)).to(x.dtype)
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out


def rms_norm(x, weight=None, bias=None, epsilon=1e-6, begin_norm_axis=-1, name=None):
    """Reference: python/paddle/incubate/nn/functional/fused_rms_norm.py."""
    return _rms_norm(x, weight, bias, epsilon=float(epsilon),
                     begin_norm_axis=begin_norm_axis % x.dim())


def _channel_shape(x, axis):
    shape = [1] * x.dim()
    shape[axis] = x.shape[axis]
    return shape


@defop("batch_norm_infer", amp_category="black")
def _bn_infer(x, rm, rv, weight=None, bias=None, epsilon=1e-5, axis=1):
    shape = _channel_shape(x, axis)
    out = (x - rm.reshape(shape)) * torch.rsqrt(rv.reshape(shape) + epsilon)
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out


@defop("batch_norm_train", amp_category="black")
def _bn_train(x, weight=None, bias=None, epsilon=1e-5, axis=1):
    red = tuple(i for i in range(x.dim()) if i != axis)
    mean = x.mean(dim=red)
    var = x.square().mean(dim=red) - mean.square()
    shape = _channel_shape(x, axis)
    out = (x - mean.reshape(shape)) * torch.rsqrt(var.reshape(shape) + epsilon)
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out, mean, var


def batch_norm(x, running_mean, running_var, weight=None, bias=None, training=False,
               momentum=0.9, epsilon=1e-5, data_format="NCHW", use_global_stats=None,
               name=None):
    axis = 1 if data_format.startswith("NC") else x.dim() - 1
    if use_global_stats is None:
        use_global_stats = not training
    if use_global_stats:
        return _bn_infer(x, running_mean, running_var, weight, bias,
                         epsilon=float(epsilon), axis=axis)
    out, mean, var = _bn_train(x, weight, bias, epsilon=float(epsilon), axis=axis)
    if running_mean is not None:
        n = x.numel() // x.shape[axis]
        with torch.no_grad():
            unbiased = var * n / max(n - 1, 1)
            running_mean.copy_(momentum * running_mean + (1 - momentum) * mean)
            running_var.copy_(momentum * running_var + (1 - momentum) * unbiased)
    return out


@defop("instance_norm_op", amp_category="black")
def _in(x, weight=None, bias=None, eps=1e-5, axis=1):
    red = tuple(range(2, x.dim())) if axis == 1 else tuple(range(1, x.dim() - 1))
    mean = x.mean(dim=red, keepdim=True)
    var = x.var(dim=red, unbiased=False, keepdim=True)
    out = (x - mean) * torch.rsqrt(var + eps)
    if weight is not None:
        out = out * weight.reshape(_channel_shape(x, axis))
    if bias is not None:
        out = out + bias.reshape(_channel_shape(x, axis))
    return out


def instance_norm(x, running_mean=None, running_var=None, weight=None, bias=None,
                  use_input_stats=True, momentum=0.9, eps=1e-5, data_format="NCHW",
                  name=None):
    axis = 1 if data_format.startswith("NC") else x.dim() - 1
    return _in(x, weight, bias, eps=float(eps), axis=axis)


@defop("group_norm_op", amp_category="black")
def _group_norm(x, weight=None, bias=None, epsilon=1e-5, groups=1, axis=1):
    if axis == 1:
        n, c = x.shape[0], x.shape[1]
        spatial = tuple(x.shape[2:])
        g = x.reshape((n, groups, c // groups) + spatial)
        red = tuple(range(2, g.dim()))
        shape = [1, c] + [1] * len(spatial)
    else:
        n, c = x.shape[0], x.shape[-1]
        spatial = tuple(x.shape[1:-1])
        g = x.reshape((n,) + spatial + (groups, c // groups))
        red = tuple(range(1, g.dim() - 2)) + (g.dim() - 1,)
        shape = [1] * (x.dim() - 1) + [c]
    mean = g.mean(dim=red, keepdim=True)
    var = g.var(dim=red, unbiased=False, keepdim=True)
    out = ((g - mean) * torch.rsqrt(var + epsilon)).reshape(x.shape)
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out


def group_norm(x, num_groups, epsilon=1e-5, weight=None, bias=None, data_format="NCHW",
               name=None):
    axis = 1 if data_format.startswith("NC") else x.dim() - 1
    return _group_norm(x, weight, bias, epsilon=float(epsilon), groups=int(num_groups),
                       axis=axis)


@defop("lrn_op")
def _lrn(x, size, alpha, beta, k, axis):
    """x / (k + alpha * (sum of x^2 over the ``size`` channels centred on
    each) / size) ** beta, the window cut at the edges."""
    sq = x.square()
    half = size // 2
    cdim = x.shape[axis]
    acc = torch.zeros_like(x)
    for off in range(-half, half + 1):
        lo, hi = max(0, -off), min(cdim, cdim - off)
        if hi <= lo:
            continue
        acc = acc + torch.nn.functional.pad(
            sq.narrow(axis, lo + off, hi - lo),
            _pad_spec(x.dim(), axis, lo, cdim - hi))
    return x / torch.pow(k + alpha * acc / size, beta)


def _pad_spec(ndim, axis, before, after):
    """``F.pad``'s argument that pads ``axis`` by (before, after)."""
    spec = [0, 0] * (ndim - axis)
    spec[-2], spec[-1] = before, after
    return spec


def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0, data_format="NCHW",
                        name=None):
    axis = 1 if data_format.startswith("NC") else x.dim() - 1
    return _lrn(x, size=int(size), alpha=float(alpha), beta=float(beta), k=float(k),
                axis=axis)
