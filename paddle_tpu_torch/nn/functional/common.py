"""Common functionals: the port of paddle_tpu/nn/functional/common.py.

``linear`` takes paddle's weight layout, (in_features, out_features), the
layout of the port's ``nn.Linear``; the LLaMA's torch-layout linears
(``nn/layer/common.py`` ``_TorchLinear``) pass the transpose of their
(out, in) weight, a view. ``embedding`` gathers rows of ``weight``; a
``padding_idx`` zeroes the output rows (and so the gradient) of that id, as
the JAX function does.

The dropout family draws its masks from the device's default generator
(``framework/random.py``; ``paddle_tpu_torch.seed`` fixes them), not from
the JAX package's PRNG stream: the two packages' masks differ, their
distributions agree. Kept values are ``x / (1 - p)`` (``upscale_in_train``)
or ``x``; ``axis`` shares one mask over the dims it does not list.

``interpolate`` computes what the JAX package computes, which is not always
torch's function of that name:

  * ``nearest`` is half-pixel (``jax.image.resize``: source index
    ``floor((i + 0.5) * n_in / n_out)`` in float32, torch's
    ``nearest-exact``), whatever ``align_corners`` says;
  * ``linear``/``bilinear``/``trilinear`` without ``align_corners`` are
    ``jax.image.resize``'s triangle filter, one dense weight matrix a
    spatial dim (``_resize_weights``, computed in float64 on the host and
    cast to the input's dtype once per shape and device, ``_axis_tables``): half-pixel interpolation when it upsamples,
    and when it downsamples a triangle widened by the ratio with its
    weights renormalised at the edges (antialiased), in 3-, 4- and 5-D, on
    the CPU and on the card alike;
  * a non-integer ``scale_factor`` feeds ``1 / scale`` into the linear
    coordinate map (clamped to the input), ``align_corners=True`` maps the
    corners exactly, ``bicubic`` is the Keys kernel (a = -0.75, clamped
    taps, no antialias), ``area`` is adaptive average pooling.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as tF

from ...framework import dtype as dtype_mod
from ...ops._apply import defop
from ...ops.manipulation import pad  # noqa: F401  (paddle.nn.functional.pad)
from ...ops.random_ops import _gen


@defop("linear", amp_category="white")
def _linear(x, weight, bias=None):
    out = torch.matmul(x, weight)
    if bias is not None:
        out = out + bias
    return out


def linear(x, weight, bias=None, name=None):
    return _linear(x, weight, bias)


# ---- dropout -----------------------------------------------------------------
def _keep_mask(x, keep, shape):
    """True where an element is kept: a uniform draw below ``keep`` (the
    JAX ``bernoulli``), from the device's default generator."""
    u = torch.rand(tuple(shape), generator=_gen(x.device), device=x.device,
                   dtype=torch.float32)
    return u < keep


def _apply_mask(x, mask, p, mode):
    keep = 1.0 - p
    if mode == "upscale_in_train":
        return torch.where(mask, x / keep, torch.zeros_like(x))
    return torch.where(mask, x, torch.zeros_like(x))


_dropout = defop("dropout_op")(_apply_mask)
_dropout_axis = defop("dropout_axis")(_apply_mask)


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train", name=None):
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            from ...ops.math import scale as scale_op

            return scale_op(x, scale=1.0 - p)
        return x
    if p == 1.0:
        from ...ops.creation import zeros_like

        return zeros_like(x)
    if axis is not None:
        # one mask shared along the dims ``axis`` does not list
        axes = [axis] if isinstance(axis, int) else list(axis)
        shape = [s if i in axes else 1 for i, s in enumerate(x.shape)]
        return _dropout_axis(x, _keep_mask(x, 1.0 - p, shape), p=float(p), mode=mode)
    return _dropout(x, _keep_mask(x, 1.0 - p, x.shape), p=float(p), mode=mode)


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None):
    return dropout(x, p, axis=[0, 1] if data_format == "NCHW" else [0, 3], training=training)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None):
    return dropout(x, p, axis=[0, 1] if data_format == "NCDHW" else [0, 4], training=training)


#: SELU's alpha and scale; alpha dropout drops to -alpha * scale
_SELU_ALPHA = 1.6732632423543772
_SELU_SCALE = 1.0507009873554805


@defop("alpha_dropout_op")
def _ad(x, keep, a=1.0, b=0.0, alpha_p=0.0):
    return a * torch.where(keep, x, torch.full_like(x, alpha_p)) + b


def _alpha_affine(p):
    """(a, b, alpha_p) of alpha dropout at drop rate ``p``."""
    alpha_p = -_SELU_ALPHA * _SELU_SCALE
    a = ((1 - p) * (1 + p * alpha_p ** 2)) ** -0.5
    return a, -a * alpha_p * p, alpha_p


def alpha_dropout(x, p=0.5, training=True, name=None):
    if not training or p == 0.0:
        return x
    a, b, alpha_p = _alpha_affine(p)
    return _ad(x, _keep_mask(x, 1.0 - p, x.shape), a=float(a), b=float(b),
               alpha_p=float(alpha_p))


@defop("embedding_op")
def _embedding(weight, x, padding_idx=None):
    out = tF.embedding(x, weight)
    if padding_idx is not None:
        out = out * (x != padding_idx).unsqueeze(-1).to(out.dtype)
    return out


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    idx = padding_idx
    if idx is not None and idx < 0:
        idx = weight.shape[0] + idx
    return _embedding(weight, x, padding_idx=idx)


@defop("one_hot", differentiable=False)
def _one_hot(x, num_classes):
    # jax.nn.one_hot's law: an index outside [0, num_classes) gives a zero row
    classes = torch.arange(num_classes, device=x.device)
    return (x.long().unsqueeze(-1) == classes).to(torch.float32)


def one_hot(x, num_classes, name=None):
    return _one_hot(x, num_classes=int(num_classes))


@defop("cosine_similarity", amp_category="black")
def _cosine_similarity(x1, x2, axis=1, eps=1e-8):
    dot = torch.sum(x1 * x2, dim=axis)
    n1 = torch.sqrt(torch.sum(x1 * x1, dim=axis))
    n2 = torch.sqrt(torch.sum(x2 * x2, dim=axis))
    return dot / torch.clamp(n1 * n2, min=eps)


def cosine_similarity(x1, x2, axis=1, eps=1e-8):
    return _cosine_similarity(x1, x2, axis=int(axis), eps=float(eps))


@defop("normalize_op")
def _normalize(x, p=2, axis=1, epsilon=1e-12):
    if p == 2:
        n = torch.sqrt(torch.sum(x * x, dim=axis, keepdim=True))
    else:
        n = torch.sum(torch.abs(x) ** p, dim=axis, keepdim=True) ** (1.0 / p)
    return x / torch.clamp(n, min=epsilon)


def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    return _normalize(x, p=float(p), axis=int(axis), epsilon=float(epsilon))


# ---- interpolate (nearest/linear/cubic/area) on channel-last tensors ----------
def _resize_weights(n_in, n_out):
    """(n_in, n_out) weights of ``jax.image.resize``'s triangle filter
    (``compute_weight_mat``), in float64: the kernel widened by the ratio
    when downsampling, each column renormalised, a column whose sample
    lies outside the input zero."""
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = max(inv_scale, 1.0)
    sample = (np.arange(n_out, dtype=np.float64) + 0.5) * inv_scale - 0.5
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float64)[:, None]) / kernel_scale
    w = np.maximum(0.0, 1.0 - x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0.0)


def _nearest_index(n_in, n_out):
    """``jax.image.resize``'s nearest source rows, in its float32 arithmetic."""
    return np.floor((np.arange(n_out, dtype=np.float32) + 0.5) * n_in / n_out).astype(np.int64)


@functools.lru_cache(maxsize=256)
def _axis_tables(method, n_in, n_out, align_corners, scale, device, ct):
    """One spatial dim's resample tables on ``device``, built in float64
    numpy and cast to the compute dtype ``ct`` once per key and kept, so a
    call copies nothing from the host (JAX folds them into constants):
    ``nearest`` its source rows; ``triangle`` the (n_in, n_out) weights;
    ``lerp`` (low rows, high rows, fraction) at the align-corners or the
    explicit ``scale`` coordinates; ``cubic`` 4 clamped rows and 4 weights."""
    def on(a, dtype=None):
        t = torch.from_numpy(np.ascontiguousarray(a)).to(device)
        return t if dtype is None else t.to(dtype)

    if method == "nearest":
        return (on(_nearest_index(n_in, n_out)),)
    if method == "triangle":
        return (on(_resize_weights(n_in, n_out), ct),)
    if method == "lerp":
        if scale is not None:
            src = np.clip((np.arange(n_out) + 0.5) / scale - 0.5, 0.0, n_in - 1.0)
        else:
            src = (np.zeros(n_out) if n_out == 1 or n_in == 1
                   else np.linspace(0.0, n_in - 1.0, n_out))
        lo = np.floor(src).astype(np.int64)
        return on(lo), on(np.minimum(lo + 1, n_in - 1)), on(src - lo, ct)
    if n_in == 1:
        src = np.zeros(n_out)
    elif align_corners:
        src = np.arange(n_out) * ((n_in - 1.0) / max(n_out - 1, 1))
    else:
        ratio = (1.0 / scale) if scale else (n_in / n_out)
        src = (np.arange(n_out) + 0.5) * ratio - 0.5
    idx, ws = _cubic_taps(src, n_in)
    return (tuple(on(idx[:, k]) for k in range(4)), tuple(on(ws[:, k], ct) for k in range(4)))


def _matmul_axis(out, w, axis):
    """``out`` contracted with the (n_in, n_out) matrix ``w`` along ``axis``."""
    moved = out.movedim(axis, -1)
    return (moved @ w).movedim(-1, axis)


def _along(t, out, axis):
    """The per-row vector ``t`` shaped to broadcast along ``axis`` of ``out``."""
    shape = [1] * out.dim()
    shape[axis] = t.shape[0]
    return t.reshape(shape)


def _lerp_axis(out, n_in, axis, n_out, scale=None):
    """2-tap linear resample of one axis (the align-corners branch, or the
    explicit-scale branch at ``scale``)."""
    ct = torch.promote_types(out.dtype, torch.float32)
    lo, hi, frac = _axis_tables("lerp", n_in, n_out, False, scale, out.device, ct)
    frac = _along(frac, out, axis)
    return (out.index_select(axis, lo).to(ct) * (1 - frac)
            + out.index_select(axis, hi).to(ct) * frac)


def _cubic_taps(src, n_in, a=-0.75):
    """Keys cubic-convolution taps (clamped to the input) and their float64
    weights at the coordinates ``src``."""
    f = np.floor(src)
    t = src - f

    def W(x):
        ax = np.abs(x)
        near = ((a + 2.0) * ax - (a + 3.0)) * ax * ax + 1.0
        far = (((ax - 5.0) * ax + 8.0) * ax - 4.0) * a
        return np.where(ax <= 1.0, near, np.where(ax < 2.0, far, 0.0))

    ws = np.stack([W(t + 1.0), W(t), W(1.0 - t), W(2.0 - t)], -1)
    idx = f[:, None].astype(np.int64) + np.arange(-1, 3)[None, :]
    return np.clip(idx, 0, n_in - 1), ws


@defop("interpolate_op")
def _interp(v, size=None, method="nearest", align_corners=False, scales=None):
    spatial = list(zip(v.shape[1:-1], size))
    if method == "cubic":
        out = v
        ct = torch.promote_types(v.dtype, torch.float32)
        for d, (n_in, n_out) in enumerate(spatial):
            axis = 1 + d
            idx, ws = _axis_tables("cubic", n_in, n_out, bool(align_corners),
                                   float(scales[d]) if scales else None, v.device, ct)
            acc = 0.0
            for k in range(4):
                acc = acc + out.index_select(axis, idx[k]).to(ct) * _along(ws[k], out, axis)
            out = acc  # the compute dtype across dims: one rounding
        return out.to(v.dtype)
    frac_scales = (scales and not align_corners and method == "linear"
                   and any(float(f) != int(f) for f in scales))
    if frac_scales:
        out = v
        for d, (n_in, n_out) in enumerate(spatial):
            out = _lerp_axis(out, n_in, 1 + d, n_out, float(scales[d]))
        return out.to(v.dtype)
    if method == "nearest":
        out = v
        for d, (n_in, n_out) in enumerate(spatial):
            if n_in != n_out:
                (idx,) = _axis_tables("nearest", n_in, n_out, False, None, v.device, None)
                out = out.index_select(1 + d, idx)
        return out
    if not align_corners:
        out = v if v.is_floating_point() else v.to(torch.float32)
        for d, (n_in, n_out) in enumerate(spatial):
            if n_in != n_out:
                (w,) = _axis_tables("triangle", n_in, n_out, False, None, out.device,
                                    out.dtype)
                out = _matmul_axis(out, w, 1 + d)
        return out
    out = v
    for d, (n_in, n_out) in enumerate(spatial):
        out = _lerp_axis(out, n_in, 1 + d, n_out)
    return out.to(v.dtype)


def _adaptive_reduce(x, out_size, first_axis, reduce):
    """Adaptive pooling one spatial dim after another from ``first_axis``:
    a reshape when the output divides the input, else the bins
    ``[floor(i * n / m), ceil((i + 1) * n / m))``."""
    out = x
    for d, n_out in enumerate(out_size):
        axis = first_axis + d
        n_in = out.shape[axis]
        if n_in % n_out == 0:
            shape = list(out.shape)
            shape[axis:axis + 1] = [n_out, n_in // n_out]
            out = reduce(out.reshape(shape), axis + 1, False)
        else:
            pieces = []
            for i in range(n_out):
                s = int(np.floor(i * n_in / n_out))
                e = int(np.ceil((i + 1) * n_in / n_out))
                pieces.append(reduce(out.narrow(axis, s, e - s), axis, True))
            out = torch.cat(pieces, dim=axis)
    return out


def _mean(t, axis, keepdim):
    return torch.mean(t, dim=axis, keepdim=keepdim)


@defop("interp_area")
def _interp_area(v, size=None):
    return _adaptive_reduce(v, size, 1, _mean)


def interpolate(x, size=None, scale_factor=None, mode="nearest", align_corners=False,
                align_mode=0, data_format=None, name=None):
    """paddle.nn.functional.interpolate with the JAX arithmetic (module
    docstring); ``align_mode`` is ignored, as in JAX."""
    from ...ops.manipulation import transpose

    nd = x.dim()
    if data_format is None:
        data_format = {3: "NCW", 4: "NCHW", 5: "NCDHW"}[nd]
    channel_last = data_format[-1] == "C"
    spatial = nd - 2
    xc = x if channel_last else transpose(x, [0] + list(range(2, nd)) + [1])
    in_spatial = xc.shape[1:-1]
    scales = None
    if size is None:
        if isinstance(scale_factor, (int, float)):
            scale_factor = [scale_factor] * spatial
        scales = tuple(float(f) for f in scale_factor)
        size = [int(s * f) for s, f in zip(in_spatial, scale_factor)]
    else:
        if isinstance(size, torch.Tensor):
            size = size.reshape(-1).tolist()
        size = [int(s) for s in size]
    mode_l = mode.lower()
    if mode_l == "area":
        out = _interp_area(xc, size=tuple(size))
    else:
        method = {"nearest": "nearest", "bilinear": "linear", "linear": "linear",
                  "trilinear": "linear", "bicubic": "cubic"}[mode_l]
        out = _interp(xc, size=tuple(size), method=method, align_corners=bool(align_corners),
                      scales=scales)
    if not channel_last:
        return transpose(out, [0, nd - 1] + list(range(1, nd - 1)))
    return out


def upsample(x, size=None, scale_factor=None, mode="nearest", align_corners=False,
             align_mode=0, data_format=None, name=None):
    return interpolate(x, size, scale_factor, mode, align_corners, align_mode, data_format)


# ---- pixel and channel shuffles, im2col ----------------------------------------
@defop("pixel_shuffle_op")
def _pixel_shuffle(x, upscale_factor, data_format="NCHW"):
    r = upscale_factor
    if data_format == "NCHW":
        n, c, h, w = x.shape
        oc = c // (r * r)
        x = x.reshape(n, oc, r, r, h, w).permute(0, 1, 4, 2, 5, 3)
        return x.reshape(n, oc, h * r, w * r)
    n, h, w, c = x.shape
    oc = c // (r * r)
    x = x.reshape(n, h, w, r, r, oc).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h * r, w * r, oc)


def pixel_shuffle(x, upscale_factor, data_format="NCHW", name=None):
    return _pixel_shuffle(x, upscale_factor=int(upscale_factor), data_format=data_format)


@defop("pixel_unshuffle_op")
def _pixel_unshuffle(x, downscale_factor, data_format="NCHW"):
    r = downscale_factor
    if data_format == "NCHW":
        n, c, h, w = x.shape
        x = x.reshape(n, c, h // r, r, w // r, r).permute(0, 1, 3, 5, 2, 4)
        return x.reshape(n, c * r * r, h // r, w // r)
    n, h, w, c = x.shape
    x = x.reshape(n, h // r, r, w // r, r, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h // r, w // r, c * r * r)


def pixel_unshuffle(x, downscale_factor, data_format="NCHW", name=None):
    return _pixel_unshuffle(x, downscale_factor=int(downscale_factor), data_format=data_format)


@defop("channel_shuffle_op")
def _cs(x, groups, data_format="NCHW"):
    if data_format == "NCHW":
        n, c, h, w = x.shape
        x = x.reshape(n, groups, c // groups, h, w).permute(0, 2, 1, 3, 4)
        return x.reshape(n, c, h, w)
    n, h, w, c = x.shape
    x = x.reshape(n, h, w, groups, c // groups).permute(0, 1, 2, 4, 3)
    return x.reshape(n, h, w, c)


def channel_shuffle(x, groups, data_format="NCHW", name=None):
    return _cs(x, groups=int(groups), data_format=data_format)


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


@defop("unfold_op")
def _unfold(x, kh=1, kw=1, sh=1, sw=1, ph=0, pw=0, dh=1, dw=1):
    return tF.unfold(x, (kh, kw), dilation=(dh, dw), padding=(ph, pw), stride=(sh, sw))


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """im2col; of a 4-entry ``paddings`` only the first two are read, as in
    JAX."""
    kh, kw = _pair(kernel_sizes)
    sh, sw = _pair(strides)
    ph, pw = (_pair(paddings) if not (isinstance(paddings, (list, tuple)) and len(paddings) == 4)
              else (paddings[0], paddings[1]))
    dh, dw = _pair(dilations)
    return _unfold(x, kh=kh, kw=kw, sh=sh, sw=sw, ph=ph, pw=pw, dh=dh, dw=dw)


@defop("fold_op")
def _fold(x, oh, ow, kh, kw, sh, sw, ph, pw, dh, dw):
    return tF.fold(x, (oh, ow), (kh, kw), dilation=(dh, dw), padding=(ph, pw), stride=(sh, sw))


def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    oh, ow = _pair(output_sizes)
    kh, kw = _pair(kernel_sizes)
    sh, sw = _pair(strides)
    ph, pw = _pair(paddings)
    dh, dw = _pair(dilations)
    return _fold(x, oh=oh, ow=ow, kh=kh, kw=kw, sh=sh, sw=sw, ph=ph, pw=pw, dh=dh, dw=dw)


@defop("label_smooth_op")
def _ls(label, prior_dist=None, epsilon=0.1):
    if prior_dist is not None:
        return (1 - epsilon) * label + epsilon * prior_dist
    return (1 - epsilon) * label + epsilon / label.shape[-1]


def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    return _ls(label, prior_dist, epsilon=float(epsilon))


@defop("sequence_mask", differentiable=False)
def _sequence_mask(x, maxlen, dtype):
    return (torch.arange(maxlen, device=x.device)[None, :] < x[..., None]).to(dtype)


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    if maxlen is None:
        maxlen = int(x.max())
    return _sequence_mask(x, maxlen=int(maxlen), dtype=dtype_mod.convert_dtype(dtype))
