"""Convolution functionals: the port of paddle_tpu/nn/functional/conv.py.

Paddle's layouts: the weight of ``conv*d`` is (out, in // groups, *k), the
weight of ``conv*d_transpose`` is (in, out // groups, *k); the data is NC*
or channel-last (``NLC``, ``NHWC``, ``NDHWC``). The convolutions are
torch's ``conv*d`` and ``conv_transpose*d`` (the JAX package's
``lax.conv_general_dilated``, outside any Pallas kernel); the ops keep the
JAX names (``conv1d``, ``conv2d``, ``conv3d``, ``conv2d_transpose``,
``conv3d_transpose_inner``), white-listed under AMP.

Padding is ``_norm_padding``'s: an int, one int a dim, a (lo, hi) pair a
dim (asymmetric pads are applied with ``F.pad`` before the convolution),
or XLA's ``"SAME"``/``"SAME_LOWER"``/``"VALID"`` for any stride, turned
into explicit pads here (``_string_pads``: output ``ceil(n / stride)``, an
odd total's extra pad on the high side, on the low side for
``SAME_LOWER``). A transposed convolution takes numeric pads and
``output_padding``, which may exceed the stride: the output is the full
transposed convolution cropped by the pads and extended by
``output_padding`` zeros where no input reaches. A padding string pads its
undilated input as a stride-1 convolution would and ignores
``output_padding``; past stride 1 it raises ``ValueError``, as
``lax.conv_general_dilated`` does there.

As in JAX, ``output_size`` of the transposed convolutions is ignored, and
``conv3d_transpose`` with ``groups > 1`` raises ``NotImplementedError``:
the JAX function never passes the group count and returns a wrong result
(ROADMAP Queue C, Reference caveats).
"""
from __future__ import annotations

import torch.nn.functional as tF

from ...ops._apply import defop

_CONV = {1: tF.conv1d, 2: tF.conv2d, 3: tF.conv3d}
_CONV_T = {1: tF.conv_transpose1d, 2: tF.conv_transpose2d, 3: tF.conv_transpose3d}


def _tup(v, n):
    if isinstance(v, int):
        return (v,) * n
    return tuple(int(x) for x in v)


def _norm_padding(padding, n):
    """paddle padding: int, list[int], list[pair] (the last ``n`` pairs of a
    list that also covers batch and channels), or a padding string."""
    if isinstance(padding, str):
        return padding.upper()
    if isinstance(padding, int):
        return [(padding, padding)] * n
    padding = list(padding)
    if len(padding) == n and all(isinstance(p, int) for p in padding):
        return [(p, p) for p in padding]
    if len(padding) == 2 * n:
        return [(padding[2 * i], padding[2 * i + 1]) for i in range(n)]
    if all(isinstance(p, (list, tuple)) for p in padding):
        return [tuple(p) for p in padding][-n:]
    raise ValueError(f"bad padding {padding}")


def _string_pads(padding, in_sizes, windows, strides):
    """XLA's ``padtype_to_pads``: explicit (lo, hi) pairs of a padding string."""
    if padding == "VALID":
        return [(0, 0)] * len(in_sizes)
    if padding not in ("SAME", "SAME_LOWER"):
        raise ValueError(f"Unknown padding type: {padding}")
    pads = []
    for n, k, s in zip(in_sizes, windows, strides):
        out = -(-n // s)
        total = max((out - 1) * s + k - n, 0)
        lo = total // 2 if padding == "SAME" else total - total // 2
        pads.append((lo, total - lo))
    return pads


def _torch_pad(pairs):
    """(lo, hi) pairs, first spatial dim first, as ``F.pad``'s list."""
    return [v for lo, hi in reversed(pairs) for v in (lo, hi)]


def _channels_first(x, channel_last):
    return x.movedim(-1, 1) if channel_last else x


def _conv(x, weight, bias, stride, padding, dilation, groups, data_format):
    nd = weight.dim() - 2
    channel_last = data_format[-1] == "C"
    x = _channels_first(x, channel_last)
    if isinstance(padding, str):
        windows = [d * (k - 1) + 1 for d, k in zip(dilation, weight.shape[2:])]
        padding = _string_pads(padding, x.shape[2:], windows, stride)
    if all(lo == hi >= 0 for lo, hi in padding):
        out = _CONV[nd](x, weight, bias, stride, [lo for lo, _ in padding], dilation, groups)
    else:
        x = tF.pad(x, _torch_pad(padding))
        out = _CONV[nd](x, weight, bias, stride, 0, dilation, groups)
    return out.movedim(1, -1) if channel_last else out


_conv1d = defop("conv1d", amp_category="white")(_conv)
_conv2d = defop("conv2d", amp_category="white")(_conv)
_conv3d = defop("conv3d", amp_category="white")(_conv)


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    return _conv1d(x, weight, bias, stride=_tup(stride, 1),
                   padding=_norm_padding(padding, 1), dilation=_tup(dilation, 1),
                   groups=int(groups), data_format=data_format)


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    return _conv2d(x, weight, bias, stride=_tup(stride, 2),
                   padding=_norm_padding(padding, 2), dilation=_tup(dilation, 2),
                   groups=int(groups), data_format=data_format)


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None):
    return _conv3d(x, weight, bias, stride=_tup(stride, 3),
                   padding=_norm_padding(padding, 3), dilation=_tup(dilation, 3),
                   groups=int(groups), data_format=data_format)


def _conv_transpose(x, weight, bias, stride, padding, output_padding, dilation, groups,
                    data_format):
    """The transposed convolution of the JAX package's pad configuration
    ``(d (k - 1) - lo, d (k - 1) - hi + output_padding)`` on the input
    dilated by ``stride``: torch's, cropped by ``(lo, hi - output_padding)``."""
    nd = weight.dim() - 2
    channel_last = data_format[-1] == "C"
    x = _channels_first(x, channel_last)
    if isinstance(padding, str):
        if any(s != 1 for s in stride):
            raise ValueError("String padding is not implemented for transposed convolution "
                             "using this op. Please either exactly specify the required "
                             "padding or use conv_transpose.")
        windows = [d * (k - 1) + 1 for d, k in zip(dilation, weight.shape[2:])]
        pads = _string_pads(padding, x.shape[2:], windows, stride)
        padding = [(k - 1 - lo, k - 1 - hi) for (lo, hi), k in zip(pads, windows)]
        output_padding = (0,) * nd
    torch_pads = all(lo == hi >= 0 and 0 <= op < max(s, d) for (lo, hi), op, s, d
                     in zip(padding, output_padding, stride, dilation))
    if torch_pads:
        out = _CONV_T[nd](x, weight, bias, stride, [lo for lo, _ in padding],
                          list(output_padding), groups, dilation)
    else:
        out = _CONV_T[nd](x, weight, None, stride, 0, 0, groups, dilation)
        out = tF.pad(out, _torch_pad([(-lo, op - hi) for (lo, hi), op
                                      in zip(padding, output_padding)]))
        if bias is not None:
            out = out + bias.reshape([1, -1] + [1] * nd)
    return out.movedim(1, -1) if channel_last else out


_conv2d_transpose = defop("conv2d_transpose", amp_category="white")(_conv_transpose)
_c3t = defop("conv3d_transpose_inner", amp_category="white")(_conv_transpose)


def _transpose_args(padding, output_padding, stride, dilation, n):
    return dict(stride=_tup(stride, n), padding=_norm_padding(padding, n),
                output_padding=_tup(output_padding, n), dilation=_tup(dilation, n))


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0, output_padding=0,
                     groups=1, dilation=1, data_format="NCHW", output_size=None, name=None):
    """``output_size`` is ignored, as in JAX."""
    return _conv2d_transpose(x, weight, bias, groups=int(groups), data_format=data_format,
                             **_transpose_args(padding, output_padding, stride, dilation, 2))


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0, output_padding=0,
                     groups=1, dilation=1, data_format="NCL", output_size=None, name=None):
    """``output_size`` is ignored, as in JAX (which runs the 2-D op on a
    unit width; so does the op here, ``conv2d_transpose``, on 1-D data)."""
    return _conv2d_transpose(x, weight, bias, groups=int(groups), data_format=data_format,
                             **_transpose_args(padding, output_padding, stride, dilation, 1))


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0, output_padding=0,
                     groups=1, dilation=1, data_format="NCDHW", output_size=None, name=None):
    """``output_size`` is ignored, as in JAX. ``groups > 1`` raises: the JAX
    function drops the group count and returns a wrong result."""
    if int(groups) != 1:
        raise NotImplementedError(
            "conv3d_transpose with groups > 1: the JAX reference ignores groups and "
            "returns a wrong result (ROADMAP Queue C, Reference caveats)")
    return _c3t(x, weight, bias, groups=1, data_format=data_format,
                **_transpose_args(padding, output_padding, stride, dilation, 3))
