"""Weight-only quantization: the port of paddle_tpu/quantization/weight_only.py.

``weight_quantize`` takes a weight in paddle's ``[in, out]`` layout to int8
(per output channel, or per ``group_size`` rows of the input dim) or to int4
packed two a byte along the input dim (an odd ``in`` pads one zero row), with
float32 scales ``max(|w|, 1e-8) / 127`` (``/ 7`` for int4). It computes in
float32 on the weight's device with the JAX function's arithmetic (an exact
absmax, a correctly rounded division, round half to even, the int8 shift
that wraps), so its tensors equal the JAX package's bit for bit from a CPU
or a CUDA tensor alike. The divisors 127 and 7 are device tensors: torch's
CUDA division by a Python scalar multiplies by its reciprocal, which rounds
otherwise.

``weight_only_linear`` (the op ``weight_only_linear``, AMP white list)
dequantizes in the input's dtype and multiplies, ``x @ (q * s) + b``, with
``torch.matmul``: the JAX package computes the product in XLA, outside any
Pallas kernel. A 2-D (group-wise) scale is repeated over its groups there;
``weight_dequantize`` raises ``NotImplementedError`` for one, since the JAX
function multiplies without repeating and raises (ROADMAP Queue C, Reference
caveats). ``weight_only_linear``'s ``group_size`` is ignored: the scale's
rank decides, as in JAX.

``WeightOnlyLinear`` holds ``quant_weight`` and ``weight_scale`` as
persistable buffers and shares the ``Linear``'s bias. ``quantize_for_inference``
swaps the public ``nn.Linear`` and, beyond the JAX function, the private
``_TorchLinear`` the flagship LLaMA is built of (its ``weight.t()`` is
quantized, so ``quant_weight`` is ``[in, out]`` as in JAX), skipping the
children of a QAT ``_QuantedWrapper``; ``min_features`` applies to
``in_features``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..framework import dtype as dtype_mod
from ..nn.layer.layers import Layer
from ..ops._apply import defop

__all__ = ["weight_quantize", "weight_dequantize", "weight_only_linear",
           "WeightOnlyLinear", "quantize_for_inference"]

def _as_float32(weight):
    if isinstance(weight, torch.Tensor):
        return weight.detach().to(torch.float32)
    from .. import resolve_device

    arr = np.asarray(weight, np.float32)
    return torch.from_numpy(arr.copy()).to(resolve_device(None))


def weight_quantize(weight, algo="weight_only_int8", group_size=-1):
    """(quantized int8 tensor, float32 scale) for an ``[in, out]`` weight
    (module docstring)."""
    w = _as_float32(weight)

    def levels(n):  # a correctly rounded division on every device
        return torch.full((), n, dtype=torch.float32, device=w.device)

    if group_size and group_size > 0 and algo != "weight_only_int8":
        raise NotImplementedError(
            "group_size is supported for weight_only_int8 only in this build")
    if algo == "weight_only_int8":
        if group_size and group_size > 0:
            k, n = w.shape
            if k % group_size:
                raise ValueError(
                    f"in_features {k} not divisible by group_size {group_size}")
            wg = w.reshape(-1, group_size, n)
            s = torch.clamp(wg.abs().amax(1), min=1e-8) / levels(127.0)  # (groups, out)
            q = torch.clamp(torch.round(wg / s[:, None, :]), -127, 127)
            return q.to(torch.int8).reshape(k, n), s
        s = torch.clamp(w.abs().amax(0), min=1e-8) / levels(127.0)   # (out,)
        return torch.clamp(torch.round(w / s), -127, 127).to(torch.int8), s
    if algo == "weight_only_int4":
        s = torch.clamp(w.abs().amax(0), min=1e-8) / levels(7.0)
        q = torch.clamp(torch.round(w / s), -7, 7).to(torch.int8)
        if q.shape[0] % 2:
            q = torch.cat([q, q.new_zeros(1, q.shape[1])])
        lo = q[0::2] & 0x0F
        hi = (q[1::2] & 0x0F) << 4                                   # wraps in int8
        return lo | hi, s                                            # (in/2, out)
    raise ValueError(f"unsupported weight_quantize algo {algo!r}")


def _unpack_int4(packed, k):
    p = packed.to(torch.int32)
    lo = (p & 0x0F).to(torch.int8)
    hi = ((p >> 4) & 0x0F).to(torch.int8)
    # sign-extend 4-bit two's complement
    lo = torch.where(lo > 7, lo - 16, lo)
    hi = torch.where(hi > 7, hi - 16, hi)
    return torch.stack([lo, hi], 1).reshape(-1, packed.shape[1])[:k]


def weight_dequantize(quant_weight, scale, algo="weight_only_int8", out_dtype="float32",
                      k=None):
    """The inverse of ``weight_quantize`` for a per-channel scale; a 2-D
    scale raises ``NotImplementedError`` (module docstring)."""
    if scale.dim() == 2:
        raise NotImplementedError(
            "weight_dequantize of a group-wise (2-D) scale: the JAX function multiplies "
            "without repeating the scales and raises (ROADMAP Queue C, Reference caveats); "
            "weight_only_linear takes such a scale")
    q = quant_weight
    if algo == "weight_only_int4":
        q = _unpack_int4(q, k if k is not None else q.shape[0] * 2)
    dt = dtype_mod.convert_dtype(out_dtype)
    return q.to(dt) * scale.to(dt)


@defop("weight_only_linear", amp_category="white")
def _wol(x, qweight, scale, bias=None, algo="weight_only_int8", k=None):
    w = _unpack_int4(qweight, k) if algo == "weight_only_int4" else qweight
    s = scale.to(x.dtype)
    if s.dim() == 2:  # group-wise: (groups, out) -> per-row scales
        s = s.repeat_interleave(w.shape[0] // s.shape[0], 0)[:w.shape[0]]
    out = torch.matmul(x, w.to(x.dtype) * s)
    return out + bias.to(x.dtype) if bias is not None else out


def weight_only_linear(x, weight, bias=None, weight_scale=None, weight_dtype="int8",
                       group_size=-1, name=None):
    """x @ dequant(int weight) (+ bias); ``group_size`` is ignored (module
    docstring)."""
    if weight_scale is None:
        raise ValueError("weight_only_linear requires weight_scale (from weight_quantize)")
    algo = "weight_only_int4" if str(weight_dtype) == "int4" else "weight_only_int8"
    return _wol(x, weight, weight_scale, bias, algo=algo, k=x.shape[-1])


def _jax_layout_weight(linear):
    """``[in, out]``: the public ``Linear``'s weight, or the transpose of a
    torch-layout ``_TorchLinear``'s."""
    from ..nn.layer.common import _TorchLinear

    return linear.weight.t() if isinstance(linear, _TorchLinear) else linear.weight


class WeightOnlyLinear(Layer):
    """Inference ``Linear`` with int8/int4 weights (the serving swap target)."""

    def __init__(self, linear, algo="weight_only_int8"):
        super().__init__()
        self.algo = algo
        w = _jax_layout_weight(linear)
        self.in_features = int(w.shape[0])
        self.out_features = int(w.shape[1])
        qw, s = weight_quantize(w, algo=algo)
        # buffers: in the state_dict, outside the gradients
        self.register_buffer("quant_weight", qw)
        self.register_buffer("weight_scale", s)
        self.bias = linear.bias

    def forward(self, x):
        return _wol(x, self.quant_weight, self.weight_scale, self.bias, algo=self.algo,
                    k=self.in_features)

    def extra_repr(self):
        return f"in={self.in_features}, out={self.out_features}, algo={self.algo}"


def quantize_for_inference(model, algo="weight_only_int8", min_features=0):
    """Swap every ``Linear`` (and ``_TorchLinear``) of at least
    ``min_features`` inputs for a ``WeightOnlyLinear``; returns the number
    swapped (module docstring)."""
    from ..nn.layer.common import Linear, _TorchLinear
    from . import _QuantedWrapper

    count = 0
    for _, layer in list(model.named_modules(remove_duplicate=False)):
        if isinstance(layer, _QuantedWrapper):
            # its forward reads .inner.weight: convert the QAT model first
            continue
        for name, sub in list(layer._modules.items()):
            if (isinstance(sub, (Linear, _TorchLinear))
                    and int(_jax_layout_weight(sub).shape[0]) >= min_features):
                layer._modules[name] = WeightOnlyLinear(sub, algo=algo)
                count += 1
    return count
