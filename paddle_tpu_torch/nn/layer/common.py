"""Common layers: the port of paddle_tpu/nn/layer/common.py, and the
flagship LLaMA's torch-layout pair.

``Linear`` and ``Embedding`` are ``Layer``s with the JAX layout and
arguments: ``Linear``'s weight is ``[in_features, out_features]`` (paddle's,
y = x W + b through the ``linear`` op), built by ``weight_attr`` or
``XavierUniform`` with paddle's fans, its bias by ``bias_attr`` or
``Constant(0)`` (``bias_attr=False``: none); ``Embedding``'s weight is
``[num_embeddings, embedding_dim]`` from ``Normal(0, 1)``, the
``padding_idx`` row zeroed. A JAX ``state_dict`` loads into either with no
transpose. Both also take ``device=`` and ``dtype=``.

The rest (``Identity``, the dropouts, ``Flatten``/``Unflatten``, the
upsampling, shuffle, fold and pad layers, ``Bilinear``, ``CosineSimilarity``,
``PairwiseDistance``) each call their functional with the arguments they
were built with; ``Bilinear``'s weight is ``[out, in1, in2]`` and its bias
``[1, out]``, as in JAX. The dropouts follow ``self.training``.

``_TorchLinear`` and ``_TorchEmbedding`` are torch's layers, weights in
torch's layout (``Linear``: (out, in)) and named ``Parameter``s, whose
forward goes through the same ops (``linear`` takes the transpose, a
view): the flagship LLaMA (``models/llama.py``) is built of them, so its
conversions (``models/convert.py``), its captured programs and its saved
programs keep torch's layout.
"""
from __future__ import annotations

import torch
from torch import nn

from ...framework import name_parameters
from .. import functional as F
from ..functional.common import embedding, linear
from ..initializer import Normal
from .layers import Layer

__all__ = ["Identity", "Linear", "Embedding", "Dropout", "Dropout2D",
           "Dropout3D", "AlphaDropout", "Flatten", "Unflatten", "Upsample",
           "UpsamplingBilinear2D", "UpsamplingNearest2D", "PixelShuffle", "PixelUnshuffle",
           "ChannelShuffle", "Bilinear", "CosineSimilarity", "PairwiseDistance", "Fold",
           "Unfold", "Pad1D", "Pad2D", "Pad3D", "ZeroPad2D"]


class Identity(Layer):
    def forward(self, x):
        return x


class Linear(Layer):
    """y = x W + b, W of shape (in_features, out_features)."""

    def __init__(self, in_features, out_features, weight_attr=None, bias_attr=None, name=None,
                 *, device=None, dtype=None):
        super().__init__()
        self._device = device
        if dtype is not None:
            self._dtype = dtype
        self.in_features = in_features
        self.out_features = out_features
        self.weight = self.create_parameter([in_features, out_features], attr=weight_attr)
        self.bias = self.create_parameter([out_features], attr=bias_attr, is_bias=True)

    def forward(self, x):
        return linear(x, self.weight, self.bias)

    def extra_repr(self):
        return f"in_features={self.in_features}, out_features={self.out_features}"


class Embedding(Layer):
    def __init__(self, num_embeddings, embedding_dim, padding_idx=None, sparse=False,
                 weight_attr=None, name=None, *, device=None, dtype=None):
        super().__init__()
        self._device = device
        if dtype is not None:
            self._dtype = dtype
        self._num_embeddings = num_embeddings
        self._embedding_dim = embedding_dim
        self._padding_idx = padding_idx
        self.weight = self.create_parameter([num_embeddings, embedding_dim], attr=weight_attr,
                                            default_initializer=Normal(0.0, 1.0))
        if padding_idx is not None:
            idx = padding_idx if padding_idx >= 0 else num_embeddings + padding_idx
            with torch.no_grad():
                self.weight[idx] = 0.0

    def forward(self, x):
        return embedding(x, self.weight, padding_idx=self._padding_idx)

    def extra_repr(self):
        return f"{self._num_embeddings}, {self._embedding_dim}"


class Embedding_(Embedding):
    pass


class Dropout(Layer):
    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None):
        super().__init__()
        self.p = p
        self.axis = axis
        self.mode = mode

    def forward(self, x):
        return F.dropout(x, self.p, axis=self.axis, training=self.training, mode=self.mode)

    def extra_repr(self):
        return f"p={self.p}"


class Dropout2D(Layer):
    def __init__(self, p=0.5, data_format="NCHW", name=None):
        super().__init__()
        self.p = p
        self.data_format = data_format

    def forward(self, x):
        return F.dropout2d(x, self.p, training=self.training, data_format=self.data_format)


class Dropout3D(Layer):
    def __init__(self, p=0.5, data_format="NCDHW", name=None):
        super().__init__()
        self.p = p
        self.data_format = data_format

    def forward(self, x):
        return F.dropout3d(x, self.p, training=self.training, data_format=self.data_format)


class AlphaDropout(Layer):
    def __init__(self, p=0.5, name=None):
        super().__init__()
        self.p = p

    def forward(self, x):
        return F.alpha_dropout(x, self.p, training=self.training)


class Flatten(Layer):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis = start_axis
        self.stop_axis = stop_axis

    def forward(self, x):
        from ...ops.manipulation import flatten

        return flatten(x, self.start_axis, self.stop_axis)


class Unflatten(Layer):
    def __init__(self, axis, shape, name=None):
        super().__init__()
        self.axis = axis
        self.shape = shape

    def forward(self, x):
        from ...ops.manipulation import reshape

        new_shape = list(x.shape)
        new_shape[self.axis:self.axis + 1] = list(self.shape)
        return reshape(x, new_shape)


class Upsample(Layer):
    def __init__(self, size=None, scale_factor=None, mode="nearest", align_corners=False,
                 align_mode=0, data_format=None, name=None):
        super().__init__()
        self.size = size
        self.scale_factor = scale_factor
        self.mode = mode
        self.align_corners = align_corners
        self.align_mode = align_mode
        self.data_format = data_format

    def forward(self, x):
        return F.interpolate(x, self.size, self.scale_factor, self.mode, self.align_corners,
                             self.align_mode, self.data_format)


class UpsamplingBilinear2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW", name=None):
        super().__init__(size, scale_factor, "bilinear", True, 0, data_format)


class UpsamplingNearest2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW", name=None):
        super().__init__(size, scale_factor, "nearest", False, 0, data_format)


class PixelShuffle(Layer):
    def __init__(self, upscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.upscale_factor = upscale_factor
        self.data_format = data_format

    def forward(self, x):
        return F.pixel_shuffle(x, self.upscale_factor, self.data_format)


class PixelUnshuffle(Layer):
    def __init__(self, downscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.downscale_factor = downscale_factor
        self.data_format = data_format

    def forward(self, x):
        return F.pixel_unshuffle(x, self.downscale_factor, self.data_format)


class ChannelShuffle(Layer):
    def __init__(self, groups, data_format="NCHW", name=None):
        super().__init__()
        self.groups = groups
        self.data_format = data_format

    def forward(self, x):
        return F.channel_shuffle(x, self.groups, self.data_format)


class Bilinear(Layer):
    def __init__(self, in1_features, in2_features, out_features, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        self.weight = self.create_parameter([out_features, in1_features, in2_features],
                                            attr=weight_attr)
        self.bias = self.create_parameter([1, out_features], attr=bias_attr, is_bias=True)

    def forward(self, x1, x2):
        from ...ops.einsum_op import einsum

        out = einsum("bi,oij,bj->bo", x1, self.weight, x2)
        if self.bias is not None:
            return out + self.bias
        return out


class CosineSimilarity(Layer):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self.axis = axis
        self.eps = eps

    def forward(self, x1, x2):
        return F.cosine_similarity(x1, x2, self.axis, self.eps)


class PairwiseDistance(Layer):
    def __init__(self, p=2.0, epsilon=1e-6, keepdim=False, name=None):
        super().__init__()
        self.p = p
        self.epsilon = epsilon
        self.keepdim = keepdim

    def forward(self, x, y):
        from ...ops.reduction import norm

        return norm(x - y + self.epsilon, p=self.p, axis=-1, keepdim=self.keepdim)


class Fold(Layer):
    def __init__(self, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1,
                 name=None):
        super().__init__()
        self.args = (output_sizes, kernel_sizes, strides, paddings, dilations)

    def forward(self, x):
        return F.fold(x, *self.args)


class Unfold(Layer):
    def __init__(self, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
        super().__init__()
        self.args = (kernel_sizes, strides, paddings, dilations)

    def forward(self, x):
        return F.unfold(x, *self.args)


class _Pad(Layer):
    _DATA_FORMAT = None

    def __init__(self, padding, mode="constant", value=0.0, data_format=None, name=None):
        super().__init__()
        self.padding, self.mode, self.value = padding, mode, value
        self.data_format = data_format or self._DATA_FORMAT

    def forward(self, x):
        return F.pad(x, self.padding, self.mode, self.value, self.data_format)


class Pad1D(_Pad):
    _DATA_FORMAT = "NCL"


class Pad2D(_Pad):
    _DATA_FORMAT = "NCHW"


class Pad3D(_Pad):
    _DATA_FORMAT = "NCDHW"


class ZeroPad2D(Pad2D):
    def __init__(self, padding, data_format="NCHW", name=None):
        super().__init__(padding, "constant", 0.0, data_format)


class _TorchLinear(nn.Linear):
    def __init__(self, in_features, out_features, bias=True, device=None, dtype=None):
        super().__init__(in_features, out_features, bias=bias, device=device, dtype=dtype)
        name_parameters(self)

    def forward(self, x):
        return linear(x, self.weight.t(), self.bias)


class _TorchEmbedding(nn.Embedding):
    def __init__(self, num_embeddings, embedding_dim, padding_idx=None, device=None,
                 dtype=None):
        super().__init__(num_embeddings, embedding_dim, padding_idx=padding_idx,
                         device=device, dtype=dtype)
        name_parameters(self)

    def forward(self, x):
        return embedding(x, self.weight, padding_idx=self.padding_idx)
