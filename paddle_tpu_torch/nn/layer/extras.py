"""Layers over the functional batch: the port of paddle_tpu/nn/layer/extras.py.

Each calls its functional (``nn/functional/extras.py``) with the arguments
it was built with. ``HSigmoidLoss`` holds the ``[num_classes - 1, D]``
internal-node weights and their bias; ``AdaptiveLogSoftmaxWithLoss`` the
head ``[in, shortlist + n_clusters]`` and per cluster ``tail_proj_i``
``[in, h_i]`` and ``tail_out_i`` ``[h_i, size_i]``, ``h_i = max(1, in /
div_value^(i+1))``. ``FeatureAlphaDropout`` is the identity in eval mode
and at ``p = 0``, and raises in training with ``p > 0``: the JAX layer
computes its own scale, ``(1 - p (1 + p alpha^2))^-0.5``, which is complex
from p of about 0.39 up, and returns a tensor cut from the tape (ROADMAP
Queue C, Reference caveats). ``F.feature_alpha_dropout`` is ported.
"""
from __future__ import annotations

from ... import ops
from .. import functional as F
from .layers import Layer

__all__ = ["LogSigmoid", "RReLU", "LPPool1D", "LPPool2D", "MaxUnPool1D", "MaxUnPool2D",
           "MaxUnPool3D", "MultiMarginLoss", "TripletMarginWithDistanceLoss",
           "FeatureAlphaDropout", "ZeroPad1D", "ZeroPad3D", "HSigmoidLoss",
           "AdaptiveLogSoftmaxWithLoss", "FractionalMaxPool2D", "FractionalMaxPool3D"]


class LogSigmoid(Layer):
    def forward(self, x):
        return F.log_sigmoid(x)


class RReLU(Layer):
    def __init__(self, lower=1.0 / 8.0, upper=1.0 / 3.0, name=None):
        super().__init__()
        self._lower, self._upper = lower, upper

    def forward(self, x):
        return F.rrelu(x, self._lower, self._upper, training=self.training)


class LPPool1D(Layer):
    def __init__(self, norm_type, kernel_size, stride=None, padding=0, ceil_mode=False,
                 name=None):
        super().__init__()
        self._args = (norm_type, kernel_size, stride, padding, ceil_mode)

    def forward(self, x):
        n, k, s, p, c = self._args
        return F.lp_pool1d(x, n, k, stride=s, padding=p, ceil_mode=c)


class LPPool2D(Layer):
    def __init__(self, norm_type, kernel_size, stride=None, padding=0, ceil_mode=False,
                 data_format="NCHW", name=None):
        super().__init__()
        self._args = (norm_type, kernel_size, stride, padding, ceil_mode, data_format)

    def forward(self, x):
        n, k, s, p, c, df = self._args
        return F.lp_pool2d(x, n, k, stride=s, padding=p, ceil_mode=c, data_format=df)


class MaxUnPool1D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, output_size=None, name=None):
        super().__init__()
        self._args = (kernel_size, stride, padding, output_size)

    def forward(self, x, indices):
        k, s, p, o = self._args
        return F.max_unpool1d(x, indices, k, stride=s, padding=p, output_size=o)


class MaxUnPool2D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, output_size=None,
                 data_format="NCHW", name=None):
        super().__init__()
        self._args = (kernel_size, stride, padding, output_size, data_format)

    def forward(self, x, indices):
        k, s, p, o, df = self._args
        return F.max_unpool2d(x, indices, k, stride=s, padding=p, output_size=o,
                              data_format=df)


class MaxUnPool3D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, output_size=None,
                 data_format="NCDHW", name=None):
        super().__init__()
        self._args = (kernel_size, stride, padding, output_size, data_format)

    def forward(self, x, indices):
        k, s, p, o, df = self._args
        return F.max_unpool3d(x, indices, k, stride=s, padding=p, output_size=o,
                              data_format=df)


class MultiMarginLoss(Layer):
    def __init__(self, p=1, margin=1.0, weight=None, reduction="mean", name=None):
        super().__init__()
        self._args = (p, margin, weight, reduction)

    def forward(self, input, label):  # noqa: A002
        p, m, w, r = self._args
        return F.multi_margin_loss(input, label, p=p, margin=m, weight=w, reduction=r)


class TripletMarginWithDistanceLoss(Layer):
    def __init__(self, distance_function=None, margin=1.0, swap=False, reduction="mean",
                 name=None):
        super().__init__()
        self._args = (distance_function, margin, swap, reduction)

    def forward(self, input, positive, negative):  # noqa: A002
        d, m, s, r = self._args
        return F.triplet_margin_with_distance_loss(input, positive, negative,
                                                   distance_function=d, margin=m, swap=s,
                                                   reduction=r)


class FeatureAlphaDropout(Layer):
    """Whole-channel alpha dropout (module docstring)."""

    def __init__(self, p=0.5, name=None):
        super().__init__()
        self._p = p

    def forward(self, x):
        if not self.training or self._p == 0.0:
            return x
        raise NotImplementedError(
            "FeatureAlphaDropout in training with p > 0: the JAX reference's scale is "
            "wrong and its output is cut from the tape (ROADMAP Queue C, Reference "
            "caveats); call nn.functional.feature_alpha_dropout")


class ZeroPad1D(Layer):
    def __init__(self, padding, data_format="NCL", name=None):
        super().__init__()
        self._padding = padding
        self._data_format = data_format

    def forward(self, x):
        p = self._padding
        p = [p, p] if isinstance(p, int) else list(p)
        return F.pad(x, p, mode="constant", value=0.0, data_format=self._data_format)


class ZeroPad3D(Layer):
    def __init__(self, padding, data_format="NCDHW", name=None):
        super().__init__()
        self._padding = padding
        self._data_format = data_format

    def forward(self, x):
        p = self._padding
        p = [p] * 6 if isinstance(p, int) else list(p)
        return F.pad(x, p, mode="constant", value=0.0, data_format=self._data_format)


class HSigmoidLoss(Layer):
    def __init__(self, feature_size, num_classes, weight_attr=None, bias_attr=None,
                 is_custom=False, is_sparse=False, name=None):
        super().__init__()
        if num_classes < 2:
            raise ValueError("num_classes must be >= 2")
        self.num_classes = num_classes
        self.weight = self.create_parameter([num_classes - 1, feature_size], attr=weight_attr)
        self.bias = self.create_parameter([num_classes - 1], attr=bias_attr, is_bias=True)

    def forward(self, input, label, path_table=None, path_code=None):  # noqa: A002
        return F.hsigmoid_loss(input, label, self.num_classes, self.weight, self.bias,
                               path_table=path_table, path_code=path_code)


def _adaptive_full_log_prob(input, head_weight, head_bias, tail_weights,  # noqa: A002
                            shortlist):
    """(N, n_classes) log-probabilities of the adaptive softmax, for the
    layer and the functional alike."""
    h = input.matmul(head_weight)
    if head_bias is not None:
        h = h + head_bias
    head_lp = F.log_softmax(h, axis=-1)
    parts = [head_lp[:, :shortlist]]
    for i, (proj, out) in enumerate(tail_weights):
        cluster_lp = F.log_softmax(input.matmul(proj).matmul(out), axis=-1)
        parts.append(cluster_lp + head_lp[:, shortlist + i:shortlist + i + 1])
    return ops.concat(parts, axis=-1)


class AdaptiveLogSoftmaxWithLoss(Layer):
    """Frequency-partitioned softmax: a head over the shortlist and one
    token a tail cluster, each cluster projected to ``in / div_value^(i+1)``
    before its own softmax. Returns (per-sample target log-prob, mean nll)."""

    def __init__(self, in_features, n_classes, cutoffs, div_value=4.0, head_bias=False,
                 name=None):
        super().__init__()
        cutoffs = list(cutoffs)
        if (cutoffs != sorted(cutoffs) or min(cutoffs) <= 0
                or max(cutoffs) > n_classes - 1 or len(set(cutoffs)) != len(cutoffs)):
            raise ValueError("cutoffs must be unique, positive, increasing and < n_classes")
        self.in_features = in_features
        self.n_classes = n_classes
        self.cutoffs = cutoffs + [n_classes]
        self.div_value = div_value
        self.shortlist_size = self.cutoffs[0]
        self.n_clusters = len(self.cutoffs) - 1
        self.head_size = self.shortlist_size + self.n_clusters
        self.head_weight = self.create_parameter([in_features, self.head_size])
        self.head_bias = (self.create_parameter([self.head_size], is_bias=True)
                          if head_bias else None)
        self.tail_weights = []
        for i in range(self.n_clusters):
            hsz = max(1, int(in_features / (div_value ** (i + 1))))
            osz = self.cutoffs[i + 1] - self.cutoffs[i]
            proj = self.add_parameter(f"tail_proj_{i}", self.create_parameter([in_features, hsz]))
            out = self.add_parameter(f"tail_out_{i}", self.create_parameter([hsz, osz]))
            self.tail_weights.append((proj, out))

    def log_prob(self, input):  # noqa: A002
        """(N, n_classes) full log-probabilities."""
        return _adaptive_full_log_prob(input, self.head_weight, self.head_bias,
                                       self.tail_weights, self.shortlist_size)

    def predict(self, input):  # noqa: A002
        return ops.argmax(self.log_prob(input), axis=-1)

    def forward(self, input, label):  # noqa: A002
        full = self.log_prob(input)
        out = ops.take_along_axis(full, label.long().unsqueeze(-1), axis=-1).squeeze(-1)
        return out, -out.mean()


class FractionalMaxPool2D(Layer):
    def __init__(self, output_size, kernel_size=None, random_u=None, return_mask=False,
                 name=None):
        super().__init__()
        self._args = (output_size, kernel_size, random_u, return_mask)

    def forward(self, x):
        o, k, u, rm = self._args
        return F.fractional_max_pool2d(x, o, kernel_size=k, random_u=u, return_mask=rm)


class FractionalMaxPool3D(Layer):
    def __init__(self, output_size, kernel_size=None, random_u=None, return_mask=False,
                 name=None):
        super().__init__()
        self._args = (output_size, kernel_size, random_u, return_mask)

    def forward(self, x):
        o, k, u, rm = self._args
        return F.fractional_max_pool3d(x, o, kernel_size=k, random_u=u, return_mask=rm)
