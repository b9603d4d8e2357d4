"""AMP op lists: a copy of ``paddle_tpu/amp/amp_lists.py`` (reference
python/paddle/amp/amp_lists.py WHITE_LIST/BLACK_LIST). The white list (the
matrix products and attention) runs in the low dtype on the tensor cores; the
black list keeps numerically sensitive ops in float32.
"""

WHITE_LIST = {
    "matmul",
    "bmm",
    "mv",
    "multi_dot",
    "conv2d",
    "conv1d",
    "conv3d",
    "conv2d_transpose",
    "einsum",
    "addmm",
    "flash_attention",
    "scaled_dot_product_attention",
}

BLACK_LIST = {
    "exp",
    "square",
    "log",
    "log2",
    "log10",
    "log1p",
    "mean",
    "sum",
    "cos_sim",
    "softmax",
    "log_softmax",
    "softmax_with_cross_entropy",
    "cross_entropy",
    "sigmoid_cross_entropy_with_logits",
    "c_softmax_with_cross_entropy",
    "layer_norm",
    "rms_norm",
    "reduce_sum",
    "linear_interp",
    "nearest_interp",
    "bilinear_interp",
    "pow",
    "erfinv",
    "logsumexp",
    "norm_op",
    "cumsum",
    "cumprod",
    "var",
    "std",
    "renorm",
}


def white_list():
    return set(WHITE_LIST)


def black_list():
    return set(BLACK_LIST)
