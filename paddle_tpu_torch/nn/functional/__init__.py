"""Functionals of the port (counterpart of paddle_tpu.nn.functional)."""
from .activation import *  # noqa: F401,F403
from .common import (  # noqa: F401
    alpha_dropout, channel_shuffle, cosine_similarity, dropout, dropout2d, dropout3d,
    embedding, fold, interpolate, label_smooth, linear, normalize, one_hot, pad,
    pixel_shuffle, pixel_unshuffle, sequence_mask, unfold, upsample)
from .conv import (  # noqa: F401
    conv1d, conv1d_transpose, conv2d, conv2d_transpose, conv3d, conv3d_transpose)
from .extras import (  # noqa: F401
    adaptive_log_softmax_with_loss, affine_grid, bilinear, class_center_sample, elu_,
    feature_alpha_dropout, flash_attn_qkvpacked, flash_attn_varlen_qkvpacked,
    flashmask_attention, fractional_max_pool2d, fractional_max_pool3d, gather_tree,
    grid_sample, hardtanh_, hsigmoid_loss, leaky_relu_, log_sigmoid, lp_pool1d, lp_pool2d,
    margin_cross_entropy, max_unpool1d, max_unpool2d, max_unpool3d, multi_margin_loss,
    npair_loss, pairwise_distance, rnnt_loss, rrelu, sigmoid_focal_loss, sparse_attention,
    tanh_, temporal_shift, thresholded_relu_, triplet_margin_with_distance_loss, zeropad2d)
from .flash_attention import (flash_attention, flash_attn_unpadded,  # noqa: F401
                              scaled_dot_product_attention, sdp_kernel)
from .loss import (  # noqa: F401
    binary_cross_entropy, binary_cross_entropy_with_logits, cosine_embedding_loss,
    cross_entropy, ctc_loss, dice_loss, gaussian_nll_loss, hinge_embedding_loss, huber_loss,
    kl_div, l1_loss, log_loss, margin_ranking_loss, mse_loss, multi_label_soft_margin_loss,
    nll_loss, poisson_nll_loss, sigmoid_cross_entropy_with_logits, smooth_l1_loss,
    soft_margin_loss, softmax_with_cross_entropy, square_error_cost, triplet_margin_loss)
from .norm import *  # noqa: F401,F403
from .pooling import (  # noqa: F401
    adaptive_avg_pool1d, adaptive_avg_pool2d, adaptive_avg_pool3d, adaptive_max_pool1d,
    adaptive_max_pool2d, adaptive_max_pool3d, avg_pool1d, avg_pool2d, avg_pool3d,
    max_pool1d, max_pool2d, max_pool3d)
from ...ops.random_ops import gumbel_softmax  # noqa: F401,E402
