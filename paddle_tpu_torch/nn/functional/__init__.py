"""Functionals of the port (counterpart of paddle_tpu.nn.functional)."""
from .activation import *  # noqa: F401,F403
from .common import embedding, linear  # noqa: F401
from .extras import flash_attn_qkvpacked, flash_attn_varlen_qkvpacked  # noqa: F401
from .flash_attention import (flash_attention, flash_attn_unpadded,  # noqa: F401
                              scaled_dot_product_attention, sdp_kernel)
from .loss import (  # noqa: F401
    binary_cross_entropy, binary_cross_entropy_with_logits, cosine_embedding_loss,
    cross_entropy, ctc_loss, dice_loss, gaussian_nll_loss, hinge_embedding_loss, huber_loss,
    kl_div, l1_loss, log_loss, margin_ranking_loss, mse_loss, multi_label_soft_margin_loss,
    nll_loss, poisson_nll_loss, sigmoid_cross_entropy_with_logits, smooth_l1_loss,
    soft_margin_loss, softmax_with_cross_entropy, square_error_cost, triplet_margin_loss)
from .norm import *  # noqa: F401,F403
from ...ops.random_ops import gumbel_softmax  # noqa: F401,E402
