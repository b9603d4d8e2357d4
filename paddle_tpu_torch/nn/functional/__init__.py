"""Functionals of the port (counterpart of paddle_tpu.nn.functional)."""
from .activation import log_softmax, softmax, swiglu  # noqa: F401
from .common import embedding, linear  # noqa: F401
from .extras import flash_attn_qkvpacked, flash_attn_varlen_qkvpacked  # noqa: F401
from .flash_attention import (flash_attention, flash_attn_unpadded,  # noqa: F401
                              scaled_dot_product_attention, sdp_kernel)
from .loss import cross_entropy, nll_loss, softmax_with_cross_entropy  # noqa: F401
from .norm import rms_norm  # noqa: F401
from ...ops.random_ops import gumbel_softmax  # noqa: F401,E402
