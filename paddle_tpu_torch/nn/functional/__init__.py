"""Functionals of the port (counterpart of paddle_tpu.nn.functional)."""
from .activation import swiglu  # noqa: F401
from .flash_attention import scaled_dot_product_attention  # noqa: F401
from .loss import cross_entropy, nll_loss, softmax_with_cross_entropy  # noqa: F401
from .norm import rms_norm  # noqa: F401
