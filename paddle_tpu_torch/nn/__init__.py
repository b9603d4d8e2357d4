"""Neural-network layers, functionals and gradient clipping of the port."""
from . import functional  # noqa: F401
from .layer import Embedding, Linear, RMSNorm  # noqa: F401
from .clip import (  # noqa: F401
    ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue, clip_grad_norm_, clip_grad_value_)
