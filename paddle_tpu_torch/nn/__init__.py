"""Neural-network layers and functionals of the port."""
from . import functional  # noqa: F401
from .layer.norm import RMSNorm  # noqa: F401
