"""fleet utilities of the port: activation recompute."""
from .recompute import recompute  # noqa: F401
