"""Fused ops, experimental optimizers and the functional autograd surface of
the port (counterpart of paddle_tpu.incubate)."""
from . import autograd  # noqa: F401
from .optimizer import LookAhead, ModelAverage  # noqa: F401
