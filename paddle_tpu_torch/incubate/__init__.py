"""Fused ops and experimental optimizers of the port (counterpart of
paddle_tpu.incubate)."""
from .optimizer import LookAhead, ModelAverage  # noqa: F401
