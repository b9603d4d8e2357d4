"""Optimizers of the port (counterpart of paddle_tpu.optimizer): Adam, AdamW."""
from .optimizer import Adam, AdamW, Optimizer  # noqa: F401
