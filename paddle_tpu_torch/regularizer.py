"""paddle.regularizer: the port of ``paddle_tpu/regularizer.py`` (reference
python/paddle/regularizer.py): the optimizers' L1Decay and L2Decay."""
from .optimizer import L1Decay, L2Decay  # noqa: F401

__all__ = ["L1Decay", "L2Decay"]
