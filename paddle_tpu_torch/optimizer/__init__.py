"""Optimizers of the port (counterpart of paddle_tpu.optimizer): every rule
of the JAX package's optimizer.py, the coupled decays and the LR schedulers
(``lr``)."""
from . import lr  # noqa: F401
from .optimizer import (  # noqa: F401
    ASGD, LBFGS, SGD, Adadelta, Adagrad, Adam, Adamax, AdamW, L1Decay, L2Decay, Lamb,
    Momentum, NAdam, Optimizer, RAdam, RMSProp, Rprop)
