"""Neural-network layers, functionals, initializers and gradient clipping of
the port (counterpart of paddle_tpu.nn): ``Layer``, a ``torch.nn.Module``
with paddle's methods (``nn/layer/layers.py``), its containers,
``ParamAttr`` and the initializers, and the common, activation, norm, conv,
pooling, loss, ``extras`` and transformer layers in the JAX layout, with
their functionals. ``rnn``, ``decode``, ``nn/utils`` and ``quant`` are what
is left of ROADMAP Queue A item 7b."""
from . import functional  # noqa: F401
from . import initializer  # noqa: F401
from .initializer import ParamAttr  # noqa: F401
from .layer import *  # noqa: F401,F403
from .clip import (  # noqa: F401
    ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue, clip_grad_norm_, clip_grad_value_)
