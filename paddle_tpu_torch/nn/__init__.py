"""Neural-network layers, functionals, initializers and gradient clipping of
the port (counterpart of paddle_tpu.nn): ``Layer``, a ``torch.nn.Module``
with paddle's methods (``nn/layer/layers.py``), its containers,
``ParamAttr`` and the initializers, and the common, activation, norm, conv,
pooling, loss, ``extras``, transformer and recurrent layers in the JAX
layout, with their functionals; beam-search decoding (``decode``), the
weight and spectral norm reparameterizations and parameter vectors
(``utils``) and the quantization building blocks (``quant``)."""
from . import functional  # noqa: F401
from . import initializer  # noqa: F401
from .initializer import ParamAttr  # noqa: F401
from .layer import *  # noqa: F401,F403
from .clip import (  # noqa: F401
    ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue, clip_grad_norm_, clip_grad_value_)
from . import utils  # noqa: F401
from . import quant  # noqa: F401
from .decode import BeamSearchDecoder, Decoder, dynamic_decode  # noqa: F401
