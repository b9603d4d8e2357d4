"""Layers of the port: ``Layer`` and its containers, and the common,
activation, norm, conv, pooling, loss, extras, transformer and recurrent
layers."""
from . import (activation, common, container, conv, extras, loss, norm,  # noqa: F401
               pooling, rnn, transformer)
from .activation import *  # noqa: F401,F403
from .common import *  # noqa: F401,F403
from .container import *  # noqa: F401,F403
from .conv import *  # noqa: F401,F403
from .extras import *  # noqa: F401,F403
from .layers import HookRemoveHelper, Layer  # noqa: F401
from .loss import *  # noqa: F401,F403
from .norm import *  # noqa: F401,F403
from .pooling import *  # noqa: F401,F403
from .rnn import *  # noqa: F401,F403
from .transformer import *  # noqa: F401,F403

__all__ = (["Layer"] + activation.__all__ + common.__all__ + container.__all__
           + conv.__all__ + extras.__all__ + loss.__all__ + norm.__all__ + pooling.__all__
           + rnn.__all__ + transformer.__all__)
