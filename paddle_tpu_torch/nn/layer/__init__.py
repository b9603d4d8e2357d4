"""Layers of the port: ``Layer`` and its containers, ``Linear`` and
``Embedding``, and the activation, norm and loss layers."""
from . import activation, container, loss, norm
from .activation import *  # noqa: F401,F403
from .common import Embedding, Linear  # noqa: F401
from .container import *  # noqa: F401,F403
from .layers import HookRemoveHelper, Layer  # noqa: F401
from .loss import *  # noqa: F401,F403
from .norm import *  # noqa: F401,F403

__all__ = (["Layer", "Linear", "Embedding"] + activation.__all__ + container.__all__
           + loss.__all__ + norm.__all__)
