"""Layers of the port: ``Linear`` and ``Embedding`` over the port's ops,
``RMSNorm``."""
from .common import Embedding, Linear  # noqa: F401
from .norm import RMSNorm  # noqa: F401
