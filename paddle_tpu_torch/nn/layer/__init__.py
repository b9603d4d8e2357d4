"""Layers of the port; Linear and Embedding are torch.nn's own."""
from .norm import RMSNorm  # noqa: F401
