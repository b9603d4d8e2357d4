"""Counterpart of paddle_tpu.incubate.nn: the fused functionals and the
fused transformer layers."""
from . import functional  # noqa: F401
from .layer_fused import (  # noqa: F401,E402
    FusedBiasDropoutResidualLayerNorm,
    FusedDropoutAdd,
    FusedFeedForward,
    FusedLinear,
    FusedMultiHeadAttention,
    FusedMultiTransformer,
    FusedTransformerEncoderLayer,
)
