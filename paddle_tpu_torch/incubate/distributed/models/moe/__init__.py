"""paddle.incubate.distributed.models.moe: the port of the JAX package's MoE
layer, its gates and its gradient clip."""
from .gate import BaseGate, GShardGate, NaiveGate, SwitchGate  # noqa: F401
from .grad_clip import ClipGradForMOEByGlobalNorm  # noqa: F401
from .moe_layer import MoELayer  # noqa: F401
