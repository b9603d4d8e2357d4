"""paddle.incubate.distributed: the port of paddle_tpu/incubate/distributed
(the MoE layer under ``models.moe``)."""
from . import models  # noqa: F401
