"""paddle_tpu_torch.amp: automatic mixed precision, the port of
``paddle_tpu/amp`` (reference python/paddle/amp): ``auto_cast`` per op
through the dispatch, ``decorate``, ``GradScaler`` and ``debugging``."""
from . import amp_lists  # noqa: F401
from .auto_cast import (  # noqa: F401
    amp_global_state,
    amp_guard,
    amp_state,
    auto_cast,
    decorate,
    get_amp_dtype,
    is_auto_cast_enabled,
)
from .grad_scaler import AmpScaler, GradScaler  # noqa: F401
from . import debugging  # noqa: F401

white_list = amp_lists.white_list
black_list = amp_lists.black_list


def is_bfloat16_supported(device=None):
    """bf16 runs on the H100's tensor cores and on the CPU."""
    return True


def is_float16_supported(device=None):
    """fp16 runs on the H100's tensor cores and on the CPU."""
    return True
