"""paddle.base: the port of paddle_tpu/base, the legacy fluid names that old
reference code still imports, each mapped onto the port's own (the static
capture-replay Program and Executor, the framework core, the containers)."""
from torch import Tensor  # noqa: F401

from ..framework import core  # noqa: F401
from ..framework.containers import SelectedRows, StringTensor  # noqa: F401
from ..static import (  # noqa: F401
    CompiledProgram,
    Executor,
    Program,
    default_main_program,
    default_startup_program,
    program_guard,
)


def in_dygraph_mode():
    from .. import in_dynamic_mode

    return in_dynamic_mode()


dygraph = type("dygraph", (), {"base": None})
