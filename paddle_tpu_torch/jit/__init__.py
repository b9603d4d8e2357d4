"""paddle_tpu_torch.jit: ``to_static``, the port of ``paddle_tpu/jit/``
(python/paddle/jit).

``to_static`` compiles a function or a Module's forward into one cached
program per input signature through Dynamo and Inductor (``torch.compile``),
the hand-written kernels reaching the compiled graphs as ``torch.library``
ops. ``sot.py`` holds the graph-break contract (``full_graph=False``).
``_cuda_graph.py`` holds the CUDA-graph programs the serving and decode
engines capture in place of the JAX engines' internal ``jax.jit`` programs.
``serialization.py`` holds ``save``, ``load`` and ``TranslatedLayer``: a
layer's eval forward exported with ``torch.export`` as a pure function of
(state, inputs), the kernels kept in it as their ``torch.library`` ops, the
weights once in ``.pdiparams`` (``paddle_tpu_torch.inference`` serves such a
program compiled per input shape).

With the monitor on, ``to_static`` counts its compiles and cache hits
(``paddle_tpu_jit_*``) and, with tracing on, records a ``jit.compile`` span
per signature miss; the recompile sanitizer counts every miss and every
graph-broken capture (``analysis/sanitizers.py``), as in the JAX package.
"""
from .api import (  # noqa: F401
    InputSpec,
    StaticFunction,
    enable_to_static,
    ignore_module,
    not_to_static,
    to_static,
)
from .serialization import TranslatedLayer, load, save  # noqa: F401

_LOG_STATE = {"verbosity": 0, "code_level": 0}


def set_verbosity(level=0, also_to_stdout=False):
    """jit logging verbosity knob (kept, as the JAX package keeps it)."""
    _LOG_STATE["verbosity"] = int(level)


def set_code_level(level=100, also_to_stdout=False):
    """jit generated-code dump level (kept, as the JAX package keeps it)."""
    _LOG_STATE["code_level"] = int(level)
