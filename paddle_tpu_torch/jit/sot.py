"""Mid-function graph breaks: compiled segments around host reads.

Counterpart of ``paddle_tpu/jit/sot.py``. The JAX package records a broken
signature's ops on its tape, cuts them at the host reads and compiles each
run between reads, guarded on the values read. Dynamo does this natively:
at a construct it cannot trace (``.item()``, ``float(t)``, ``if t:``) it
compiles the traced prefix as one graph, runs the construct eagerly and
resumes tracing in a new frame, whose graph is guarded on what the eager part
produced. So a broken signature here is ``torch.compile(fullgraph=False)``:

* graph-prefix, host read, graph-suffix: each graph goes to the backend, and
  ``CountingBackend`` counts them (``compiled_segment_count``);
* Dynamo's guards take the place of the exact-value guards: a read that
  takes the other branch compiles that branch's resume graph once, and a
  float read whose value drifts recompiles until Dynamo's ``recompile_limit``
  (8, the JAX package's ``MAX_VARIANTS``), after which that frame runs
  eagerly;
* gradients flow through the segments (each is an AOTAutograd function);
* parameters are graph inputs, so a replay reads their live values.

Dynamo may cut a function into more graphs than the JAX tape does (a resume
frame per break and per branch taken), so a segment count is compared with
JAX's as ">= 2", never exactly.
"""
from __future__ import annotations

import warnings

import torch

from ..analysis import sanitizers as _sanitizers


class CountingBackend:
    """A ``torch.compile`` backend that counts the graphs Dynamo hands it and
    compiles each with ``backend`` (a name Dynamo knows, or a callable).
    With ``label`` and the recompile sanitizer on, every graph is one
    ``note_compile(label)``: a guard whose value drifts captures a graph per
    call, which is exactly a recompile storm (the JAX package notes each
    segment-variant capture the same way)."""

    def __init__(self, backend, label=None):
        self.backend = backend
        self.graphs = 0
        self.label = label

    def __call__(self, gm, example_inputs):
        if self.label is not None and _sanitizers._state.recompile:
            _sanitizers.note_compile(self.label, signature=f"graph#{self.graphs}")
        self.graphs += 1
        backend = self.backend
        if isinstance(backend, str):
            backend = torch._dynamo.lookup_backend(backend)
        return backend(gm, example_inputs)


def warn_graph_break(function, err):
    """The one warning a signature gives when it graph-breaks (as JAX's)."""
    reason = str(err).strip().splitlines()[0] if str(err).strip() else type(err).__name__
    warnings.warn(
        f"to_static: graph break in {getattr(function, '__name__', '?')} ({reason}); "
        "this signature runs as compiled segments around the host read (check "
        "compiled_segment_counts()). Other signatures stay whole-compiled. Use "
        "torch.where / torch.cond for fully-compiled control flow, or "
        "full_graph=True to make this an error.", stacklevel=3)


class SegmentedFunction:
    """One graph-broken signature: the function under ``torch.compile``
    without ``fullgraph``, its graphs counted."""

    def __init__(self, function, backend, label=None):
        self._function = function
        self._backend = CountingBackend(backend, label)
        self._compiled = torch.compile(function, fullgraph=False, dynamic=False,
                                       backend=self._backend)

    def __call__(self, *args, **kwargs):
        return self._compiled(*args, **kwargs)

    @property
    def compiled_segment_count(self):
        """Graphs compiled for this signature (diagnostics)."""
        return self._backend.graphs
