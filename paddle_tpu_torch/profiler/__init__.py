"""paddle.profiler: the port of ``paddle_tpu/profiler/`` (host spans, the
card's kernels through torch.profiler, the summary tables and the
throughput timer). Reference: python/paddle/profiler/__init__.py.
"""
from .profiler import (  # noqa: F401
    Profiler, ProfilerResult, ProfilerState, ProfilerTarget, RecordEvent,
    SummaryView, TracerEventType, export_chrome_tracing, export_protobuf,
    get_profiler, load_profiler_result, make_scheduler,
)
from .profiler_statistic import SortedKeys  # noqa: F401
from .timer import Benchmark, benchmark  # noqa: F401

__all__ = [
    "Profiler", "ProfilerResult", "ProfilerState", "ProfilerTarget",
    "RecordEvent", "TracerEventType", "SummaryView", "SortedKeys",
    "export_chrome_tracing", "export_protobuf", "get_profiler",
    "load_profiler_result", "make_scheduler", "benchmark", "Benchmark",
]
