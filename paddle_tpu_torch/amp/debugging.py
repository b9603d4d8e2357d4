"""AMP and numerics debugging: the port of ``paddle_tpu/amp/debugging.py``
(reference python/paddle/amp/debugging.py).

The tensor checker sets ``FLAGS_check_nan_inf``; the op dispatch
(``ops/_apply.py``) then scans every floating output of every op it runs
(``_scan_op_outputs``: numsan's all-finite check on the device and one host
read per scanned output, so it is a debug mode, off on every timed path) and raises ``FloatingPointError`` naming the op, or prints with
``CHECK_NAN_INF``. The operator stats count each dispatched op's calls by its
output's dtype ([float16, bfloat16, float32, other]); the table is
``ops/_apply.py``'s ``_OP_STATS`` slot. ``compare_accuracy`` raises, as in
the JAX package.
"""
from __future__ import annotations

import contextlib
import functools
from enum import Enum

import torch

from ..framework import flags
from ..ops._apply import _OP_STATS

__all__ = [
    "DebugMode",
    "TensorCheckerConfig",
    "check_numerics",
    "check_layer_numerics",
    "enable_operator_stats_collection",
    "disable_operator_stats_collection",
    "collect_operator_stats",
    "enable_tensor_checker",
    "disable_tensor_checker",
    "set_checked_op_list",
    "set_skipped_op_list",
    "compare_accuracy",
]


class DebugMode(Enum):
    CHECK_NAN_INF_AND_ABORT = 0
    CHECK_NAN_INF = 1
    CHECK_ALL_FOR_OVERFLOW = 2
    CHECK_ALL = 3


class TensorCheckerConfig:
    """reference debugging.py:173: which ops to scan and what to do on a hit."""

    def __init__(self, enable=True, debug_mode=DebugMode.CHECK_NAN_INF_AND_ABORT,
                 output_dir=None, checked_op_list=None, skipped_op_list=None,
                 debug_step=None, stack_height_limit=1):
        self.enable = enable
        self.debug_mode = debug_mode
        self.output_dir = output_dir
        self.checked_op_list = list(checked_op_list or [])
        self.skipped_op_list = list(skipped_op_list or [])
        self.debug_step = debug_step
        self.stack_height_limit = stack_height_limit


_CHECKED_OPS = [None]   # None = all
_SKIPPED_OPS = [set()]


def set_checked_op_list(checked_op_list):
    _CHECKED_OPS[0] = set(checked_op_list) if checked_op_list else None


def set_skipped_op_list(skipped_op_list):
    _SKIPPED_OPS[0] = set(skipped_op_list or [])


def _op_filter(op_name):
    if op_name in _SKIPPED_OPS[0]:
        return False
    if _CHECKED_OPS[0] is not None and op_name not in _CHECKED_OPS[0]:
        return False
    return True


def _scan_op_outputs(name, vals):
    """The per-op scan behind ``FLAGS_check_nan_inf``: numsan's device-side
    all-finite check (``analysis/numerics.py``) and one host read per
    floating output. For step-boundary coverage without the per-op read,
    enable the numerics sanitizer instead (``PADDLE_TPU_SANITIZE=numerics``)."""
    if not _op_filter(name):
        return
    from ..analysis import numerics as _num

    for v in vals:
        if (v.is_floating_point() or v.is_complex()) and not _num.all_finite(v):
            if flags.flag("check_nan_inf_level") > 0:
                print(f"[paddle_tpu_torch] nan/inf detected in output of op {name}")
            else:
                raise FloatingPointError(f"nan/inf detected in output of op {name}")


def enable_tensor_checker(checker_config: TensorCheckerConfig):
    """Turn on the per-op NaN/Inf scan (reference debugging.py:653)."""
    if not checker_config.enable:
        return
    set_checked_op_list(checker_config.checked_op_list or None)
    set_skipped_op_list(checker_config.skipped_op_list)
    level = (0 if checker_config.debug_mode
             == DebugMode.CHECK_NAN_INF_AND_ABORT else 1)
    flags.set_flags({"check_nan_inf": True, "check_nan_inf_level": level})


def disable_tensor_checker():
    flags.set_flags({"check_nan_inf": False})
    set_checked_op_list(None)
    set_skipped_op_list(None)


def tensor_stats(x):
    """(num_nan, num_inf, num_zero, min, max, mean) of a tensor: the stats
    row the reference prints per offending tensor."""
    vf = torch.as_tensor(x).detach().to(torch.float32)
    finite = torch.isfinite(vf)
    n_finite = int(finite.sum())
    return {
        "num_nan": int(torch.isnan(vf).sum()),
        "num_inf": int(torch.isinf(vf).sum()),
        "num_zero": int((vf == 0).sum()),
        "min": float(vf[finite].min()) if n_finite else None,
        "max": float(vf[finite].max()) if n_finite else None,
        "mean": float(vf[finite].sum() / max(n_finite, 1)) if n_finite else None,
    }


def check_numerics(tensor, op_type="", var_name="", debug_mode=None,
                   stack_height_limit=1):
    """Scan one tensor; raise (abort mode) or print stats (reference :361)."""
    stats = tensor_stats(tensor)
    if stats["num_nan"] > 0 or stats["num_inf"] > 0:
        msg = (f"[check_numerics] op={op_type or '?'} var={var_name or '?'} "
               f"nan={stats['num_nan']} inf={stats['num_inf']} "
               f"zero={stats['num_zero']} min={stats['min']} max={stats['max']}")
        if debug_mode in (None, DebugMode.CHECK_NAN_INF_AND_ABORT):
            raise FloatingPointError(msg)
        print(msg)
    return stats


def check_layer_numerics(func):
    """Decorator: scan a layer's tensor inputs and outputs (reference :78)."""

    @functools.wraps(func)
    def wrapper(self, *args, **kwargs):
        for i, a in enumerate(args):
            if isinstance(a, torch.Tensor):
                check_numerics(a, op_type=type(self).__name__, var_name=f"input{i}")
        out = func(self, *args, **kwargs)
        outs = out if isinstance(out, (tuple, list)) else (out,)
        for i, o in enumerate(outs):
            if isinstance(o, torch.Tensor):
                check_numerics(o, op_type=type(self).__name__, var_name=f"output{i}")
        return out

    return wrapper


def enable_operator_stats_collection():
    """Count op calls by output dtype (reference :480)."""
    _OP_STATS[0] = {}


def disable_operator_stats_collection():
    table = _OP_STATS[0]
    _OP_STATS[0] = None
    if table:
        _print_operator_stats(table)
    return table


def _print_operator_stats(table):
    print("<" + "-" * 86 + ">")
    print(f"{'Op Name':<40} {'FP16':>10} {'BF16':>10} {'FP32':>10} {'Other':>10}")
    for name in sorted(table):
        f16, bf16, f32, other = table[name]
        print(f"{name:<40} {f16:>10} {bf16:>10} {f32:>10} {other:>10}")
    print("<" + "-" * 86 + ">")


@contextlib.contextmanager
def collect_operator_stats():
    """Context form (reference :559)."""
    enable_operator_stats_collection()
    try:
        yield
    finally:
        disable_operator_stats_collection()


def operator_stats():
    """Live view of the current collection (None when disabled)."""
    return _OP_STATS[0]


def compare_accuracy(dump_path, another_dump_path, output_filename,
                     loss_scale=1, dump_all_tensors=False):
    """Reference :594 compares two runs' tensor dump directories; neither
    package writes such dumps, so this raises as the JAX package does."""
    raise NotImplementedError(
        "compare_accuracy requires the tensor-dump workflow; use "
        "paddle_tpu_torch.amp.debugging.tensor_stats / check_numerics instead")
