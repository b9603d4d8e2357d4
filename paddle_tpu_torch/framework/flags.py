"""Global FLAGS registry: the port of ``paddle_tpu/framework/flags.py``.

The same table, environment pickup at import and ``set_flags``/``get_flags``
as the JAX package. Flags the port reads: ``check_nan_inf`` and
``check_nan_inf_level`` (the op dispatch's NaN/Inf scan, ``ops/_apply.py``
and ``amp/debugging.py``). Every other flag is accepted and kept for paddle
scripts that set and read it, with no effect on torch: among them
``eager_cached_vjp`` (torch's autograd records every op; there is no VJP
cache), ``tpu_matmul_precision`` (torch's matmul precision is
``torch.backends``' own), ``use_stride_kernel``, the allocator flags and the
reference's CUDA flags. ``set_flags`` on an unknown flag defines it, as in
the JAX package.
"""
from __future__ import annotations

import os
from typing import Any, Dict

_REGISTRY: Dict[str, dict] = {}
# bumped on every set_flags, as in the JAX package
_EPOCH = [0]


def epoch() -> int:
    return _EPOCH[0]


def define_flag(name: str, default: Any, doc: str = ""):
    if not name.startswith("FLAGS_"):
        name = "FLAGS_" + name
    value = default
    env = os.environ.get(name)
    if env is not None:
        value = _parse(env, type(default))
    _REGISTRY[name] = {"value": value, "default": default, "doc": doc, "type": type(default)}
    return value


def _parse(text: str, ty):
    if ty is bool:
        return text.lower() in ("1", "true", "yes", "on")
    if ty in (int, float):
        return ty(text)
    return text


def set_flags(flags: Dict[str, Any]):
    _EPOCH[0] += 1
    for k, v in flags.items():
        if not k.startswith("FLAGS_"):
            k = "FLAGS_" + k
        if k not in _REGISTRY:
            define_flag(k, v)
        else:
            _REGISTRY[k]["value"] = _parse(v, _REGISTRY[k]["type"]) if isinstance(v, str) else v


def get_flags(flags):
    if isinstance(flags, str):
        flags = [flags]
    out = {}
    for k in flags:
        key = k if k.startswith("FLAGS_") else "FLAGS_" + k
        if key not in _REGISTRY:
            raise KeyError(f"Unknown flag {k}")
        out[k] = _REGISTRY[key]["value"]
    return out


def flag(name: str):
    key = name if name.startswith("FLAGS_") else "FLAGS_" + name
    return _REGISTRY[key]["value"]


def exported_flags() -> Dict[str, dict]:
    return dict(_REGISTRY)


define_flag("check_nan_inf", False, "scan op outputs for NaN/Inf after each eager op")
define_flag("check_nan_inf_level", 0, "0: error on nan/inf; >0: print statistics only")
define_flag("use_stride_kernel", True, "accepted; torch's views are its own")
define_flag("eager_delete_tensor_gb", 0.0, "accepted; torch's caching allocator manages memory")
define_flag("allocator_strategy", "auto_growth", "accepted; torch's caching allocator")
define_flag("tpu_matmul_precision", "default",
            "accepted; torch.backends sets the matmul precision on the card")
define_flag("embedding_deterministic", 0, "accepted for API parity")
define_flag("cudnn_deterministic", False, "accepted for API parity")
define_flag("max_inplace_grad_add", 0, "accepted for API parity")
define_flag("log_level", 0, "verbosity of host-side logging")
define_flag("eager_cached_vjp", True,
            "accepted; torch's autograd records each op, there is no VJP cache")

# Reference flags accepted for parity (paddle/common/flags.cc), with the
# reference defaults and no effect here
for _name, _default in [
    ("benchmark", False), ("check_kernel_launch", False),
    ("conv2d_disable_cudnn", False), ("conv_workspace_size_limit", 512),
    ("cublaslt_exhaustive_search_times", 0), ("cudnn_batchnorm_spatial_persistent", False),
    ("cudnn_exhaustive_search", False), ("cudnn_exhaustive_search_times", -1),
    ("enable_cublas_tensor_op_math", False), ("embedding_deterministic_level", 0),
    ("gemm_use_half_precision_compute_type", False),
    ("gpu_allocator_retry_time", 2000), ("gpu_memory_limit_mb", 0),
    ("fraction_of_gpu_memory_to_use", 0.92), ("initial_gpu_memory_in_mb", 0),
    ("reallocate_gpu_memory_in_mb", 0), ("fraction_of_cpu_memory_to_use", 1.0),
    ("init_allocated_mem", False), ("memory_fraction_of_eager_deletion", 1.0),
    ("fast_eager_deletion_mode", True), ("use_pinned_memory", True),
    ("use_cuda_managed_memory", False), ("use_virtual_memory_auto_growth", False),
    ("free_idle_chunk", False), ("free_when_no_cache_hit", False),
    ("enable_cudnn_frontend", False), ("cudnn_cache_saturation_count", 1),
    ("low_precision_op_list", 0), ("enable_api_kernel_fallback", True),
    ("use_mkldnn", False), ("use_autotune", False),
    ("inner_op_parallelism", 0), ("enable_parallel_graph", False),
    ("sync_nccl_allreduce", True), ("nccl_blocking_wait", False),
    ("fuse_parameter_groups_size", 3), ("fuse_parameter_memory_size", -1.0),
    ("apply_pass_to_program", False), ("convert_all_blocks", True),
    ("new_executor_serial_run", False), ("new_executor_static_build", False),
    ("new_executor_use_inplace", False), ("new_executor_use_local_scope", True),
    ("enable_pir_api", False), ("enable_pir_in_executor", False),
    ("print_ir", False), ("call_stack_level", 1),
    ("check_nan_inf_op_list", ""), ("skip_nan_inf_op_list", ""),
    ("tracer_mkldnn_ops_on", ""), ("tracer_mkldnn_ops_off", ""),
    ("prim_all", False), ("prim_backward", False), ("prim_forward", False),
    ("set_to_1d", True), ("jit_engine_type", "PE"),
    ("multiple_of_cupti_buffer_size", 1), ("enable_gpu_memory_usage_log", False),
    ("allreduce_record_one_event", False), ("rpc_retry_times", 3),
    ("rpc_deadline", 180000), ("eager_communication_connection", False),
    ("dynamic_static_unified_comm", True), ("enable_async_trace", False),
    ("flash_attn_version", 2), ("cudnn_deterministic_level", 0),
]:
    define_flag(_name, _default, "accepted for reference parity (flags.cc)")
del _name, _default
