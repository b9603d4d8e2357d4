"""paddle.inference: Config -> create_predictor -> named handles -> run.

Counterpart of ``paddle_tpu/inference.py``. The Predictor holds a program
saved by ``jit.save`` (``jit.load``'s ``TranslatedLayer``) and runs it
compiled, one program per input signature, as ``jit.to_static`` compiles
(``dynamic=False``): Inductor by default, or AOTAutograd without Inductor's
code generation (``"aot_eager"``) after ``switch_ir_optim(False)``, the
toggle of the reference's graph fusion passes. ``exp_set_warmup_shapes``
compiles those shapes when the Predictor is made, so a ``run`` at a warmed
shape compiles nothing (``Predictor.compiles`` counts the graphs compiled).

The Predictor runs on the card (``enable_use_gpu``'s ``device_id``, else
card 0) and on the CPU only after ``disable_gpu()``. Every other toggle is
recorded as the JAX package records it (``use_gpu()`` reads what was set).
``run(inputs)`` returns numpy arrays, as in JAX; the handles hold tensors on
the program's device, and ``copy_from_cpu``/``copy_to_cpu`` move data there
and back (a bfloat16 output comes back to the host as float32).
"""
from __future__ import annotations

import time
import warnings

import numpy as np
import torch

from . import resolve_device


class PrecisionType:
    Float32 = 0
    Half = 1
    Bfloat16 = 2
    Int8 = 3


class PlaceType:
    CPU = 0
    GPU = 1
    XPU = 2
    CUSTOM = 3


class Config:
    """Predictor configuration (inference_api.cc Config / AnalysisConfig)."""

    def __init__(self, prog_file=None, params_file=None):
        # jit.save artifacts use one path prefix; accept both call shapes
        self.prog_file = prog_file
        self.params_file = params_file
        self._model_dir = prog_file
        self._use_gpu = False
        self._device_id = 0
        self._enable_memory_optim = True
        self._switch_ir_optim = True
        self._cpu_math_threads = 1
        self._precision = PrecisionType.Float32
        self._extra = {}
        # only disable_gpu() sends the Predictor to the CPU
        self._cpu = False

    # -- device toggles -------------------------------------------------------
    def enable_use_gpu(self, memory_pool_init_size_mb=100, device_id=0,
                       precision=PrecisionType.Float32):
        self._use_gpu = True
        self._device_id = device_id
        self._precision = precision
        self._cpu = False

    def disable_gpu(self):
        self._use_gpu = False
        self._cpu = True

    def use_gpu(self):
        return self._use_gpu

    def enable_xpu(self, *a, **k):
        self._extra["xpu"] = True

    def enable_custom_device(self, device_type, device_id=0):
        self._extra["custom_device"] = (device_type, device_id)

    def set_cpu_math_library_num_threads(self, n):
        self._cpu_math_threads = int(n)

    # -- optimization toggles ---------------------------------------------------
    def switch_ir_optim(self, flag=True):
        """On (the default): Inductor compiles the program; off: AOTAutograd
        without Inductor's fusion and code generation."""
        self._switch_ir_optim = bool(flag)

    def enable_memory_optim(self, flag=True):
        self._enable_memory_optim = bool(flag)

    def enable_tensorrt_engine(self, *a, **k):
        self._extra["tensorrt"] = True  # recorded: the compiled program is the engine

    def enable_mkldnn(self):
        self._extra["mkldnn"] = True

    def set_model(self, prog_file, params_file=None):
        self.prog_file = prog_file
        self.params_file = params_file
        self._model_dir = prog_file

    def exp_set_warmup_shapes(self, shapes):
        """Input shapes to compile when the Predictor is made: every run()
        at such a shape reuses that program. Each entry is one input's shape
        tuple, or a (shape, dtype) pair for non-float inputs (e.g. ((1, 128),
        "int64"))."""
        norm = []
        for s in shapes:
            if len(s) == 2 and isinstance(s[1], str):
                norm.append((tuple(s[0]), s[1]))
            else:
                norm.append((tuple(s), "float32"))
        self._extra["warmup_shapes"] = norm

    def model_dir(self):
        return self._model_dir

    def summary(self):
        return (f"Config(model={self._model_dir}, use_gpu={self._use_gpu}, "
                f"ir_optim={self._switch_ir_optim})")

    def _device(self):
        if self._cpu:
            return torch.device("cpu")
        resolve_device(None)  # raises where no card is visible
        return torch.device("cuda", self._device_id)


class _IOHandle:
    """Named input/output tensor handle (ZeroCopyTensor analog) on the
    program's device."""

    def __init__(self, name, device):
        self.name = name
        self._device = device
        self._value = None

    def reshape(self, shape):
        pass  # shapes flow from copy_from_cpu; kept for API parity

    def copy_from_cpu(self, arr):
        self._value = torch.from_numpy(np.asarray(arr, order="C")).to(self._device)

    def copy_to_cpu(self):
        v = self._value.detach()
        if v.dtype == torch.bfloat16:
            v = v.float()
        return v.cpu().numpy()

    def share_external_data(self, arr):
        if isinstance(arr, torch.Tensor):
            self._value = arr.to(self._device)
        else:
            self.copy_from_cpu(arr)


class Predictor:
    """A saved program, compiled (AnalysisPredictor analog). ``run()`` feeds
    the input handles in declaration order, runs the program compiled for
    their signature and fills the output handles."""

    def __init__(self, config: Config):
        from . import jit

        self.config = config
        self._device = config._device()
        t0 = time.perf_counter()
        self._fn = jit.load(config.prog_file, device=self._device)
        #: seconds jit.load took (``warmup_s``: the warmup shapes' compiles and runs)
        self.load_s = time.perf_counter() - t0
        run, state = self._fn._run[0], self._fn._state_vals
        backend = None if config._switch_ir_optim else "aot_eager"
        self._program = jit.to_static(lambda *vals: run(state, *vals), backend=backend)
        names = list(getattr(self._fn, "_input_names", None) or ["input_0"])
        self._inputs = {n: _IOHandle(n, self._device) for n in names}
        self._input_order = names
        self._outputs = []
        self._warmed_shapes = []
        t0 = time.perf_counter()
        for shape, dtype in config._extra.get("warmup_shapes", []):
            try:
                self._warm(shape, dtype)
            except Exception as e:  # noqa: BLE001 - warmup is best-effort:
                # a bad shape/dtype must not abort predictor construction
                warnings.warn(f"predictor warmup for {shape} ({dtype}) "
                              f"failed: {e}", stacklevel=2)
        self.warmup_s = time.perf_counter() - t0

    @property
    def compiles(self):
        """Graphs compiled for this Predictor so far (every signature's)."""
        return sum(backend.graphs for _, backend in self._program._cache.values())

    def _call(self, vals):
        with torch.no_grad():
            return self._program(*vals)

    def _warm(self, shape, dtype="float32"):
        """Compile the program for one input shape. Single-input programs
        only; multi-input programs compile at their first run."""
        if len(self._input_order) != 1:
            raise ValueError(
                "warmup shapes support single-input programs; this program "
                f"takes {len(self._input_order)} inputs")
        sample = torch.zeros(shape, dtype=getattr(torch, dtype), device=self._device)
        self._call([sample])
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)
        self._warmed_shapes.append(tuple(shape))

    def get_input_names(self):
        return list(self._input_order)

    def get_input_handle(self, name):
        return self._inputs[name]

    def run(self, inputs=None):
        """Execute. ``inputs`` (a list of arrays) may bypass the handle API;
        then the outputs come back as numpy arrays."""
        if inputs is not None:
            for n, a in zip(self._input_order, inputs):
                self._inputs[n].copy_from_cpu(a)
        outs = self._call([self._inputs[n]._value for n in self._input_order])
        self._outputs = []
        for i, o in enumerate(outs):
            h = _IOHandle(f"output_{i}", self._device)
            h._value = o
            self._outputs.append(h)
        if inputs is not None:
            return [h.copy_to_cpu() for h in self._outputs]
        return None

    def get_output_names(self):
        return [h.name for h in self._outputs] or ["output_0"]

    def get_output_handle(self, name):
        for h in self._outputs:
            if h.name == name:
                return h
        raise KeyError(name)

    def clear_intermediate_tensor(self):
        pass

    def try_shrink_memory(self):
        if self._device.type == "cuda":
            torch.cuda.empty_cache()


def create_predictor(config: Config) -> Predictor:
    return Predictor(config)


def get_version():
    from . import __version__

    return __version__


__all__ = ["Config", "Predictor", "create_predictor", "PrecisionType",
           "PlaceType", "get_version"]
