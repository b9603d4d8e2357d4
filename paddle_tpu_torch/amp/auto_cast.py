"""AMP auto-cast: the port of ``paddle_tpu/amp/auto_cast.py``.

Inside ``auto_cast`` the op dispatch (``ops/_apply.py``) calls
``amp_cast_inputs`` on every op: O1 casts the floating inputs of white-list
ops (and ``amp_category="white"``) to the low dtype and those of black-list
ops (and ``"black"``) to float32, and leaves the rest; O2 casts every op's
floating inputs to the low dtype but the black list's, which go to float32.
A custom white entry overrides the black list. ``cast`` itself and
``amp_category="skip"`` ops are never cast. Each cast is the ``cast`` op, so
its gradient casts back and the operator stats count it, as in the JAX
package. Only tensors that reach an op of the port are cast: torch code
called directly is outside the dispatch.

``decorate`` at O2 casts the float32 parameters of the models to the low
dtype in place (each ``Parameter`` keeps its identity, name, ``need_clip``
and ``optimize_attr``) and turns the optimizers' float32 master weights on;
it must run before an optimizer's first step. Programs captured before it on
the old weights (the decode engines' CUDA graphs) refuse to replay
(``jit/_cuda_graph.py``); ``jit.to_static`` compiles again on the new dtype.
"""
from __future__ import annotations

import contextlib

import torch

from ..framework import PARAM_EPOCH
from ..framework import dtype as dtype_mod
from ..ops import _apply
from ..ops.manipulation import cast
from . import amp_lists

_STATE = _apply._AMP_STATE


class _AmpState:
    __slots__ = ("enable", "dtype", "level", "custom_white", "custom_black")

    def __init__(self, enable, dtype, level, custom_white, custom_black):
        self.enable = enable
        self.dtype = dtype_mod.convert_dtype(dtype)
        self.level = level
        self.custom_white = frozenset(custom_white or [])
        self.custom_black = frozenset(custom_black or [])


def _amp_state():
    return _STATE[-1] if _STATE else None


def amp_state():
    return _amp_state()


def _cast_leaves(obj, target):
    if isinstance(obj, torch.Tensor):
        if obj.is_floating_point() and obj.dtype != target:
            return cast(obj, target)
        return obj
    if isinstance(obj, (tuple, list)):
        return type(obj)(_cast_leaves(x, target) for x in obj)
    if isinstance(obj, dict):
        return {k: _cast_leaves(v, target) for k, v in obj.items()}
    return obj


def amp_cast_inputs(opdef, args, kwargs):
    state = _STATE[-1]
    if not state.enable:
        return args, kwargs
    name = opdef.name
    if name == "cast" or opdef.amp_category == "skip":
        # dtype-control ops are never themselves AMP-cast: under O2 the cast
        # of cast's input would recurse
        return args, kwargs
    white = (name in amp_lists.WHITE_LIST or name in state.custom_white
             or opdef.amp_category == "white")
    black = (name in amp_lists.BLACK_LIST or name in state.custom_black
             or opdef.amp_category == "black")
    if name in state.custom_white:
        black = False
    if state.level == "O2":
        target = torch.float32 if black else state.dtype
    elif white and not black:
        target = state.dtype
    elif black:
        target = torch.float32
    else:
        return args, kwargs
    return _cast_leaves(args, target), _cast_leaves(kwargs, target)


_apply._AMP_CAST[0] = amp_cast_inputs


@contextlib.contextmanager
def _entered(state):
    """Run with ``state`` on top of the stack (the recompute of a segment
    that ran under it)."""
    _STATE.append(state)
    try:
        yield
    finally:
        _STATE.pop()


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None, level="O1",
              dtype="float16", use_promote=True):
    """paddle.amp.auto_cast (python/paddle/amp/auto_cast.py:1006)."""
    if level not in ("O0", "O1", "O2", "OD"):
        raise ValueError(f"level must be O0/OD/O1/O2, got {level}")
    if level == "O0":
        enable = False
    state = _AmpState(enable, dtype, "O1" if level == "OD" else level,
                      custom_white_list, custom_black_list)
    with _entered(state):
        yield


amp_guard = auto_cast


def decorate(models, optimizers=None, level="O1", dtype="float16", master_weight=None,
             save_dtype=None, master_grad=False, excluded_layers=None):
    """paddle.amp.decorate (auto_cast.py:1091): O2 casts the models' float32
    parameters to ``dtype`` in place and lets the optimizers keep float32
    master weights."""
    if master_grad:
        raise NotImplementedError(
            "decorate(master_grad=True) is not ported: the JAX tape reruns every "
            "reduced-precision pullback in float32, which needs a float32 backward "
            "for every op (ROADMAP Queue A item 6)")
    single_model = not isinstance(models, (list, tuple))
    model_list = [models] if single_model else list(models)
    opt_list = ([] if optimizers is None else
                list(optimizers) if isinstance(optimizers, (list, tuple)) else [optimizers])
    if level == "O2":
        for opt in opt_list:
            if getattr(opt, "_accumulators", None) or getattr(opt, "_step_count", 0):
                raise RuntimeError(
                    "amp.decorate(level='O2') must run before the optimizer's first "
                    "step: its state was made from the float32 parameters")
        d = dtype_mod.convert_dtype(dtype)
        with torch.no_grad():
            for m in model_list:
                for p in m.parameters():
                    if p.dtype == torch.float32:
                        p.data = p.data.to(d)
                        if p.grad is not None:
                            p.grad = p.grad.to(d)
        PARAM_EPOCH[0] += 1
        for opt in opt_list:
            if hasattr(opt, "_multi_precision"):
                opt._multi_precision = True if master_weight is None else bool(master_weight)
        _amp_global_state.use_master_grad = False
    if optimizers is None:
        return models
    return models, optimizers


def is_auto_cast_enabled():
    s = _amp_state()
    return bool(s and s.enable)


def get_amp_dtype():
    s = _amp_state()
    return dtype_mod.dtype_name(s.dtype) if s else "float32"


class AMPGlobalState:
    """Mirror of amp/auto_cast.py:122 AMPGlobalState (master-grad bookkeeping)."""

    def __init__(self):
        self.model_parameters = []
        self.use_master_grad = False
        self.already_register_final_backward_hook = False


_amp_global_state = AMPGlobalState()


def amp_global_state():
    return _amp_global_state
