"""paddle.static.amp: mixed precision for the capture-replay static graph (the
port of paddle_tpu/static/amp.py).

A captured Program replays through the eager dispatch, which carries the AMP
cast (``ops/_apply.py``), so static AMP needs no program rewrite:
``decorate`` tags the Program, ``Executor.run`` replays its recorded forward
under ``amp.auto_cast`` with the lists given (O2 float16 also with master
gradients on), and the train hook becomes scale-loss, backward, unscale and
the dynamic-loss-scale step of ``amp.GradScaler`` (float16 only: bfloat16
needs no loss scaling). As in eager AMP, only the port's ops are cast; torch
operators in the recorded program replay as they were written.
"""
from __future__ import annotations

import contextlib

import torch

from ..framework import PARAM_EPOCH
from ..framework import capture
from ..framework import dtype as dtype_mod

__all__ = [
    "decorate", "AutoMixedPrecisionLists", "CustomOpLists",
    "cast_model_to_fp16", "cast_parameters_to_fp16", "fp16_guard", "bf16",
]


class AutoMixedPrecisionLists:
    """White/black op lists for static AMP, fed to the dygraph auto_cast's
    list machinery (op granularity: ``custom_black_varnames`` is kept)."""

    def __init__(self, custom_white_list=None, custom_black_list=None,
                 custom_black_varnames=None, dtype="float16"):
        self.white_list = set(custom_white_list or ())
        self.black_list = set(custom_black_list or ())
        self.black_varnames = set(custom_black_varnames or ())
        self.dtype = dtype


CustomOpLists = AutoMixedPrecisionLists


class OptimizerWithMixedPrecision:
    """The decorated optimizer: delegates to the inner one and, as a Program
    train hook, runs the AMP train step."""

    def __init__(self, optimizer, amp_lists, level, dtype, init_loss_scaling,
                 incr_every_n_steps, decr_every_n_nan_or_inf, incr_ratio, decr_ratio,
                 use_dynamic_loss_scaling):
        from ..amp.grad_scaler import GradScaler

        self._inner = optimizer
        self._amp_lists = amp_lists or AutoMixedPrecisionLists(dtype=dtype)
        self._level = level
        self._dtype = dtype
        use_scaler = use_dynamic_loss_scaling and dtype == "float16"
        self._scaler = (GradScaler(
            enable=True, init_loss_scaling=init_loss_scaling, incr_ratio=incr_ratio,
            decr_ratio=decr_ratio, incr_every_n_steps=incr_every_n_steps,
            decr_every_n_nan_or_inf=decr_every_n_nan_or_inf) if use_scaler else None)

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def minimize(self, loss, startup_program=None, parameters=None, no_grad_set=None):
        prog = capture.active()
        out = self._inner.minimize(loss, startup_program=startup_program,
                                   parameters=parameters, no_grad_set=no_grad_set)
        if prog is not None:
            prog.retarget_train_hook(self._inner, self)
            prog._amp_ctx = {"level": self._level, "dtype": self._dtype,
                             "lists": self._amp_lists,
                             # float32 master gradients for pure float16
                             "master_grad": self._level == "O2" and self._dtype == "float16"}
        return out

    def amp_init(self, place=None, scope=None, test_program=None, use_fp16_test=False):
        """O2: cast the optimized parameters to the low dtype (the optimizer
        keeps float32 master weights under multi_precision)."""
        if self._level == "O2":
            params = [p for g in self._inner._param_groups for p in g["params"]]
            cast_parameters_to_fp16(place, None, params=params, dtype=self._dtype)
            if self._dtype == "float16":
                # master gradients: the cast parameters take float32 grads
                for p in params:
                    p.grad_dtype = torch.float32
            if hasattr(self._inner, "_multi_precision"):
                self._inner._multi_precision = True

    def _amp_train_step(self, live_loss):
        if self._scaler is not None:
            if live_loss.dtype in (torch.float16, torch.bfloat16):
                # scale in float32: loss * 2**15 would overflow float16
                from ..ops.manipulation import cast

                live_loss = cast(live_loss, "float32")
            self._scaler.scale(live_loss).backward()
            self._scaler.step(self._inner)
            self._scaler.update()
        else:
            live_loss.backward()
            self._inner.step()
        self._inner.clear_grad()

    def step(self):
        self._inner.step()

    def clear_grad(self, set_to_zero=True):
        self._inner.clear_grad(set_to_zero)


def decorate(optimizer, amp_lists=None, init_loss_scaling=2 ** 15, incr_every_n_steps=1000,
             decr_every_n_nan_or_inf=2, incr_ratio=2.0, decr_ratio=0.8,
             use_dynamic_loss_scaling=True, use_pure_fp16=False, use_fp16_guard=None,
             use_bf16=False, use_promote=False, level=None, dtype=None, master_weight=None):
    """Wrap an optimizer for mixed-precision static training: O1 replays
    under the auto_cast lists; O2 (``use_pure_fp16``) also casts the
    parameters through ``amp_init()``."""
    dtype = dtype or ("bfloat16" if use_bf16 else "float16")
    level = level or ("O2" if use_pure_fp16 else "O1")
    if master_weight and hasattr(optimizer, "_multi_precision"):
        optimizer._multi_precision = True
    return OptimizerWithMixedPrecision(
        optimizer, amp_lists, level, dtype, init_loss_scaling, incr_every_n_steps,
        decr_every_n_nan_or_inf, incr_ratio, decr_ratio, use_dynamic_loss_scaling)


def cast_model_to_fp16(program, amp_lists=None, use_fp16_guard=True, dtype="float16",
                       level="O2"):
    """Tag the program: its replay casts under auto_cast."""
    if program is not None:
        program._amp_ctx = {"level": level, "dtype": dtype,
                            "lists": amp_lists or AutoMixedPrecisionLists(dtype=dtype),
                            "master_grad": False}
    return program


def cast_parameters_to_fp16(place=None, program=None, scope=None, to_fp16_var_names=None,
                            dtype="float16", params=None):
    """Cast live float32/float64 parameters to the low dtype in place (each
    keeps its identity)."""
    if params is None and program is not None:
        params = program.all_parameters()
    d = dtype_mod.convert_dtype(dtype)
    with torch.no_grad():
        for p in params or []:
            if to_fp16_var_names and getattr(p, "name", None) not in to_fp16_var_names:
                continue
            if p.dtype in (torch.float32, torch.float64):
                p.data = p.data.to(d)
    PARAM_EPOCH[0] += 1
    return {getattr(p, "name", "") for p in params or []}


@contextlib.contextmanager
def fp16_guard():
    """An ``auto_cast(level="O1", dtype="float16")`` region."""
    from ..amp.auto_cast import auto_cast

    with auto_cast(enable=True, level="O1", dtype="float16"):
        yield


class _BF16Namespace:
    """paddle.static.amp.bf16: the same machinery with bfloat16 and no loss
    scaling."""

    class AutoMixedPrecisionListsBF16(AutoMixedPrecisionLists):
        def __init__(self, custom_bf16_list=None, custom_fp32_list=None,
                     custom_fp32_varnames=None):
            super().__init__(custom_white_list=custom_bf16_list,
                             custom_black_list=custom_fp32_list,
                             custom_black_varnames=custom_fp32_varnames, dtype="bfloat16")

    @staticmethod
    def decorate_bf16(optimizer, amp_lists=None, use_pure_bf16=False, use_bf16_guard=None):
        return decorate(optimizer, amp_lists=amp_lists, use_dynamic_loss_scaling=False,
                        use_pure_fp16=use_pure_bf16, use_bf16=True)

    @staticmethod
    def cast_model_to_bf16(program, amp_lists=None, use_bf16_guard=True):
        return cast_model_to_fp16(program, amp_lists, dtype="bfloat16")

    @staticmethod
    def cast_parameters_to_bf16(place=None, program=None, scope=None, to_bf16_var_names=None):
        return cast_parameters_to_fp16(place, program, scope, to_bf16_var_names,
                                       dtype="bfloat16")

    @staticmethod
    @contextlib.contextmanager
    def bf16_guard():
        from ..amp.auto_cast import auto_cast

        with auto_cast(enable=True, level="O1", dtype="bfloat16"):
            yield


bf16 = _BF16Namespace()
