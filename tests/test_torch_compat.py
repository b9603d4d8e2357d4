"""The rest of the op surface: the port's ``ops/compat.py``, the generated
in-place family, ``ops/__init__``'s helpers and constants, against the JAX
package's functions on the same numpy inputs.

Each case is one lambda of the paddle API called with each package as ``P``
(as in tests/test_torch_ops.py). Floating cases run at float32 and float64.
Tolerances: manipulation, integer, boolean and comparison outputs are
compared exactly; floating math at rtol 1e-5 / atol 1e-6 (float32) and
rtol 1e-10 / atol 1e-12 (float64); the special functions (gammaln,
gammainc, gammaincc, multigammaln, polygamma) at rtol 1e-5 (float32) and
1e-10 (float64), atol as the floating math. Returned dtypes must equal the
JAX ones. The samplers are held by their moments (6 standard errors at
2**14 draws), with a seeded determinism check in each package. Gradients of
the differentiable floating cases, of ``sum(out * ct)``, at the float
tolerance.

Also: tests/test_export_surface.py:74-98's straggler and ``no_grad`` cases
on both packages, the JAX in-place tape caveat (ROADMAP Queue C), and the
top-level names the port still lacks, each tagged with the ROADMAP Queue A
item that brings it, and the same for ``nn``, ``nn.functional`` (none left)
and ``models`` (the pipeline-parallel LLaMA); ``__all__`` of ``nn.utils``,
``quantization`` and ``nn.quant`` equal to the JAX modules'.
"""
import json
import math
import os
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as T
from paddle_tpu_torch.device import _CURRENT

TOL = {"float32": (1e-5, 1e-6), "float64": (1e-10, 1e-12)}
SPECIAL_TOL = {"float32": (1e-5, 1e-6), "float64": (1e-10, 1e-12)}
SIGMAS = 6.0
DRAWS = 2 ** 14
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _on_cpu():
    before = _CURRENT[0]
    T.set_device("cpu")
    yield
    _CURRENT[0] = before


# -- input specs: (kind, ...); "float" specs take the case's float dtype ------
def N(*shape):
    return ("normal", shape)


def U(shape, lo, hi):
    return ("uniform", shape, lo, hi)


def I(shape, lo, hi):  # noqa: E743
    return ("int", shape, lo, hi)


def B(*shape):
    return ("bool", shape)


def A(arr, float_=True):
    return ("array", np.asarray(arr), float_)


def _make(spec, rng, fdt):
    kind = spec[0]
    if kind == "normal":
        return rng.standard_normal(spec[1]).astype(fdt)
    if kind == "uniform":
        return rng.uniform(spec[2], spec[3], spec[1]).astype(fdt)
    if kind == "int":
        return rng.randint(spec[2], spec[3], spec[1]).astype(np.int64)
    if kind == "bool":
        return rng.rand(*spec[1]) > 0.5
    return spec[1].astype(fdt) if spec[2] else spec[1]


EXACT, FLOAT, SPECIAL = "exact", "float", "special"


def C(name, fn, inputs=(), kind=FLOAT, grad=False, floats=True):
    """``floats``: run at float32 and float64 (False: the inputs' own dtypes)."""
    return pytest.param(fn, inputs, kind, grad, floats, id=name)


CASES = [
    # ---- stacking and splitting ----
    C("add_n", lambda P, a, b, c: P.add_n([a, b, c]), [N(2, 3), N(2, 3), N(2, 3)], grad=True),
    C("add_n_int", lambda P, a, b: P.add_n([a, b]), [I((3,), -5, 5), I((3,), -5, 5)], EXACT,
      floats=False),
    C("hstack_1d", lambda P, a, b: P.hstack([a, b]), [N(3), N(2)], EXACT, grad=True),
    C("hstack_2d", lambda P, a, b: P.hstack([a, b]), [N(2, 3), N(2, 1)], EXACT),
    C("hstack_0d", lambda P, a, b: P.hstack([a, b]), [A(1.5), A(-2.0)], EXACT),
    C("vstack", lambda P, a, b: P.vstack([a, b]), [N(3), N(2, 3)], EXACT, grad=True),
    C("row_stack", lambda P, a, b: P.row_stack([a, b]), [N(2, 2), N(1, 2)], EXACT),
    C("column_stack", lambda P, a, b: P.column_stack([a, b]), [N(3), N(3, 2)], EXACT),
    C("dstack", lambda P, a, b, c: P.dstack([a, b, c]), [N(3), N(1, 3), N(1, 3, 2)], EXACT),
    C("dstack_int", lambda P, a, b: P.dstack([a, b]), [I((2, 2), 0, 9), I((2, 2), 0, 9)],
      EXACT, floats=False),
    C("hsplit", lambda P, x: P.hsplit(x, 2), [N(4, 6)], EXACT),
    C("hsplit_indices", lambda P, x: P.hsplit(x, [1, 4]), [N(2, 6)], EXACT),
    C("hsplit_1d", lambda P, x: P.hsplit(x, 3), [N(6)], EXACT),
    C("vsplit", lambda P, x: P.vsplit(x, [1]), [N(4, 3)], EXACT),
    C("dsplit", lambda P, x: P.dsplit(x, 2), [N(2, 2, 4)], EXACT),
    C("block_diag", lambda P, a, b, c: P.block_diag([a, b, c]), [N(2, 2), N(1, 3), N(3)],
      EXACT, grad=True),
    C("block_diag_int", lambda P, a, b: P.block_diag([a, b]), [I((2, 2), 0, 9), I((1,), 0, 9)],
      EXACT, floats=False),
    C("cartesian_prod", lambda P, a, b: P.cartesian_prod([a, b]), [N(3), N(2)], EXACT,
      grad=True),
    C("cartesian_prod_one", lambda P, a: P.cartesian_prod([a]), [N(3)], EXACT),
    C("cartesian_prod_int", lambda P, a, b, c: P.cartesian_prod([a, b, c]),
      [I((2,), 0, 9), I((3,), 0, 9), I((2,), 0, 9)], EXACT, floats=False),
    C("combinations", lambda P, x: P.combinations(x, 2), [N(4)], EXACT),
    C("combinations_r3_replacement",
      lambda P, x: P.combinations(x, 3, with_replacement=True), [I((3,), 0, 9)], EXACT,
      floats=False),
    # ---- scatters and views ----
    C("diagonal_scatter", lambda P, x, y: P.diagonal_scatter(x, y), [N(3, 4), N(3)], EXACT,
      grad=True),
    C("diagonal_scatter_offset", lambda P, x, y: P.diagonal_scatter(x, y, offset=1),
      [N(3, 4), N(3)], EXACT),
    C("diagonal_scatter_negative", lambda P, x, y: P.diagonal_scatter(x, y, offset=-1),
      [N(3, 4), N(2)], EXACT),
    C("diagonal_scatter_axes", lambda P, x, y: P.diagonal_scatter(x, y, 0, 2, 0),
      [N(3, 2, 3), N(2, 3)], EXACT),
    C("select_scatter", lambda P, x, v: P.select_scatter(x, v, 0, 1), [N(3, 4), N(4)], EXACT,
      grad=True),
    C("select_scatter_last", lambda P, x, v: P.select_scatter(x, v, 1, -1), [N(3, 4), N(3)],
      EXACT),
    C("slice_scatter", lambda P, x, v: P.slice_scatter(x, v, [1], [1], [5], [2]),
      [N(4, 6), N(4, 2)], EXACT, grad=True),
    C("slice_scatter_2axes", lambda P, x, v: P.slice_scatter(x, v, [0, 1], [0, 2], [2, 4],
                                                            [1, 1]), [N(3, 5), N(2, 2)], EXACT),
    C("take_raise_clips", lambda P, x, i: P.take(x, i), [N(3, 4), A([0, 5, -1, 11, 40, -30],
                                                                    False)], EXACT, grad=True),
    C("take_clip", lambda P, x, i: P.take(x, i, mode="clip"), [N(3, 4), I((6,), -20, 20)],
      EXACT),
    C("take_wrap", lambda P, x, i: P.take(x, i, mode="wrap"), [N(3, 4), I((2, 3), -30, 30)],
      EXACT),
    C("take_int", lambda P, x, i: P.take(x, i), [I((5,), 0, 9), I((3,), -5, 5)], EXACT,
      floats=False),
    C("unflatten", lambda P, x: P.unflatten(x, 1, [2, 3]), [N(2, 6)], EXACT),
    C("unflatten_negative", lambda P, x: P.unflatten(x, -1, [2, -1]), [N(2, 6)], EXACT),
    C("unfold", lambda P, x: P.unfold(x, 1, 3, 2), [N(4, 5)], EXACT, grad=True),
    C("unfold_axis0", lambda P, x: P.unfold(x, 0, 2, 1), [N(4, 3)], EXACT),
    C("reverse", lambda P, x: P.reverse(x, [0]), [N(3, 4)], EXACT),
    C("matrix_transpose", lambda P, x: P.matrix_transpose(x), [N(2, 3, 4)], EXACT),
    # ---- math ----
    C("vecdot", lambda P, x, y: P.vecdot(x, y), [N(3, 4), N(3, 4)], grad=True),
    C("tensordot", lambda P, x, y: P.tensordot(x, y, 2), [N(2, 3, 4), N(3, 4, 5)], grad=True),
    C("tensordot_lists", lambda P, x, y: P.tensordot(x, y, [[1, 2], [0, 1]]),
      [N(2, 3, 4), N(3, 4, 2)]),
    C("tensordot_pair", lambda P, x, y: P.tensordot(x, y, [1, 0]), [N(2, 3), N(3, 4)]),
    C("tensordot_int", lambda P, x, y: P.tensordot(x, y, 1), [I((2, 3), -3, 3),
                                                             I((3, 2), -3, 3)],
      EXACT, floats=False),
    C("cdist", lambda P, x, y: P.cdist(x, y), [N(3, 4), N(5, 4)], grad=True),
    C("cdist_p1", lambda P, x, y: P.cdist(x, y, p=1.0), [N(3, 4), N(5, 4)], grad=True),
    C("cdist_p3_batched", lambda P, x, y: P.cdist(x, y, p=3.0), [N(2, 3, 4), N(2, 2, 4)]),
    C("pdist", lambda P, x: P.pdist(x), [N(5, 3)], grad=True),
    C("pdist_p1", lambda P, x: P.pdist(x, p=1.0), [N(4, 2)]),
    C("sinc", lambda P, x: P.sinc(x), [A([0.0, 0.5, -1.5, 2.0, 0.25])], grad=True),
    C("sinc_small", lambda P, x: P.sinc(x), [A([1e-3, -2e-4, 1e-6])]),
    C("sinc_normal", lambda P, x: P.sinc(x), [N(3, 4)]),
    C("sinc_int", lambda P, x: P.sinc(x), [I((4,), -3, 3)], floats=False),
    C("sgn", lambda P, x: P.sgn(x), [A([-2.0, 0.0, 3.0, -0.5])], EXACT),
    C("sgn_complex", lambda P, x: P.sgn(P.as_complex(x)), [A([[3.0, 4.0], [0.0, 0.0],
                                                             [-1.0, 1.0]])]),
    C("signbit", lambda P, x: P.signbit(x), [A([-2.0, -0.0, 0.0, 3.0, -np.inf])], EXACT),
    C("signbit_int", lambda P, x: P.signbit(x), [I((5,), -3, 3)], EXACT, floats=False),
    C("positive", lambda P, x: P.positive(x), [N(3)], EXACT, grad=True),
    C("frexp", lambda P, x: P.frexp(x), [A([0.0, 1.0, -3.5, 1e-3, 1024.0, 6.25])], EXACT),
    C("renorm", lambda P, x: P.renorm(x, 2.0, 0, 1.0), [N(3, 4)], grad=True),
    C("renorm_p1_axis1", lambda P, x: P.renorm(x, 1.0, 1, 0.5), [N(3, 4)]),
    C("cumulative_trapezoid", lambda P, y: P.cumulative_trapezoid(y), [N(3, 5)], grad=True),
    C("cumulative_trapezoid_dx", lambda P, y: P.cumulative_trapezoid(y, dx=0.5, axis=0),
      [N(4, 3)]),
    C("cumulative_trapezoid_x", lambda P, y, x: P.cumulative_trapezoid(y, x), [N(2, 5), N(5)]),
    C("cumulative_trapezoid_int", lambda P, y: P.cumulative_trapezoid(y),
      [I((2, 4), -5, 5)], floats=False),
    C("histogram_bin_edges", lambda P, x: P.histogram_bin_edges(x, bins=5), [N(10)]),
    C("histogram_bin_edges_range", lambda P, x: P.histogram_bin_edges(x, 4, -1.0, 2.0),
      [N(10)]),
    C("histogram_bin_edges_int", lambda P, x: P.histogram_bin_edges(x, bins=3),
      [I((8,), -4, 9)], floats=False),
    C("isin", lambda P, x, t: P.isin(x, t), [I((6,), 0, 5), I((3,), 0, 5)], EXACT,
      floats=False),
    C("isin_invert", lambda P, x, t: P.isin(x, t, invert=True), [I((2, 3), 0, 5),
                                                                 I((4,), 0, 5)],
      EXACT, floats=False),
    C("isin_float", lambda P, x, t: P.isin(x, t), [A([1.0, 2.5, 3.0]), A([2.5, 7.0])], EXACT),
    C("isneginf", lambda P, x: P.isneginf(x), [A([-np.inf, np.inf, np.nan, 1.0])], EXACT),
    C("isposinf", lambda P, x: P.isposinf(x), [A([-np.inf, np.inf, np.nan, 1.0])], EXACT),
    C("isreal", lambda P, x: P.isreal(x), [N(4)], EXACT),
    C("isreal_complex", lambda P, x: P.isreal(P.as_complex(x)),
      [A([[1.0, 0.0], [1.0, 2.0]])], EXACT),
    C("is_empty", lambda P, x: P.is_empty(x), [N(0, 3)], EXACT),
    C("is_empty_not", lambda P, x: P.is_empty(x), [N(2)], EXACT),
    C("as_complex", lambda P, x: P.as_complex(x), [N(3, 2)], EXACT),
    C("as_real", lambda P, x: P.as_real(P.as_complex(x)), [N(2, 3, 2)], EXACT),
    # ---- special functions ----
    C("gammaln", lambda P, x: P.gammaln(x), [U((3, 4), 0.1, 6.0)], SPECIAL, grad=True),
    C("gammaln_int", lambda P, x: P.gammaln(x), [I((5,), 1, 9)], SPECIAL, floats=False),
    C("gammainc", lambda P, a, x: P.gammainc(a, x), [U((6,), 0.5, 4.0), U((6,), 0.1, 5.0)],
      SPECIAL),
    C("gammaincc", lambda P, a, x: P.gammaincc(a, x), [U((6,), 0.5, 4.0), U((6,), 0.1, 5.0)],
      SPECIAL),
    C("multigammaln", lambda P, x: P.multigammaln(x, 3), [U((4,), 2.0, 6.0)], SPECIAL,
      grad=True),
    C("multigammaln_int", lambda P, x: P.multigammaln(x, 2), [I((3,), 2, 7)], SPECIAL,
      floats=False),
    C("polygamma_0", lambda P, x: P.polygamma(x, 0), [U((5,), 0.5, 4.0)], SPECIAL),
    C("polygamma_1", lambda P, x: P.polygamma(x, 1), [U((5,), 0.5, 4.0)], SPECIAL, grad=True),
    C("polygamma_3", lambda P, x: P.polygamma(x, 3), [U((5,), 0.5, 4.0)], SPECIAL),
    # ---- ops/__init__'s helpers ----
    C("increment", lambda P, x: P.increment(x, 2.0), [N(3)], EXACT),
    C("increment_int", lambda P, x: P.increment(x), [I((3,), 0, 9)], EXACT, floats=False),
    C("bitwise_invert", lambda P, x: P.bitwise_invert(x), [I((4,), -9, 9)], EXACT,
      floats=False),
    C("tolist", lambda P, x: np.asarray(P.tolist(x)), [I((2, 3), 0, 9)], EXACT, floats=False),
]

# ---- the generated in-place family (and the guarded stragglers) -----------
INPLACE = [
    C("abs_", lambda P, x: P.abs_(x), [N(2, 3)]),
    C("acos_", lambda P, x: P.acos_(x), [U((4,), -0.9, 0.9)]),
    C("atan_", lambda P, x: P.atan_(x), [N(4)]),
    C("cos_", lambda P, x: P.cos_(x), [N(4)]),
    C("sin_", lambda P, x: P.sin_(x), [N(4)]),
    C("sinh_", lambda P, x: P.sinh_(x), [N(4)]),
    C("tan_", lambda P, x: P.tan_(x), [U((4,), -1.0, 1.0)]),
    C("tanh_", lambda P, x: P.tanh_(x), [N(4)]),
    C("digamma_", lambda P, x: P.digamma_(x), [U((4,), 0.5, 3.0)]),
    C("erf_", lambda P, x: P.erf_(x), [N(4)]),
    C("expm1_", lambda P, x: P.expm1_(x), [N(4)]),
    C("frac_", lambda P, x: P.frac_(x), [N(4)]),
    C("i0_", lambda P, x: P.i0_(x), [N(4)]),
    C("lgamma_", lambda P, x: P.lgamma_(x), [U((4,), 0.5, 3.0)]),
    C("log_", lambda P, x: P.log_(x), [U((4,), 0.5, 3.0)]),
    C("log10_", lambda P, x: P.log10_(x), [U((4,), 0.5, 3.0)]),
    C("log2_", lambda P, x: P.log2_(x), [U((4,), 0.5, 3.0)]),
    C("logit_", lambda P, x: P.logit_(x), [U((4,), 0.1, 0.9)]),
    C("nan_to_num_", lambda P, x: P.nan_to_num_(x, 0.5), [A([np.nan, 1.0, np.inf, -np.inf])]),
    C("neg_", lambda P, x: P.neg_(x), [N(4)]),
    C("square_", lambda P, x: P.square_(x), [N(4)]),
    C("trunc_", lambda P, x: P.trunc_(x), [N(4)]),
    C("cumsum_", lambda P, x: P.cumsum_(x, 1), [N(2, 3)]),
    C("cumsum_flat", lambda P, x: P.cumsum_(x), [N(2, 3)]),
    C("cumprod_", lambda P, x: P.cumprod_(x, 0), [N(3, 2)]),
    C("copysign_", lambda P, x, y: P.copysign_(x, y), [N(4), N(4)]),
    C("hypot_", lambda P, x, y: P.hypot_(x, y), [N(4), N(4)]),
    C("pow_", lambda P, x, y: P.pow_(x, y), [U((4,), 0.5, 2.0), N(4)]),
    C("pow_scalar_", lambda P, x: P.pow_(x, 2.0), [N(4)]),
    C("ldexp_", lambda P, x, y: P.ldexp_(x, y), [N(4), I((4,), -3, 4)]),
    C("gammaln_", lambda P, x: P.gammaln_(x), [U((4,), 0.5, 3.0)], SPECIAL),
    C("gammainc_", lambda P, a, x: P.gammainc_(a, x), [U((4,), 0.5, 3.0), U((4,), 0.5, 3.0)],
      SPECIAL),
    C("gammaincc_", lambda P, a, x: P.gammaincc_(a, x), [U((4,), 0.5, 3.0),
                                                       U((4,), 0.5, 3.0)], SPECIAL),
    C("multigammaln_", lambda P, x: P.multigammaln_(x, 2), [U((4,), 2.0, 5.0)], SPECIAL),
    C("polygamma_", lambda P, x: P.polygamma_(x, 1), [U((4,), 0.5, 3.0)], SPECIAL),
    C("sinc_", lambda P, x: P.sinc_(x), [N(4)]),
    C("bitwise_and_", lambda P, x, y: P.bitwise_and_(x, y), [I((4,), -9, 9), I((4,), -9, 9)],
      EXACT, floats=False),
    C("bitwise_or_", lambda P, x, y: P.bitwise_or_(x, y), [I((4,), -9, 9), I((4,), -9, 9)],
      EXACT, floats=False),
    C("bitwise_xor_", lambda P, x, y: P.bitwise_xor_(x, y), [I((4,), -9, 9), I((4,), -9, 9)],
      EXACT, floats=False),
    C("bitwise_not_", lambda P, x: P.bitwise_not_(x), [I((4,), -9, 9)], EXACT, floats=False),
    C("bitwise_invert_", lambda P, x: P.bitwise_invert_(x), [I((4,), -9, 9)], EXACT,
      floats=False),
    C("bitwise_left_shift_", lambda P, x, y: P.bitwise_left_shift_(x, y),
      [I((4,), 0, 9), I((4,), 0, 4)], EXACT, floats=False),
    C("bitwise_right_shift_", lambda P, x, y: P.bitwise_right_shift_(x, y),
      [I((4,), 0, 99), I((4,), 0, 4)], EXACT, floats=False),
    C("gcd_", lambda P, x, y: P.gcd_(x, y), [I((4,), 0, 30), I((4,), 1, 30)], EXACT,
      floats=False),
    C("lcm_", lambda P, x, y: P.lcm_(x, y), [I((4,), 1, 12), I((4,), 1, 12)], EXACT,
      floats=False),
    C("floor_divide_", lambda P, x, y: P.floor_divide_(x, y), [I((4,), -9, 9),
                                                             I((4,), 1, 4)],
      EXACT, floats=False),
    C("floor_mod_", lambda P, x, y: P.floor_mod_(x, y), [I((4,), -9, 9), I((4,), 1, 4)], EXACT,
      floats=False),
    C("mod_", lambda P, x, y: P.mod_(x, y), [I((4,), -9, 9), I((4,), 1, 4)], EXACT,
      floats=False),
    C("remainder_", lambda P, x, y: P.remainder_(x, y), [N(4), U((4,), 0.5, 2.0)]),
    C("equal_", lambda P, x, y: P.equal_(x, y), [I((4,), 0, 2), I((4,), 0, 2)], EXACT,
      floats=False),
    C("greater_equal_", lambda P, x, y: P.greater_equal_(x, y), [N(4), N(4)], EXACT),
    C("greater_than_", lambda P, x, y: P.greater_than_(x, y), [N(4), N(4)], EXACT),
    C("less_equal_", lambda P, x, y: P.less_equal_(x, y), [N(4), N(4)], EXACT),
    C("less_than_", lambda P, x, y: P.less_than_(x, y), [N(4), N(4)], EXACT),
    C("less_", lambda P, x, y: P.less_(x, y), [N(4), N(4)], EXACT),
    C("logical_and_", lambda P, x, y: P.logical_and_(x, y), [B(4), B(4)], EXACT, floats=False),
    C("logical_or_", lambda P, x, y: P.logical_or_(x, y), [B(4), B(4)], EXACT, floats=False),
    C("logical_not_", lambda P, x: P.logical_not_(x), [B(4)], EXACT, floats=False),
    C("cast_", lambda P, x: P.cast_(x, "int32"), [N(4)], EXACT),
    C("flatten_", lambda P, x: P.flatten_(x), [N(2, 3)], EXACT),
    C("t_", lambda P, x: P.t_(x), [N(2, 3)], EXACT),
    C("transpose_", lambda P, x: P.transpose_(x, [1, 0, 2]), [N(2, 3, 2)], EXACT),
    C("tril_", lambda P, x: P.tril_(x), [N(3, 3)], EXACT),
    C("triu_", lambda P, x: P.triu_(x, 1), [N(3, 3)], EXACT),
    C("masked_fill_", lambda P, x, m: P.masked_fill_(x, m, 2.0), [N(2, 3), B(2, 3)], EXACT),
    C("masked_scatter_", lambda P, x, m, v: P.masked_scatter_(x, m, v),
      [N(2, 3), B(2, 3), N(6)], EXACT),
    C("where_", lambda P, c, x, y: P.where_(c, x, y), [B(4), N(4), N(4)], EXACT),
    C("addmm_", lambda P, i, x, y: P.addmm_(i, x, y, beta=0.5, alpha=2.0),
      [N(2, 2), N(2, 3), N(3, 2)]),
    C("renorm_", lambda P, x: P.renorm_(x, 2.0, 0, 1.0), [N(3, 4)]),
    C("index_add_", lambda P, x, v: P.index_add_(x, P.to_tensor(np.array([0, 2, 0]),
                                                               place="cpu"), 0, v),
      [N(3, 2), N(3, 2)]),
    C("index_put_", lambda P, x, v: P.index_put_(
        x, (P.to_tensor(np.array([0, 1]), place="cpu"),), v), [N(3, 2), N(2, 2)], EXACT),
    C("index_fill_", lambda P, x: P.index_fill_(x, P.to_tensor(np.array([1]), place="cpu"),
                                                1, -3.0), [N(2, 3)], EXACT),
]


# -- running a case in one package ---------------------------------------------
def _tensor(P, a, grad):
    floating = np.issubdtype(a.dtype, np.floating)
    return P.to_tensor(a, place="cpu", stop_gradient=not (grad and floating))


def _flat(out):
    if isinstance(out, (list, tuple)):
        return [o for x in out for o in _flat(x)]
    return [out]


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().numpy()
    if hasattr(t, "numpy"):
        return np.asarray(t.numpy())
    return np.asarray(t)


def _dtype(t):
    if isinstance(t, torch.Tensor):
        return str(t.dtype).removeprefix("torch.")
    if hasattr(t, "dtype"):
        return np.dtype(t.dtype).name
    return type(t).__name__


def _arrays(inputs, name, fdt):
    rng = np.random.RandomState(zlib.crc32(name.encode()))
    return [_make(s, rng, "float32" if fdt == "native" else fdt) for s in inputs]


def _compare(got, want, kind, fdt):
    assert _dtype(got) == _dtype(want), (_dtype(got), _dtype(want))
    g, w = _np(got), _np(want)
    assert g.shape == w.shape
    if kind == EXACT or not (np.issubdtype(w.dtype, np.inexact)):
        np.testing.assert_array_equal(g, w)
        return
    key = fdt if fdt in TOL else ("float64" if w.dtype in (np.float64, np.complex128)
                                  else "float32")
    rtol, atol = (SPECIAL_TOL if kind == SPECIAL else TOL)[key]
    np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


def _run(P, fn, arrays, grad=False, cts=None):
    xs = [_tensor(P, a, grad) for a in arrays]
    outs = _flat(fn(P, *xs))
    grads = None
    if grad:
        loss = None
        for o, ct in zip([o for o in outs if _dtype(o).startswith("float")], cts):
            term = P.sum(P.multiply(o, P.to_tensor(ct[:_np(o).size].reshape(_np(o).shape),
                                                   place="cpu")))
            loss = term if loss is None else P.add(loss, term)
        loss.backward()
        grads = [_np(x.grad) if x.grad is not None else None for x in xs
                 if _dtype(x).startswith("float")]
    return xs, outs, grads


def _with_dtypes(cases):
    """Each case at float32 and float64, or once ("native") where its
    inputs are integer or boolean."""
    return [pytest.param(*c.values, fdt, id=f"{c.id}-{fdt}") for c in cases
            for fdt in (("float32", "float64") if c.values[4] else ("native",))]


@pytest.mark.parametrize("fn,inputs,kind,grad,floats,fdt", _with_dtypes(CASES))
def test_compat_matches_jax(fn, inputs, kind, grad, floats, fdt, request):
    arrays = _arrays(inputs, request.node.callspec.id, fdt)
    _, jout, _ = _run(paddle, fn, arrays)
    _, tout, _ = _run(T, fn, arrays)
    assert len(jout) == len(tout)
    for t, j in zip(tout, jout):
        _compare(t, j, kind, fdt if floats else None)
    if grad:
        rng = np.random.RandomState(7)
        cts = [rng.standard_normal(256).astype(fdt) for _ in range(4)]
        _, _, jg = _run(paddle, fn, arrays, True, cts)
        _, _, tg = _run(T, fn, arrays, True, cts)
        for t, j in zip(tg, jg):
            if j is None:
                assert t is None or not np.any(t)
                continue
            np.testing.assert_allclose(t, j, rtol=TOL[fdt][0], atol=TOL[fdt][1])


@pytest.mark.parametrize("fn,inputs,kind,grad,floats,fdt", _with_dtypes(INPLACE))
def test_inplace_matches_jax(fn, inputs, kind, grad, floats, fdt, request):
    """The in-place op returns its first argument, which then holds the JAX
    op's value and dtype; where shape and dtype stay, torch's storage does."""
    arrays = _arrays(inputs, request.node.callspec.id, fdt)
    jx, jout, _ = _run(paddle, fn, arrays)
    tx, tout, _ = _run(T, fn, arrays)
    assert tout[0] is tx[0] and jout[0] is jx[0]
    _compare(tx[0], jx[0], kind, fdt if floats else None)
    if tuple(tx[0].shape) == arrays[0].shape and _dtype(tx[0]) == arrays[0].dtype.name:
        # the write went into the same storage
        before = _tensor(T, arrays[0], False)
        ptr = before.data_ptr()
        fn(T, before, *[_tensor(T, a, False) for a in arrays[1:]])
        assert before.data_ptr() == ptr


def test_inplace_family_is_the_jax_family():
    """Every in-place name the JAX namespace generates, and the stragglers,
    exist in the port's namespace and top level."""
    from paddle_tpu.ops import compat as jcompat

    names = {n + "_" for n in jcompat._INPLACE_NAMES}
    names |= {"gammaln_", "gammainc_", "gammaincc_", "multigammaln_", "polygamma_", "sinc_",
              "less_", "addmm_", "renorm_", "index_add_", "index_put_", "index_fill_",
              "bitwise_invert_", "increment"}
    missing = sorted(n for n in names if not (hasattr(T, n) and hasattr(T.ops, n)))
    assert missing == []
    assert sorted(n for n in names if not hasattr(paddle, n)) == []


# -- tests/test_export_surface.py:74-98 on both packages -------------------------
@pytest.mark.parametrize("P", [paddle, T], ids=["jax", "port"])
def test_inplace_stragglers_work(P):
    x = P.to_tensor(np.ones((2, 3), "float32"), place="cpu")
    P.index_fill_(x, P.to_tensor(np.array([0], "int64"), place="cpu"), 0, 5.0)
    assert _np(x)[0, 0] == 5.0
    y = P.to_tensor(np.full((2, 2), 3.0, "float32"), place="cpu")
    P.renorm_(y, 2.0, 0, 1.0)
    assert abs(np.linalg.norm(_np(y)[0]) - 1.0) < 1e-5


@pytest.mark.parametrize("P", [paddle, T], ids=["jax", "port"])
def test_inplace_keeps_trainability_under_no_grad(P):
    p = P.to_tensor(np.ones((2, 2), "float32"), place="cpu", stop_gradient=False)
    with P.no_grad():
        P.index_fill_(p, P.to_tensor(np.array([0], "int64"), place="cpu"), 0, 2.0)
    trainable = p.requires_grad if P is T else not p.stop_gradient
    assert trainable  # no_grad must not flip trainability
    np.testing.assert_array_equal(_np(p), [[2.0, 2.0], [1.0, 1.0]])


def test_inplace_gradient_follows_torch_not_the_jax_tape():
    """ROADMAP Queue C, "Reference caveats": the JAX package's generated
    ``sin_`` swaps the value and keeps the tensor's old tape node, so the
    gradient that reaches the input is that of the op before it (here the
    identity's, 1) and not cos(a). The port's in-place ops follow torch's
    autograd: cos(a). A leaf that requires grad refuses an in-place write."""
    a_np = np.array([0.3, -1.2, 2.0], "float32")
    a = paddle.to_tensor(a_np, stop_gradient=False)
    b = paddle.multiply(a, paddle.to_tensor(np.ones(3, "float32")))
    paddle.sin_(b)
    paddle.sum(b).backward()
    np.testing.assert_allclose(b.numpy(), np.sin(a_np), rtol=1e-6)
    np.testing.assert_array_equal(a.grad.numpy(), np.ones(3, "float32"))  # the quirk

    ta = T.to_tensor(a_np, place="cpu", stop_gradient=False)
    tb = T.multiply(ta, T.ones([3]))
    assert T.sin_(tb) is tb
    T.sum(tb).backward()
    np.testing.assert_allclose(tb.detach().numpy(), np.sin(a_np), rtol=1e-6)
    np.testing.assert_allclose(ta.grad.numpy(), np.cos(a_np), rtol=1e-6)

    leaf = T.to_tensor(a_np, place="cpu", stop_gradient=False)
    with pytest.raises(RuntimeError, match="leaf"):
        T.sin_(leaf)
    with pytest.raises(RuntimeError, match="requires grad"):
        T.cast_(leaf.detach().requires_grad_(True), "int32")


def test_inplace_op_saving_its_input_backpropagates():
    """An in-place op whose backward needs its input (``pow_``, ``x * x``
    through ``multiply_``) still differentiates: the op reads a clone."""
    a_np = np.array([0.5, 1.5, -2.0], "float32")
    ta = T.to_tensor(a_np, place="cpu", stop_gradient=False)
    tb = T.multiply(ta, T.ones([3]))
    T.pow_(tb, 3.0)
    T.sum(tb).backward()
    np.testing.assert_allclose(ta.grad.numpy(), 3 * a_np ** 2, rtol=1e-6)
    tc = T.multiply(ta, T.ones([3]))
    T.multiply_(tc, tc)
    ta.grad = None
    T.sum(tc).backward()
    np.testing.assert_allclose(ta.grad.numpy(), 2 * a_np, rtol=1e-6)


# -- ops/__init__'s helpers, finfo/iinfo and the constants ---------------------
_DTYPES = ["float16", "bfloat16", "float32", "float64", "int8", "int16", "int32", "int64",
           "uint8"]


@pytest.mark.parametrize("dt", _DTYPES)
def test_finfo_iinfo_match_jax(dt):
    if dt.startswith(("float", "bfloat")):
        j, t = paddle.finfo(dt), T.finfo(dt)
        for attr in ("bits", "eps", "max", "min", "tiny"):
            assert float(getattr(t, attr)) == float(getattr(j, attr)), attr
        assert str(t.dtype) == np.dtype(j.dtype).name
    else:
        j, t = paddle.iinfo(dt), T.iinfo(dt)
        for attr in ("bits", "max", "min"):
            assert int(getattr(t, attr)) == int(getattr(j, attr)), attr
        assert str(t.dtype) == np.dtype(j.dtype).name


@pytest.mark.parametrize("case", ["float", "int", "bool", "complex"])
def test_dtype_predicates_and_item(case):
    arr = {"float": np.array([1.5], "float32"), "int": np.array([3], "int64"),
           "bool": np.array([True]), "complex": np.array([1 + 2j], "complex64")}[case]
    j, t = paddle.to_tensor(arr), T.to_tensor(arr, place="cpu")
    for name in ("is_floating_point", "is_integer", "is_complex"):
        assert getattr(T, name)(t) == getattr(paddle, name)(j), name
    assert T.is_tensor(t) and paddle.is_tensor(j)
    assert not T.is_tensor(arr) and not paddle.is_tensor(arr)
    assert T.item(t) == paddle.item(j)


def test_constants_match_jax():
    for name in ("pi", "e", "inf"):
        assert getattr(T, name) == getattr(paddle, name)
    assert math.isnan(T.nan) and math.isnan(paddle.nan)
    assert T.newaxis is None and paddle.newaxis is None


def test_printoptions_and_dlpack():
    before = torch._tensor_str.PRINT_OPTS.precision
    try:
        T.set_printoptions(precision=2, sci_mode=False)
        assert torch._tensor_str.PRINT_OPTS.precision == 2
        assert torch._tensor_str.PRINT_OPTS.sci_mode is False
    finally:
        torch.set_printoptions(precision=before, sci_mode=None)
    x = T.to_tensor(np.arange(6, dtype="float32"), place="cpu")
    y = T.from_dlpack(T.to_dlpack(x))
    assert y.data_ptr() == x.data_ptr()
    # across packages: the JAX package's capsule into the port
    j = paddle.to_tensor(np.arange(4, dtype="float32"))
    np.testing.assert_array_equal(T.from_dlpack(paddle.to_dlpack(j)).numpy(), j.numpy())


# -- samplers: by distribution, seeded per package -----------------------------
def _moments_ok(vals, mean, var):
    vals = np.asarray(vals, np.float64).ravel()
    n = vals.size
    assert abs(vals.mean() - mean) <= SIGMAS * math.sqrt(var / n), (vals.mean(), mean)
    assert abs(vals.var() - var) <= SIGMAS * var * math.sqrt(2.0 / n) * 2, (vals.var(), var)


SAMPLERS = {
    # name: (draw(P), dtype, (mean, var) of the checked statistic, statistic)
    "standard_gamma": (lambda P: P.standard_gamma(P.to_tensor(np.full(DRAWS, 2.5, "float32"),
                                                              place="cpu")),
                       "float32", (2.5, 2.5), lambda v: v),
    "binomial": (lambda P: P.binomial(P.to_tensor(np.full(DRAWS, 10, "int64"), place="cpu"),
                                      P.to_tensor(np.full(DRAWS, 0.3, "float32"),
                                                  place="cpu")),
                 "int64", (3.0, 2.1), lambda v: v),
    "log_normal": (lambda P: P.log_normal(0.5, 1.5, [DRAWS]), "float64", (0.5, 2.25),
                   np.log),
}


@pytest.mark.parametrize("name", sorted(SAMPLERS))
@pytest.mark.parametrize("P", [paddle, T], ids=["jax", "port"])
def test_sampler_moments_and_seed(P, name):
    draw, dtype, (mean, var), stat = SAMPLERS[name]
    P.seed(11)
    a = draw(P)
    P.seed(11)
    b = draw(P)
    assert _dtype(a) == dtype
    np.testing.assert_array_equal(_np(a), _np(b))
    _moments_ok(stat(_np(a)), mean, var)


def test_sampler_dtypes_match_jax():
    for name, (draw, _, _, _) in SAMPLERS.items():
        assert _dtype(draw(T)) == _dtype(draw(paddle)), name


# -- the top level: what the port still lacks, each with the item that brings it
DEFERRED = {
    # item 8: the remaining models and domains (hapi, vision, ...)
    "Model": 8, "summary": 8, "flops": 8, "callbacks": 8, "hapi": 8,
    "dataset": 8, "text_datasets": 8, "vision": 8, "audio": 8,
    "text": 8, "metric": 8, "distribution": 8, "fft": 8, "signal": 8, "sparse": 8,
    "onnx": 8,
    # item 10: distributed and mesh
    "DataParallel": 10, "cost_model": 10,
}


def test_missing_top_level_names_are_the_deferred_list():
    """In a fresh interpreter: a submodule another test imports becomes an
    attribute of its package, so this process's ``dir()`` depends on what
    ran before."""
    code = ("import json, paddle_tpu, paddle_tpu_torch\n"
            "pub = lambda m: {n for n in dir(m) if not n.startswith('_')}\n"
            "print(json.dumps(sorted(pub(paddle_tpu) - pub(paddle_tpu_torch))))")
    env = dict(os.environ, PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == sorted(DEFERRED)
    assert set(map(str, DEFERRED.values())) <= {"7", "7b", "8", "10"}


# -- nn and nn.functional: what the port still lacks, each with the item (and
# the JAX module) that brings it
def _tagged(item, groups):
    return {name: item for names in groups.values() for name in names.split()}


NN_DEFERRED = _tagged("7b", {})

NN_FUNCTIONAL_DEFERRED = _tagged("7b", {})


@pytest.mark.parametrize("module,deferred", [("nn", NN_DEFERRED),
                                             ("nn.functional", NN_FUNCTIONAL_DEFERRED)])
def test_missing_nn_names_are_the_deferred_lists(module, deferred):
    """In a fresh interpreter (as above): the public names of
    ``paddle_tpu.<module>`` that ``paddle_tpu_torch.<module>`` lacks are
    exactly the tagged list."""
    code = ("import importlib, json, paddle_tpu, paddle_tpu_torch\n"
            "pub = lambda m: {n for n in dir(m) if not n.startswith('_')}\n"
            f"j = importlib.import_module('paddle_tpu.{module}')\n"
            f"t = importlib.import_module('paddle_tpu_torch.{module}')\n"
            "print(json.dumps(sorted(pub(j) - pub(t))))")
    env = dict(os.environ, PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == sorted(deferred)
    assert set(deferred.values()) <= {"7b"}


# -- models: what the port still lacks, each with its Queue A item
MODELS_DEFERRED = {"LlamaForCausalLMPipe": 10}  # pipeline parallelism


def _missing_in_fresh_interpreter(module):
    code = ("import importlib, json, paddle_tpu, paddle_tpu_torch\n"
            "pub = lambda m: {n for n in dir(m) if not n.startswith('_')}\n"
            f"j = importlib.import_module('paddle_tpu.{module}')\n"
            f"t = importlib.import_module('paddle_tpu_torch.{module}')\n"
            "print(json.dumps(sorted(pub(j) - pub(t))))")
    env = dict(os.environ, PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_missing_models_names_are_the_deferred_list():
    """In a fresh interpreter (as above): the public names of
    ``paddle_tpu.models`` that ``paddle_tpu_torch.models`` lacks are exactly
    the tagged list."""
    assert _missing_in_fresh_interpreter("models") == sorted(MODELS_DEFERRED)
    assert set(MODELS_DEFERRED.values()) <= {10}


# -- io, reader, geometric and incubate: what the port still lacks, each with
# its ROADMAP item. A module another package imports (jax, numpy, itertools)
# is no public name of the API, nor is a ``__future__`` feature; the
# package's own modules are.
API_DEFERRED = {
    "io": {}, "reader": {}, "geometric": {},
    "incubate": {}, "incubate.nn": {}, "incubate.nn.functional": {},
    # the MoE layer, and the static-graph surface
    "incubate.distributed.models.moe": {},
    "static": {}, "static.amp": {}, "base": {},
}


@pytest.mark.parametrize("module", sorted(API_DEFERRED))
def test_missing_api_names_are_the_deferred_lists(module):
    """In a fresh interpreter (as above): the public API names of
    ``paddle_tpu.<module>`` that ``paddle_tpu_torch.<module>`` lacks are
    exactly the tagged list."""
    code = ("import __future__, importlib, json, types, paddle_tpu, paddle_tpu_torch\n"
            "def pub(m):\n"
            "    root = m.__name__.split('.')[0]\n"
            "    return {n for n, v in vars(m).items() if not n.startswith('_')\n"
            "            and not isinstance(v, __future__._Feature)\n"
            "            and not (isinstance(v, types.ModuleType)\n"
            "                     and v.__name__.split('.')[0] != root)}\n"
            f"j = importlib.import_module('paddle_tpu.{module}')\n"
            f"t = importlib.import_module('paddle_tpu_torch.{module}')\n"
            "print(json.dumps(sorted(pub(j) - pub(t))))")
    env = dict(os.environ, PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == sorted(API_DEFERRED[module])


def test_incubate_distributed_raise_names_its_item():
    # the MoE layer is ported; its expert parallelism (a mesh) waits for item 10
    import paddle_tpu_torch.incubate as inc

    moe = inc.distributed.models.moe
    experts = [torch.nn.Linear(4, 4) for _ in range(2)]
    with pytest.raises(NotImplementedError, match="Queue A item 10"):
        moe.MoELayer(d_model=4, experts=experts, gate={"type": "gshard"}, mesh=object())


@pytest.mark.parametrize("module", ["nn.utils", "quantization", "nn.quant"])
def test_all_lists_equal_jax(module):
    """``__all__`` of the port's ``nn.utils``, ``quantization`` and
    ``nn.quant`` is the JAX module's, in its order."""
    import importlib

    j = importlib.import_module(f"paddle_tpu.{module}")
    t = importlib.import_module(f"paddle_tpu_torch.{module}")
    assert list(t.__all__) == list(j.__all__)
    assert all(hasattr(t, n) for n in t.__all__)
