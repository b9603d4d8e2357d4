"""The port's op namespace (creation, math, manipulation, reduction, search,
the matrix products and einsum) against the JAX package's, op by op.

Each case is one function of the paddle API, written once and called with
each package as ``P`` on the same numpy inputs (made from a seed per case):
outputs and their dtypes at float32, outputs at bfloat16 where the op takes
it, and, for the differentiable ones, the gradients of ``sum(out * ct)``
with the same random ``ct`` on both sides. Tolerances are those of
tests/op_test.py: float32 rtol 1e-5 / atol 1e-6, bfloat16 2e-2 / 2e-2; the
gradients are held to the float32 output tolerance, tighter than op_test's
finite differences.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as T
from paddle_tpu_torch.device import _CURRENT

RTOL, ATOL = 1e-5, 1e-6
BF16_RTOL, BF16_ATOL = 2e-2, 2e-2


@pytest.fixture(autouse=True)
def _on_cpu():
    before = _CURRENT[0]
    T.set_device("cpu")
    yield
    _CURRENT[0] = before


# -- input specs ---------------------------------------------------------
def N(*shape):
    return ("normal", shape)


def U(shape, lo, hi):
    return ("uniform", shape, lo, hi)


def I(shape, lo, hi):  # noqa: E743
    return ("int", shape, lo, hi)


def B(*shape):
    return ("bool", shape)


def A(arr):
    return ("array", np.asarray(arr))


def _make(spec, rng):
    kind = spec[0]
    if kind == "normal":
        return rng.standard_normal(spec[1]).astype(np.float32)
    if kind == "uniform":
        return rng.uniform(spec[2], spec[3], spec[1]).astype(np.float32)
    if kind == "int":
        return rng.randint(spec[2], spec[3], spec[1]).astype(np.int64)
    if kind == "bool":
        return rng.rand(*spec[1]) > 0.5
    return spec[1]


def C(name, fn, inputs=(), low=True, grad=True, rtol=RTOL, atol=ATOL):
    return pytest.param(fn, inputs, low, grad, rtol, atol, id=name)


CASES = [
    # ---- creation ----
    C("zeros", lambda P: P.zeros([2, 3]), low=False),
    C("zeros_int32", lambda P: P.zeros([2], dtype="int32"), low=False),
    C("ones", lambda P: P.ones([3]), low=False),
    C("full_float", lambda P: P.full([2, 2], 1.5), low=False),
    C("full_int", lambda P: P.full([2], 3), low=False),
    C("full_bool", lambda P: P.full([2], True), low=False),
    C("empty", lambda P: P.empty([2, 2]), low=False),
    C("zeros_like", lambda P, x: P.zeros_like(x), [N(2, 3)], grad=False),
    C("ones_like_dtype", lambda P, x: P.ones_like(x, dtype="int64"), [N(2, 3)], grad=False),
    C("full_like", lambda P, x: P.full_like(x, 2.5), [N(2, 3)], grad=False),
    C("empty_like", lambda P, x: P.empty_like(x), [N(2, 3)], grad=False),
    C("arange_int", lambda P: P.arange(5), low=False),
    C("arange_step", lambda P: P.arange(1, 7, 2), low=False),
    C("arange_float", lambda P: P.arange(0, 1, 0.25), low=False),
    C("linspace", lambda P: P.linspace(0, 1, 5), low=False),
    C("logspace", lambda P: P.logspace(0, 2, 3), low=False),
    C("eye", lambda P: P.eye(3), low=False),
    C("eye_rect", lambda P: P.eye(2, 4), low=False),
    C("assign", lambda P, x: P.assign(x), [N(2, 3)]),
    C("clone", lambda P, x: P.clone(x), [N(2, 3)]),
    C("tril", lambda P, x: P.tril(x, 1), [N(4, 4)]),
    C("triu", lambda P, x: P.triu(x, -1), [N(4, 4)]),
    C("tril_indices", lambda P: P.tril_indices(4, 4, 0), low=False),
    C("triu_indices", lambda P: P.triu_indices(3, 4, 1), low=False),
    C("diag_vector", lambda P, x: P.diag(x), [N(3)]),
    C("diag_padding", lambda P, x: P.diag(x, 1, padding_value=9.0), [N(3)]),
    C("diag_matrix", lambda P, x: P.diag(x, -1), [N(4, 4)]),
    C("diagflat", lambda P, x: P.diagflat(x), [N(3)], grad=False),
    C("diag_embed", lambda P, x: P.diag_embed(x, 1), [N(2, 3)]),
    C("meshgrid", lambda P, a, b: P.meshgrid(a, b), [N(3), N(4)], grad=False),
    C("complex", lambda P, a, b: P.complex(a, b), [N(3), N(3)], low=False, grad=False),
    C("polar", lambda P, a, b: P.polar(a, b), [U((3,), 0.5, 2), N(3)], low=False,
      grad=False),
    C("numel", lambda P, x: P.numel(x), [N(2, 5)], grad=False),
    # ---- math: binary ----
    C("add", lambda P, x, y: P.add(x, y), [N(3, 4), N(3, 4)]),
    C("add_broadcast", lambda P, x, y: P.add(x, y), [N(3, 4), N(4)]),
    C("subtract", lambda P, x, y: P.subtract(x, y), [N(3, 4), N(3, 4)]),
    C("multiply", lambda P, x, y: P.multiply(x, y), [N(3, 4), N(3, 4)]),
    C("divide", lambda P, x, y: P.divide(x, y), [N(3, 4), U((3, 4), 0.5, 2)]),
    C("floor_divide", lambda P, x, y: P.floor_divide(x, y), [I((3, 4), -9, 9),
                                                             I((3, 4), 1, 4)], low=False),
    C("remainder_float", lambda P, x, y: P.remainder(x, y), [N(3, 4), U((3, 4), 0.5, 2)],
      grad=False),
    C("remainder_int", lambda P, x, y: P.remainder(x, y), [I((3, 4), -9, 9),
                                                           I((3, 4), 1, 4)], low=False),
    C("mod", lambda P, x, y: P.mod(x, y), [I((5,), -9, 9), I((5,), 1, 4)], low=False),
    C("floor_mod", lambda P, x, y: P.floor_mod(x, y), [I((5,), -9, 9), I((5,), 1, 4)],
      low=False),
    C("pow", lambda P, x, y: P.pow(x, y), [U((3, 4), 0.5, 2), U((3, 4), -1, 2)]),
    C("pow_scalar", lambda P, x: P.pow(x, 2.0), [N(3, 4)]),
    C("fmax", lambda P, x, y: P.fmax(x, y), [N(3, 4), N(3, 4)]),
    C("fmin", lambda P, x, y: P.fmin(x, y), [N(3, 4), N(3, 4)]),
    C("maximum", lambda P, x, y: P.maximum(x, y), [N(3, 4), N(3, 4)]),
    C("minimum", lambda P, x, y: P.minimum(x, y), [N(3, 4), N(3, 4)]),
    C("maximum_scalar", lambda P, x: P.maximum(x, 0.25), [N(3, 4)]),
    C("scale", lambda P, x: P.scale(x, 2.0, 1.0), [N(3, 4)]),
    C("scale_bias_first", lambda P, x: P.scale(x, 3.0, 0.5, bias_after_scale=False),
      [N(3, 4)]),
    C("scale_tensor", lambda P, x, s: P.scale(x, s, 0.5), [N(3, 4), N(1)]),
    C("lerp", lambda P, x, y, w: P.lerp(x, y, w), [N(3, 4), N(3, 4), U((3, 4), 0, 1)]),
    C("atan2", lambda P, x, y: P.atan2(x, y), [N(3, 4), N(3, 4)]),
    C("logaddexp", lambda P, x, y: P.logaddexp(x, y), [N(3, 4), N(3, 4)]),
    C("hypot", lambda P, x, y: P.hypot(x, y), [N(3, 4), N(3, 4)]),
    C("ldexp", lambda P, x, y: P.ldexp(x, y), [N(3, 4), I((3, 4), -3, 4)], low=False,
      grad=False),
    C("copysign", lambda P, x, y: P.copysign(x, y), [N(3, 4), N(3, 4)]),
    C("nextafter", lambda P, x, y: P.nextafter(x, y), [N(3, 4), N(3, 4)], low=False,
      grad=False),
    C("heaviside", lambda P, x, y: P.heaviside(x, y), [A([-1.0, 0.0, 2.0]),
                                                       A([0.5, 0.5, 0.5])], grad=False),
    C("gcd", lambda P, x, y: P.gcd(x, y), [I((6,), 1, 40), I((6,), 1, 40)], low=False),
    C("lcm", lambda P, x, y: P.lcm(x, y), [I((6,), 1, 12), I((6,), 1, 12)], low=False),
    # ---- math: unary ----
    C("exp", lambda P, x: P.exp(x), [N(3, 4)]),
    C("expm1", lambda P, x: P.expm1(x), [N(3, 4)]),
    C("log", lambda P, x: P.log(x), [U((3, 4), 0.5, 3)]),
    C("log2", lambda P, x: P.log2(x), [U((3, 4), 0.5, 3)]),
    C("log10", lambda P, x: P.log10(x), [U((3, 4), 0.5, 3)]),
    C("log1p", lambda P, x: P.log1p(x), [U((3, 4), 0.0, 3)]),
    C("sqrt", lambda P, x: P.sqrt(x), [U((3, 4), 0.5, 3)]),
    C("rsqrt", lambda P, x: P.rsqrt(x), [U((3, 4), 0.5, 3)]),
    C("square", lambda P, x: P.square(x), [N(3, 4)]),
    C("abs", lambda P, x: P.abs(x), [N(3, 4)]),
    C("sign", lambda P, x: P.sign(x), [N(3, 4)]),
    C("neg", lambda P, x: P.neg(x), [N(3, 4)]),
    C("negative", lambda P, x: P.negative(x), [N(3, 4)]),
    C("reciprocal", lambda P, x: P.reciprocal(x), [U((3, 4), 0.5, 3)]),
    C("floor", lambda P, x: P.floor(x), [N(3, 4)]),
    C("ceil", lambda P, x: P.ceil(x), [N(3, 4)]),
    C("round", lambda P, x: P.round(x), [A([0.5, 1.5, 2.5, -0.5, 1.2, -2.7])]),
    C("trunc", lambda P, x: P.trunc(x), [N(3, 4)]),
    C("frac", lambda P, x: P.frac(x), [N(3, 4)]),
    C("sin", lambda P, x: P.sin(x), [N(3, 4)]),
    C("cos", lambda P, x: P.cos(x), [N(3, 4)]),
    C("tan", lambda P, x: P.tan(x), [U((3, 4), -1, 1)]),
    C("asin", lambda P, x: P.asin(x), [U((3, 4), -0.9, 0.9)]),
    C("acos", lambda P, x: P.acos(x), [U((3, 4), -0.9, 0.9)]),
    C("atan", lambda P, x: P.atan(x), [N(3, 4)]),
    C("sinh", lambda P, x: P.sinh(x), [N(3, 4)]),
    C("cosh", lambda P, x: P.cosh(x), [N(3, 4)]),
    C("tanh", lambda P, x: P.tanh(x), [N(3, 4)]),
    C("asinh", lambda P, x: P.asinh(x), [N(3, 4)]),
    C("acosh", lambda P, x: P.acosh(x), [U((3, 4), 1.2, 3)]),
    C("atanh", lambda P, x: P.atanh(x), [U((3, 4), -0.9, 0.9)]),
    C("erf", lambda P, x: P.erf(x), [N(3, 4)]),
    C("erfinv", lambda P, x: P.erfinv(x), [U((3, 4), -0.9, 0.9)]),
    C("sigmoid", lambda P, x: P.sigmoid(x), [N(3, 4)]),
    C("digamma", lambda P, x: P.digamma(x), [U((3, 4), 0.5, 4)], low=False),
    C("lgamma", lambda P, x: P.lgamma(x), [U((3, 4), 0.5, 4)], low=False),
    C("i0", lambda P, x: P.i0(x), [N(3, 4)], low=False, grad=False),
    C("i0e", lambda P, x: P.i0e(x), [N(3, 4)], low=False, grad=False),
    C("i1", lambda P, x: P.i1(x), [N(3, 4)], low=False, grad=False),
    C("i1e", lambda P, x: P.i1e(x), [N(3, 4)], low=False, grad=False),
    C("deg2rad", lambda P, x: P.deg2rad(x), [N(3, 4)]),
    C("rad2deg", lambda P, x: P.rad2deg(x), [N(3, 4)]),
    C("angle", lambda P, x: P.angle(x), [N(3, 4)], grad=False),
    C("real_imag", lambda P, a, b: [P.real(P.complex(a, b)), P.imag(P.complex(a, b))],
      [N(3), N(3)], low=False, grad=False),
    C("conj", lambda P, a, b: P.conj(P.complex(a, b)), [N(3), N(3)], low=False, grad=False),
    C("logit", lambda P, x: P.logit(x), [U((3, 4), 0.1, 0.9)]),
    C("logit_eps", lambda P, x: P.logit(x, eps=0.2), [U((3, 4), 0.05, 0.95)]),
    C("clip", lambda P, x: P.clip(x, -0.5, 0.5), [N(3, 4)]),
    C("clip_min_only", lambda P, x: P.clip(x, min=0.0), [N(3, 4)]),
    C("stanh", lambda P, x: P.stanh(x), [N(3, 4)]),
    C("multiplex", lambda P, a, b, i: P.multiplex([a, b], i), [N(3, 2), N(3, 2),
                                                                A([[1], [0], [1]])]),
    # ---- math: cumulative ----
    C("cumsum_axis", lambda P, x: P.cumsum(x, axis=1), [N(3, 4)]),
    C("cumsum_flat", lambda P, x: P.cumsum(x), [N(3, 4)]),
    C("cumsum_dtype", lambda P, x: P.cumsum(x, axis=0, dtype="float64"), [N(3, 4)],
      low=False),
    C("cumprod", lambda P, x: P.cumprod(x, dim=1), [U((3, 4), 0.5, 1.5)]),
    # ties: the index of the latest maximum; the gradient of a tie is each
    # package's own, so it is held on distinct values (cummax_grad)
    C("cummax_ties", lambda P, x: P.cummax(x, axis=1),
      [A([[1.0, 3.0, 2.0, 3.0], [0.0, -1.0, 5.0, 4.0]])], grad=False),
    C("cummax_grad", lambda P, x: P.cummax(x, axis=1), [N(3, 4)]),
    C("cummin", lambda P, x: P.cummin(x, axis=0), [N(4, 3)]),
    C("cummax_flat", lambda P, x: P.cummax(x), [N(3, 4)]),
    C("logcumsumexp", lambda P, x: P.logcumsumexp(x, axis=1), [N(3, 4)]),
    # ---- math: nan handling, comparisons, logic, bits ----
    C("isnan_isinf_isfinite", lambda P, x: [P.isnan(x), P.isinf(x), P.isfinite(x)],
      [A([1.0, np.nan, np.inf, -np.inf, 0.0])], grad=False),
    C("nan_to_num", lambda P, x: P.nan_to_num(x, nan=1.0, posinf=9.0, neginf=-9.0),
      [A([1.0, np.nan, np.inf, -np.inf, 0.0])], grad=False),
    C("equal", lambda P, x, y: P.equal(x, y), [I((6,), 0, 3), I((6,), 0, 3)], low=False),
    C("not_equal", lambda P, x, y: P.not_equal(x, y), [I((6,), 0, 3), I((6,), 0, 3)],
      low=False),
    C("not_equal_scalar", lambda P, x: P.not_equal(x, -100), [A([1, -100, 3])], low=False),
    C("less_than", lambda P, x, y: P.less_than(x, y), [N(6), N(6)]),
    C("less_equal", lambda P, x, y: P.less_equal(x, y), [N(6), N(6)]),
    C("greater_than", lambda P, x, y: P.greater_than(x, y), [N(6), N(6)]),
    C("greater_equal", lambda P, x, y: P.greater_equal(x, y), [N(6), N(6)]),
    C("less_greater", lambda P, x, y: [P.less(x, y), P.greater(x, y)], [N(6), N(6)]),
    C("equal_all", lambda P, x: [P.equal_all(x, x), P.equal_all(x, x + 1)], [N(4)],
      low=False, grad=False),
    C("allclose", lambda P, x, y: [P.allclose(x, x), P.allclose(x, y)], [N(4), N(4)],
      low=False),
    C("isclose", lambda P, x, y: P.isclose(x, y, atol=0.5), [N(6), N(6)], low=False),
    C("logical", lambda P, a, b: [P.logical_and(a, b), P.logical_or(a, b),
                                  P.logical_xor(a, b), P.logical_not(a)],
      [B(6), B(6)], low=False),
    C("bitwise", lambda P, a, b: [P.bitwise_and(a, b), P.bitwise_or(a, b),
                                  P.bitwise_xor(a, b), P.bitwise_not(a)],
      [I((6,), 0, 64), I((6,), 0, 64)], low=False),
    C("bitwise_shift", lambda P, a, b: [P.bitwise_left_shift(a, b),
                                        P.bitwise_right_shift(a, b)],
      [I((6,), 0, 64), I((6,), 0, 4)], low=False),
    # ---- math: products ----
    C("dot_1d", lambda P, x, y: P.dot(x, y), [N(5), N(5)]),
    C("dot_2d", lambda P, x, y: P.dot(x, y), [N(3, 5), N(3, 5)]),
    C("inner", lambda P, x, y: P.inner(x, y), [N(3, 5), N(2, 5)]),
    C("outer", lambda P, x, y: P.outer(x, y), [N(3), N(4)]),
    C("cross", lambda P, x, y: P.cross(x, y), [N(3, 4), N(3, 4)]),
    C("cross_axis", lambda P, x, y: P.cross(x, y, axis=1), [N(2, 3), N(2, 3)]),
    C("kron", lambda P, x, y: P.kron(x, y), [N(2, 2), N(2, 3)]),
    C("trace", lambda P, x: P.trace(x, 1), [N(4, 4)]),
    C("diagonal", lambda P, x: P.diagonal(x, 0, 1, 2), [N(2, 3, 3)]),
    C("addmm", lambda P, a, x, y: P.addmm(a, x, y, beta=0.5, alpha=2.0),
      [N(3, 4), N(3, 5), N(5, 4)]),
    C("trapezoid", lambda P, y: P.trapezoid(y, dx=0.5), [N(3, 5)]),
    C("trapezoid_x", lambda P, y, x: P.trapezoid(y, x=x), [N(5), U((5,), 0, 1)]),
    C("vander", lambda P, x: P.vander(x, 3), [N(4)]),
    # ---- math: in place ----
    C("add_", lambda P, x, y: P.add_(x, y), [N(3), N(3)], low=False, grad=False),
    C("subtract_", lambda P, x, y: P.subtract_(x, y), [N(3), N(3)], low=False, grad=False),
    C("multiply_", lambda P, x, y: P.multiply_(x, y), [N(3), N(3)], low=False, grad=False),
    C("divide_", lambda P, x, y: P.divide_(x, y), [N(3), U((3,), 1, 2)], low=False,
      grad=False),
    C("scale_", lambda P, x: P.scale_(x, 2.0, 1.0), [N(3)], low=False, grad=False),
    C("clip_", lambda P, x: P.clip_(x, -0.1, 0.1), [N(3)], low=False, grad=False),
    # ---- reduction ----
    C("sum_all", lambda P, x: P.sum(x), [N(3, 4)]),
    C("sum_axis_keepdim", lambda P, x: P.sum(x, axis=1, keepdim=True), [N(3, 4)]),
    C("sum_axes", lambda P, x: P.sum(x, axis=[0, 2]), [N(2, 3, 4)]),
    C("sum_dtype", lambda P, x: P.sum(x, dtype="float64"), [N(3, 4)], low=False),
    C("sum_int", lambda P, x: P.sum(x, axis=0), [I((3, 4), 0, 9)], low=False),
    C("sum_bool", lambda P, x: P.sum(x), [B(5)], low=False),
    C("mean", lambda P, x: P.mean(x, axis=-1), [N(3, 4)]),
    C("mean_all", lambda P, x: P.mean(x), [N(3, 4)]),
    C("prod", lambda P, x: P.prod(x, axis=1), [U((3, 4), 0.5, 1.5)]),
    C("prod_all", lambda P, x: P.prod(x), [U((2, 3), 0.5, 1.5)]),
    C("max", lambda P, x: P.max(x, axis=0), [N(3, 4)]),
    C("min_keepdim", lambda P, x: P.min(x, axis=1, keepdim=True), [N(3, 4)]),
    C("amax_amin", lambda P, x: [P.amax(x), P.amin(x, axis=[0, 1])], [N(3, 4)]),
    C("std", lambda P, x: P.std(x, axis=1), [N(3, 5)]),
    C("std_all", lambda P, x: P.std(x), [N(3, 5)]),
    C("var_biased", lambda P, x: P.var(x, axis=0, unbiased=False), [N(4, 3)]),
    C("all_any", lambda P, x: [P.all(x), P.any(x, axis=1), P.all(x, axis=0, keepdim=True)],
      [B(3, 4)], low=False),
    C("logsumexp", lambda P, x: P.logsumexp(x, axis=1), [N(3, 4)]),
    C("logsumexp_all", lambda P, x: P.logsumexp(x), [N(3, 4)]),
    C("nansum", lambda P, x: P.nansum(x, axis=1), [A([[1.0, np.nan, 2.0], [np.nan, 4.0, 5.0]])],
      grad=False),
    C("nanmean", lambda P, x: P.nanmean(x, axis=1), [A([[1.0, np.nan, 2.0], [3.0, 4.0, 5.0]])],
      grad=False),
    C("median_odd", lambda P, x: P.median(x, axis=1), [N(3, 5)], low=False),
    C("median_even", lambda P, x: P.median(x, axis=1), [N(3, 4)], low=False),
    C("median_all", lambda P, x: P.median(x), [N(3, 4)], low=False),
    C("median_min", lambda P, x: P.median(x, axis=1, mode="min"), [N(3, 4)], low=False,
      grad=False),
    C("nanmedian", lambda P, x: P.nanmedian(x, axis=1),
      [A([[1.0, np.nan, 2.0, 7.0], [3.0, 4.0, 5.0, 6.0]])], low=False, grad=False),
    C("quantile", lambda P, x: P.quantile(x, 0.3, axis=1), [N(3, 6)], low=False),
    C("quantile_list", lambda P, x: P.quantile(x, [0.25, 0.75], axis=0), [N(5, 3)],
      low=False),
    C("quantile_all", lambda P, x: P.quantile(x, 0.5), [N(3, 4)], low=False),
    C("nanquantile", lambda P, x: P.nanquantile(x, 0.5, axis=1),
      [A([[1.0, np.nan, 2.0, 7.0], [3.0, 4.0, 5.0, 6.0]])], low=False, grad=False),
    C("count_nonzero", lambda P, x: P.count_nonzero(x, axis=1), [I((3, 4), 0, 3)],
      low=False),
    C("norm_fro", lambda P, x: P.norm(x), [N(3, 4)]),
    C("norm_axis", lambda P, x: P.norm(x, axis=1), [N(3, 4)]),
    C("norm_p1", lambda P, x: P.norm(x, p=1, axis=0), [N(3, 4)]),
    C("norm_p3", lambda P, x: P.norm(x, p=3.0, axis=1, keepdim=True), [N(3, 4)]),
    C("norm_inf", lambda P, x: P.norm(x, p=float("inf"), axis=1), [N(3, 4)]),
    C("norm_nuc", lambda P, x: P.norm(x, p="nuc", axis=[0, 1]), [N(3, 4)], low=False),
    C("dist", lambda P, x, y: P.dist(x, y), [N(3, 4), N(3, 4)]),
    C("dist_inf", lambda P, x, y: P.dist(x, y, p=float("inf")), [N(3, 4), N(3, 4)]),
    # ---- manipulation ----
    C("cast_bf16", lambda P, x: P.cast(x, "bfloat16"), [N(3, 4)], low=False, grad=False),
    C("cast_int", lambda P, x: P.cast(x, "int64"), [N(3, 4)], low=False, grad=False),
    C("cast_same", lambda P, x: P.cast(x, "float32"), [N(3, 4)], low=False),
    C("reshape", lambda P, x: P.reshape(x, [0, -1, 2]), [N(3, 4, 2)]),
    C("view", lambda P, x: P.view(x, [4, 3]), [N(3, 4)]),
    C("view_as", lambda P, x, y: P.view_as(x, y), [N(3, 4), N(2, 6)]),
    C("transpose", lambda P, x: P.transpose(x, [2, 0, 1]), [N(2, 3, 4)]),
    C("t", lambda P, x: P.t(x), [N(2, 3)]),
    C("concat", lambda P, x, y: P.concat([x, y], axis=1), [N(2, 3), N(2, 2)]),
    C("stack", lambda P, x, y: P.stack([x, y], axis=1), [N(2, 3), N(2, 3)]),
    C("split_even", lambda P, x: P.split(x, 2, axis=1), [N(3, 4)]),
    C("split_sections", lambda P, x: P.split(x, [1, -1, 2], axis=1), [N(3, 6)]),
    C("chunk", lambda P, x: P.chunk(x, 3, axis=0), [N(6, 2)]),
    C("tensor_split_count", lambda P, x: P.tensor_split(x, 3), [N(7)], grad=False),
    C("tensor_split_indices", lambda P, x: P.tensor_split(x, [1, 4], axis=1), [N(2, 6)]),
    C("squeeze_axis", lambda P, x: P.squeeze(x, axis=[0, 2]), [N(1, 3, 1, 2)]),
    C("squeeze_all", lambda P, x: P.squeeze(x), [N(1, 3, 1, 2)]),
    C("squeeze_not_one", lambda P, x: P.squeeze(x, axis=1), [N(2, 3)]),
    C("unsqueeze", lambda P, x: P.unsqueeze(x, [0, 2]), [N(3, 4)]),
    C("unsqueeze_neg", lambda P, x: P.unsqueeze(x, -1), [N(3, 4)]),
    C("flatten", lambda P, x: P.flatten(x, 1, 2), [N(2, 3, 4, 2)]),
    C("tile", lambda P, x: P.tile(x, [2, 1, 3]), [N(2, 3)]),
    C("expand", lambda P, x: P.expand(x, [2, -1, 3]), [N(4, 1)]),
    C("broadcast_to", lambda P, x: P.broadcast_to(x, [3, 4]), [N(4)]),
    C("expand_as", lambda P, x, y: P.expand_as(x, y), [N(1, 4), N(3, 4)]),
    # broadcast_tensors, tensor_split by count and atleast_*d build their
    # outputs outside the JAX tape (no gradient reaches the input there);
    # the port's are torch's, with gradients: values only
    C("broadcast_tensors", lambda P, x, y: P.broadcast_tensors([x, y]), [N(3, 1), N(4)],
      grad=False),
    C("broadcast_shape", lambda P: P.broadcast_shape([3, 1], [1, 4]), low=False),
    C("flip", lambda P, x: P.flip(x, [0, 1]), [N(3, 4)]),
    C("rot90", lambda P, x: P.rot90(x, 3), [N(3, 4)]),
    C("roll_flat", lambda P, x: P.roll(x, 2), [N(3, 4)]),
    C("roll_axes", lambda P, x: P.roll(x, [1, -1], axis=[0, 1]), [N(3, 4)]),
    C("diff", lambda P, x: P.diff(x, axis=1), [N(3, 5)]),
    C("diff_prepend", lambda P, x, p: P.diff(x, n=2, axis=0, prepend=p), [N(4, 3), N(1, 3)]),
    C("gather", lambda P, x, i: P.gather(x, i, axis=1), [N(3, 5), A([4, 0, 2, 2])]),
    C("gather_2d_index", lambda P, x, i: P.gather(x, i), [N(5, 3), A([[3], [0], [1]])]),
    C("gather_nd", lambda P, x, i: P.gather_nd(x, i), [N(3, 4, 2), A([[0, 1], [2, 3]])]),
    C("scatter_overwrite", lambda P, x, i, u: P.scatter(x, i, u),
      [N(5, 3), A([3, 0, 1]), N(3, 3)]),
    C("scatter_add", lambda P, x, i, u: P.scatter(x, i, u, overwrite=False),
      [N(5, 3), A([3, 0, 3]), N(3, 3)]),
    C("scatter_nd_add", lambda P, x, i, u: P.scatter_nd_add(x, i, u),
      [N(4, 3), A([[1], [3], [1]]), N(3, 3)]),
    C("scatter_nd", lambda P, i, u: P.scatter_nd(i, u, [4, 3]), [A([[1], [3]]), N(2, 3)]),
    C("index_select", lambda P, x, i: P.index_select(x, i, axis=1), [N(3, 5), A([4, 1, 1])]),
    C("index_sample", lambda P, x, i: P.index_sample(x, i), [N(3, 5), A([[0, 4], [1, 1],
                                                                          [3, 2]])]),
    C("index_add", lambda P, x, i, v: P.index_add(x, i, 0, v), [N(4, 3), A([0, 2, 0]),
                                                                 N(3, 3)]),
    C("index_put", lambda P, x, r, c, v: P.index_put(x, (r, c), v),
      [N(4, 3), A([0, 2]), A([1, 2]), N(2)]),
    C("index_put_accumulate", lambda P, x, r, v: P.index_put(x, (r,), v, accumulate=True),
      [N(4, 3), A([1, 1]), N(2, 3)]),
    C("index_fill", lambda P, x, i: P.index_fill(x, i, 1, -2.0), [N(3, 4), A([0, 3])]),
    C("masked_fill", lambda P, x, m: P.masked_fill(x, m, 7.0), [N(3, 4), B(3, 4)]),
    C("where", lambda P, c, x, y: P.where(c, x, y), [B(3, 4), N(3, 4), N(3, 4)]),
    C("where_condition_only", lambda P, c: P.where(c), [B(3, 4)], low=False),
    C("take_along_axis", lambda P, x, i: P.take_along_axis(x, i, 1),
      [N(3, 4), A([[0, 3], [1, 1], [2, 0]])]),
    C("put_along_axis", lambda P, x, i, v: P.put_along_axis(x, i, v, 1),
      [N(3, 4), A([[0], [3], [1]]), N(3, 1)]),
    C("put_along_axis_add", lambda P, x, i, v: P.put_along_axis(x, i, v, 1, reduce="add"),
      [N(3, 4), A([[0, 1, 2, 3], [3, 2, 1, 0], [1, 1, 2, 2]]), N(3, 4)]),
    C("put_along_axis_mul_exclude", lambda P, x, i, v: P.put_along_axis(
        x, i, v, 1, reduce="mul", include_self=False),
      [N(3, 4), A([[0, 1, 2, 3], [3, 2, 1, 0], [1, 0, 2, 3]]), N(3, 4)], grad=False),
    C("repeat_interleave", lambda P, x: P.repeat_interleave(x, 2, axis=0), [N(3, 2)]),
    C("repeat_interleave_flat", lambda P, x: P.repeat_interleave(x, 3), [N(2, 2)]),
    C("repeat_interleave_tensor", lambda P, x, r: P.repeat_interleave(x, r, axis=0),
      [N(3, 2), A([1, 0, 2])], grad=False),
    C("unbind", lambda P, x: P.unbind(x, axis=1), [N(2, 3)]),
    C("unstack", lambda P, x: P.unstack(x), [N(2, 3)]),
    C("moveaxis", lambda P, x: P.moveaxis(x, [0, 1], [2, 0]), [N(2, 3, 4)]),
    C("swapaxes", lambda P, x: P.swapaxes(x, 0, 2), [N(2, 3, 4)]),
    C("as_strided", lambda P, x: P.as_strided(x, [2, 3], [1, 2], 1), [N(4, 2)]),
    C("slice", lambda P, x: P.slice(x, [0, 1], [1, -3], [10, -1]), [N(3, 5)]),
    C("strided_slice", lambda P, x: P.strided_slice(x, [0, 1], [0, 4], [3, 0], [2, -2]),
      [N(3, 5)]),
    C("pad_full", lambda P, x: P.pad(x, [1, 0, 0, 2]), [N(2, 3)]),
    C("pad_spatial", lambda P, x: P.pad(x, [1, 2], value=0.5), [N(1, 2, 4)]),
    C("pad_reflect", lambda P, x: P.pad(x, [2, 1], mode="reflect"), [N(1, 2, 4)]),
    C("pad_replicate", lambda P, x: P.pad(x, [1, 2, 2, 0], mode="replicate"), [N(1, 1, 3, 4)]),
    C("pad_circular", lambda P, x: P.pad(x, [1, 2], mode="circular"), [N(1, 2, 4)]),
    C("pad_nhwc", lambda P, x: P.pad(x, [1, 1, 0, 1], data_format="NHWC"), [N(1, 2, 3, 2)]),
    C("nonzero", lambda P, x: P.nonzero(x), [B(3, 4)], low=False),
    C("nonzero_tuple", lambda P, x: P.nonzero(x, as_tuple=True), [B(3, 4)], low=False),
    C("masked_select", lambda P, x, m: P.masked_select(x, m), [N(3, 4), B(3, 4)]),
    C("masked_scatter", lambda P, x, m, v: P.masked_scatter(x, m, v), [N(3, 4), B(3, 4),
                                                                        N(12)]),
    C("unique", lambda P, x: P.unique(x, return_index=True, return_inverse=True,
                                      return_counts=True), [I((10,), 0, 5)], low=False),
    C("unique_float", lambda P, x: P.unique(x), [A([2.0, 1.0, 2.0, 3.0])], grad=False),
    C("unique_consecutive", lambda P, x: P.unique_consecutive(
        x, return_inverse=True, return_counts=True), [A([1, 1, 2, 2, 3, 1, 1])], low=False),
    C("atleast", lambda P, x: [P.atleast_1d(x), P.atleast_2d(x), P.atleast_3d(x)],
      [N(3)], grad=False),
    C("crop", lambda P, x: P.crop(x, [2, -1], [1, 1]), [N(4, 5)]),
    C("shard_index", lambda P, x: P.shard_index(x, 20, 2, 1), [I((6, 1), 0, 20)], low=False),
    C("reshape_", lambda P, x: P.reshape_(x, [4, 3]), [N(3, 4)], low=False, grad=False),
    C("scatter_", lambda P, x, i, u: P.scatter_(x, i, u), [N(4, 2), A([1, 3]), N(2, 2)],
      low=False, grad=False),
    C("squeeze_unsqueeze_", lambda P, x: [P.squeeze_(x, 0), P.unsqueeze_(x, 1)],
      [N(1, 3)], low=False, grad=False),
    # ---- search ----
    C("argmax_all", lambda P, x: P.argmax(x), [N(3, 4)]),
    C("argmax_axis", lambda P, x: P.argmax(x, axis=1, keepdim=True), [N(3, 4)]),
    C("argmin", lambda P, x: P.argmin(x, axis=0), [N(3, 4)]),
    C("argmax_int32", lambda P, x: P.argmax(x, axis=1, dtype="int32"), [N(3, 4)],
      low=False),
    C("argsort", lambda P, x: P.argsort(x, axis=1), [N(3, 5)]),
    C("argsort_desc", lambda P, x: P.argsort(x, axis=0, descending=True), [N(4, 3)]),
    C("sort", lambda P, x: P.sort(x, axis=1, descending=True), [N(3, 5)]),
    C("topk", lambda P, x: P.topk(x, 2), [N(3, 5)]),
    C("topk_smallest_axis0", lambda P, x: P.topk(x, 2, axis=0, largest=False), [N(4, 3)]),
    C("kthvalue", lambda P, x: P.kthvalue(x, 2, axis=1), [N(3, 5)]),
    C("kthvalue_keepdim", lambda P, x: P.kthvalue(x, 3, axis=0, keepdim=True), [N(4, 3)]),
    C("mode", lambda P, x: P.mode(x, axis=1), [A([[1.0, 2.0, 2.0, 3.0, 3.0],
                                                  [4.0, 4.0, 1.0, 4.0, 0.0]])]),
    C("searchsorted", lambda P, s, v: P.searchsorted(s, v), [A([1.0, 3.0, 5.0, 7.0]),
                                                             A([0.0, 3.0, 6.0, 9.0])]),
    C("searchsorted_right_int32", lambda P, s, v: P.searchsorted(s, v, out_int32=True,
                                                                 right=True),
      [A([[1.0, 3.0, 5.0], [2.0, 4.0, 6.0]]), A([[3.0, 5.0], [1.0, 6.0]])]),
    C("bucketize", lambda P, x, s: P.bucketize(x, s), [A([0.5, 3.0, 8.0]),
                                                       A([1.0, 3.0, 5.0])]),
    # ---- matrix products, einsum ----
    C("matmul", lambda P, x, y: P.matmul(x, y), [N(3, 4), N(4, 5)]),
    C("matmul_batched", lambda P, x, y: P.matmul(x, y), [N(2, 3, 4), N(4, 5)]),
    C("matmul_transpose", lambda P, x, y: P.matmul(x, y, transpose_x=True, transpose_y=True),
      [N(2, 4, 3), N(2, 5, 4)]),
    C("matmul_vector", lambda P, x, y: P.matmul(x, y), [N(3, 4), N(4)]),
    C("mm", lambda P, x, y: P.mm(x, y), [N(3, 4), N(4, 2)]),
    C("bmm", lambda P, x, y: P.bmm(x, y), [N(2, 3, 4), N(2, 4, 5)]),
    C("mv", lambda P, x, y: P.mv(x, y), [N(3, 4), N(4)]),
    C("multi_dot", lambda P, a, b, c: P.multi_dot([a, b, c]), [N(2, 3), N(3, 4), N(4, 2)]),
    C("einsum", lambda P, x, y: P.einsum("bij,bjk->bik", x, y), [N(2, 3, 4), N(2, 4, 5)]),
    C("einsum_trace", lambda P, x: P.einsum("ii->", x), [N(3, 3)]),
    # ---- ROADMAP Queue C Open 2: an empty axis list reduces no axis ----
    C("sum_axis_empty", lambda P, x: P.sum(x, axis=[]), [N(2, 3)]),
    C("sum_axis_empty_keepdim", lambda P, x: P.sum(x, axis=[], keepdim=True), [N(2, 3)]),
    C("mean_axis_empty", lambda P, x: P.mean(x, axis=[]), [N(2, 3)]),
    C("max_axis_empty", lambda P, x: P.max(x, axis=[]), [N(2, 3)]),
    C("min_axis_empty", lambda P, x: P.min(x, axis=[]), [N(2, 3)]),
    C("amax_amin_axis_empty", lambda P, x: [P.amax(x, axis=[]), P.amin(x, axis=())],
      [N(2, 3)]),
    C("std_var_axis_empty", lambda P, x: [P.std(x, axis=[], unbiased=False),
                                          P.var(x, axis=[], unbiased=False)], [N(2, 3)],
      grad=False),
    C("logsumexp_axis_empty", lambda P, x: P.logsumexp(x, axis=[]), [N(2, 3)]),
    C("sum_axis_empty_int32", lambda P, x: P.sum(P.cast(x, "int32"), axis=[]),
      [I((2, 3), -5, 5)], low=False),
    # ---- Open 3: running sums and products keep the integer dtype ----
    C("cumsum_int32", lambda P, x: P.cumsum(P.cast(x, "int32")), [A([1, 2, 3])], low=False),
    C("cumsum_int32_axis", lambda P, x: P.cumsum(P.cast(x, "int32"), axis=1),
      [I((2, 3), -4, 4)], low=False),
    C("cumprod_int32", lambda P, x: P.cumprod(P.cast(x, "int32"), dim=0), [A([1, 2, 3])],
      low=False),
    C("cumsum_int32_dtype", lambda P, x: [P.cumsum(P.cast(x, "int32"), dtype="int64"),
                                          P.cumprod(P.cast(x, "int32"), dim=0,
                                                    dtype="float32")],
      [A([1, 2, 3])], low=False),
    C("cumsum_bool", lambda P, x: P.cumsum(x), [B(5)], low=False),
    # ---- Open 4: int64 into floating ops gives float64 (int32 float32) ----
    C("mean_arange", lambda P: P.mean(P.arange(4)), low=False),
    C("sqrt_int64_scalar", lambda P: P.sqrt(P.to_tensor(4, place="cpu")), low=False),
    C("divide_int64", lambda P, x, y: P.divide(x, y), [A([1, 2, 4]), A([2, 4, 3])],
      low=False),
    C("divide_int32", lambda P, x, y: P.divide(P.cast(x, "int32"), P.cast(y, "int32")),
      [A([1, 2, 4]), A([2, 4, 3])], low=False),
    C("unary_int64", lambda P, x: [getattr(P, f)(x) for f in (
        "exp", "expm1", "log", "log2", "log10", "log1p", "sqrt", "sin", "cos", "tan",
        "atan", "sinh", "cosh", "tanh", "asinh", "erf", "reciprocal", "lgamma", "digamma",
        "i0", "deg2rad", "stanh")], [A([1, 2, 4])], low=False),
    C("unary_int32", lambda P, x: [getattr(P, f)(P.cast(x, "int32")) for f in (
        "exp", "log", "sqrt", "sin", "tanh", "erf", "lgamma", "i0", "deg2rad",
        "reciprocal", "stanh")], [A([1, 2, 4])], low=False),
    C("reductions_int64", lambda P, x: [P.var(x), P.std(x), P.median(x), P.nanmean(x),
                                        P.logsumexp(x), P.quantile(x, 0.5),
                                        P.mean(x, axis=0)], [A([1, 2, 4, 7])], low=False),
    C("reductions_int32", lambda P, x: [f(P.cast(x, "int32")) for f in (
        P.var, P.std, P.median, P.nanmean, P.logsumexp, P.mean)], [A([1, 2, 4, 7])],
      low=False),
    C("binary_int64", lambda P, x, y: [P.hypot(x, y), P.atan2(x, y), P.logaddexp(x, y),
                                       P.nextafter(x, y), P.heaviside(x, y)],
      [A([1, 2, 4]), A([3, 0, 5])], low=False),
    C("binary_int32", lambda P, x, y: [f(P.cast(x, "int32"), P.cast(y, "int32")) for f in (
        P.hypot, P.atan2, P.logaddexp, P.nextafter, P.heaviside)],
      [A([1, 2, 4]), A([3, 0, 5])], low=False),
    C("addmm_trapezoid_int64", lambda P, m, x, y: [P.addmm(m, x, y), P.trapezoid(x[0])],
      [A([[1, 2], [3, 4]]), A([[1, 2], [0, 1]]), A([[2, 1], [1, 3]])], low=False),
    # ---- Open 5: operands of different dtypes promote as jnp.promote_types ----
    C("add_bf16_zero_d_f32", lambda P, x, s: P.add(P.cast(x, "bfloat16"), s),
      [N(3), A(np.float32(1.5))], low=False),
    C("binary_f16_zero_d_f32", lambda P, x, s: [
        P.multiply(P.cast(x, "float16"), s), P.maximum(P.cast(x, "float16"), s),
        P.subtract(s, P.cast(x, "bfloat16")), P.divide(P.cast(x, "bfloat16"), s)],
      [N(3), A(np.float32(0.25))], low=False),
    C("pow_bf16_zero_d_f32", lambda P, x, s: P.pow(P.cast(x, "bfloat16"), s),
      [U((3,), 0.5, 2.0), A(np.float32(2.0))], low=False),
    C("where_bf16_f32", lambda P, m, x, s: P.where(m, P.cast(x, "bfloat16"), s),
      [B(3), N(3), A(np.float32(-1.0))], low=False),
    C("add_int32_zero_d_int64", lambda P, x, s: P.add(P.cast(x, "int32"), s),
      [I((3,), -5, 5), A(np.int64(7))], low=False),
    C("matmul_f16_f32", lambda P, x, y: P.matmul(P.cast(x, "float16"), y),
      [N(1, 3), N(3, 1)], low=False),
    C("matmul_f16_bf16", lambda P, x, y: P.matmul(P.cast(x, "float16"),
                                                 P.cast(y, "bfloat16")),
      [N(1, 3), N(3, 1)], low=False),
]


# -- running a case in one package -------------------------------------------
def _tensor(P, a, grad):
    floating = np.issubdtype(a.dtype, np.floating)
    return P.to_tensor(a, place="cpu", stop_gradient=not (grad and floating))


def _flat(out):
    if isinstance(out, (list, tuple)):
        return [o for x in out for o in _flat(x)]
    return [out]


def _np(t):
    if isinstance(t, torch.Tensor):
        t = t.detach()
        if t.dtype in (torch.bfloat16, torch.float16):
            t = t.float()
        return t.numpy()
    if hasattr(t, "numpy"):
        arr = np.asarray(t.numpy())
        return arr.astype(np.float32) if arr.dtype.name in ("bfloat16", "float16") else arr
    return np.asarray(t)


def _dtype(t):
    if isinstance(t, torch.Tensor):
        return str(t.dtype).removeprefix("torch.")
    if hasattr(t, "dtype"):
        return np.dtype(t.dtype).name
    return type(t).__name__


def _is_float(t):
    return _dtype(t) in ("float16", "bfloat16", "float32", "float64")


def _run(P, fn, arrays, grad, low, cts):
    xs = [_tensor(P, a, grad) for a in arrays]
    args = xs
    if low:
        args = [P.cast(x, "bfloat16") if np.issubdtype(a.dtype, np.floating) else x
                for x, a in zip(xs, arrays)]
    outs = _flat(fn(P, *args))
    grads = None
    if grad:
        floats = [o for o in outs if _is_float(o)]
        loss = None
        for o, ct in zip(floats, cts):
            term = P.sum(P.multiply(o, P.to_tensor(ct.reshape(_np(o).shape), place="cpu")))
            loss = term if loss is None else P.add(loss, term)
        loss.backward()
        grads = [_np(x.grad) if x.grad is not None else None for x in xs
                 if _dtype(x).startswith("float")]
    return outs, grads


def _arrays(inputs, seed):
    rng = np.random.RandomState(seed)
    return [_make(s, rng) for s in inputs]


def _case_seed(fn):
    return abs(hash(fn.__code__.co_firstlineno)) % (2 ** 31)


@pytest.mark.parametrize("fn,inputs,low,grad,rtol,atol", CASES)
def test_op_matches_jax(fn, inputs, low, grad, rtol, atol):
    seed = _case_seed(fn)
    arrays = _arrays(inputs, seed)
    rng = np.random.RandomState(seed + 1)
    cts = [rng.standard_normal(64).astype(np.float32) for _ in range(8)]
    jout, jgrads = _run(paddle, fn, arrays, False, False, None)
    tout, _ = _run(T, fn, arrays, False, False, None)
    assert len(jout) == len(tout)
    for j, t in zip(jout, tout):
        assert _dtype(t) == _dtype(j)
        np.testing.assert_allclose(_np(t), _np(j), rtol=rtol, atol=atol)
    if grad and any(np.issubdtype(a.dtype, np.floating) for a in arrays) and any(
            _is_float(o) for o in jout):
        # the cotangent of each floating output: the first numel values of
        # its own random vector
        shaped = [c[:_np(o).size] for c, o in zip(cts, [o for o in jout if _is_float(o)])]
        _, jgrads = _run(paddle, fn, arrays, True, False, shaped)
        _, tgrads = _run(T, fn, arrays, True, False, shaped)
        assert len(jgrads) == len(tgrads)
        for jg, tg in zip(jgrads, tgrads):
            if jg is None:
                assert tg is None or not np.any(tg)
                continue
            np.testing.assert_allclose(tg, jg, rtol=rtol, atol=atol)


LOW_CASES = [c for c in CASES if c.values[2]]


@pytest.mark.parametrize("fn,inputs,low,grad,rtol,atol", LOW_CASES)
def test_op_matches_jax_bfloat16(fn, inputs, low, grad, rtol, atol):
    arrays = _arrays(inputs, _case_seed(fn))
    jout, _ = _run(paddle, fn, arrays, False, True, None)
    tout, _ = _run(T, fn, arrays, False, True, None)
    assert len(jout) == len(tout)
    for j, t in zip(jout, tout):
        assert _dtype(t) == _dtype(j)
        np.testing.assert_allclose(_np(t), _np(j), rtol=BF16_RTOL, atol=BF16_ATOL)


@pytest.mark.parametrize("name", ["rsqrt", "sigmoid"])
@pytest.mark.parametrize("dtype", ["int32", "int64", "bool"])
def test_integer_inputs_raise_where_jax_raises(name, dtype):
    """ROADMAP Queue C Open 4: jax's rsqrt and sigmoid refuse integer (and
    bool) inputs with TypeError; so do the port's."""
    x = np.array([1, 2, 4]).astype(dtype)
    for P in (paddle, T):
        with pytest.raises(TypeError):
            getattr(P, name)(P.to_tensor(x, place="cpu"))


class TestPaddleArguments:
    """Paddle's argument names and defaults, keyword by keyword."""

    def test_keywords(self):
        x = np.random.RandomState(0).standard_normal((3, 4)).astype(np.float32)
        for P in (paddle, T):
            t = P.to_tensor(x, place="cpu")
            assert list(P.sum(t, axis=1, keepdim=True).shape) == [3, 1]
            assert _dtype(P.sum(t, dtype="float64")) == "float64"
            assert _dtype(P.argmax(t, axis=1)) == "int64"
            assert _dtype(P.topk(t, k=2, axis=-1)[1]) == "int64"
            assert list(P.mean(t, axis=[0, 1], keepdim=True).shape) == [1, 1]
            assert [list(s.shape) for s in P.split(t, num_or_sections=[1, 3], axis=1)] == [
                [3, 1], [3, 3]]

    def test_cosmetic_name_keyword(self):
        x = np.ones((2, 2), np.float32)
        for P in (paddle, T):
            t = P.to_tensor(x, place="cpu")
            np.testing.assert_array_equal(_np(P.add(t, t, name="y")), 2 * x)
