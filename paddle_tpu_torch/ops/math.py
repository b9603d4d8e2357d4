"""Elementwise and binary math, comparison, logical and bitwise ops: the port
of ``paddle_tpu/ops/math.py``.

Each op is one or a few torch calls under the JAX op's name. A Python number
on the right of a binary op keeps the tensor's dtype (JAX's weak typing,
torch's scalar promotion), except that a float next to an integer tensor
gives the default float dtype. Two tensor operands of different dtypes are
promoted with ``framework/dtype.py`` ``promote_types`` (``jnp.promote_types``)
before torch sees them: torch lets a dimensioned operand's dtype win over a
0-d tensor's of the same kind, JAX does not. The floating ops take integer
and bool inputs in JAX's floating dtype (``_float``: the JAX package runs
with x64, so int64 gives float64 and narrower integers float32); ``rsqrt``
and ``sigmoid`` refuse them with ``TypeError``, as jax does. The in-place
forms (``add_``, ...) write the result into ``x`` with ``copy_``, which
autograd records.
"""
from __future__ import annotations

import torch

from ..framework import dtype as dtype_mod
from ._apply import defop


def _float(x):
    """``x`` in JAX's floating dtype for it: floating and complex tensors as
    they are, int64 (and uint64) as float64, other integers and bool as
    float32."""
    if x.is_floating_point() or x.is_complex():
        return x
    return x.to(torch.float64 if x.dtype in (torch.int64, torch.uint64) else torch.float32)


def _float64(x):
    """Integer and bool inputs as float64: the JAX functions that combine
    them with a Python float (``1.0 / x``, ``scale_b * tanh(...)``) get
    x64's float64 whatever the integer's width."""
    return x if (x.is_floating_point() or x.is_complex()) else x.to(torch.float64)


def _floating_only(name, x):
    if not (x.is_floating_point() or x.is_complex()):
        raise TypeError(f"{name} does not accept dtype {str(x.dtype).removeprefix('torch.')}; "
                        "it takes floating inputs only")
    return x


def _pair(x, y):
    """Two tensor operands in their promoted dtype (a number is left to
    torch's weak promotion)."""
    if isinstance(x, torch.Tensor) and isinstance(y, torch.Tensor) and x.dtype != y.dtype:
        d = dtype_mod.promote_types(x.dtype, y.dtype)
        return x.to(d), y.to(d)
    return x, y


def _t(y, like):
    """``y`` as a tensor beside ``like`` (a number keeps ``like``'s dtype
    where it fits it)."""
    if isinstance(y, torch.Tensor):
        return y
    if isinstance(y, float) and not (like.is_floating_point() or like.is_complex()):
        return torch.full((), y, dtype=dtype_mod.get_default_dtype(), device=like.device)
    if isinstance(y, float) and like.is_floating_point():
        # out of the dtype's range: inf, as in JAX (CUDA's fill would raise)
        return torch.full((), y, dtype=torch.float64, device=like.device).to(like.dtype)
    return torch.full((), y, dtype=like.dtype, device=like.device)


# ---- binary arithmetic ----------------------------------------------------
@defop("add")
def add(x, y):
    return torch.add(*_pair(x, y))


@defop("subtract")
def subtract(x, y):
    return torch.subtract(*_pair(x, y))


@defop("multiply")
def multiply(x, y):
    return torch.multiply(*_pair(x, y))


@defop("divide")
def divide(x, y):
    x, y = _pair(x, y)
    if isinstance(y, torch.Tensor) and not (x.is_floating_point() or x.is_complex()):
        x, y = _float(x), _float(y)
    return torch.true_divide(x, y)


@defop("floor_divide")
def floor_divide(x, y):
    return torch.floor_divide(*_pair(x, y))


@defop("remainder")
def remainder(x, y):
    return torch.remainder(*_pair(x, y))


mod = remainder
floor_mod = remainder


@defop("pow")
def pow(x, y):  # noqa: A001
    return torch.pow(*_pair(x, y))


@defop("fmax")
def fmax(x, y):
    return torch.fmax(*_pair(x, _t(y, x)))


@defop("fmin")
def fmin(x, y):
    return torch.fmin(*_pair(x, _t(y, x)))


@defop("maximum")
def maximum(x, y):
    return torch.maximum(*_pair(x, _t(y, x)))


@defop("minimum")
def minimum(x, y):
    return torch.minimum(*_pair(x, _t(y, x)))


@defop("scale")
def _scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None):
    # a number outside x's dtype's range becomes inf, as in JAX (a CUDA
    # ``torch.full`` in that dtype raises instead of rounding)
    s = scale.to(x.dtype) if isinstance(scale, torch.Tensor) else torch.full(
        (), scale, dtype=torch.float64, device=x.device).to(x.dtype)
    b = torch.full((), bias, dtype=torch.float64, device=x.device).to(x.dtype)
    if bias_after_scale:
        return x * s + b
    return (x + b) * s


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None, name=None):
    if isinstance(scale, torch.Tensor):
        from .manipulation import cast

        s = cast(scale, x.dtype)
        if bias == 0.0:
            return multiply(x, s)
        b = torch.full((), bias, dtype=x.dtype, device=x.device)
        if bias_after_scale:
            return add(multiply(x, s), b)
        return multiply(add(x, b), s)
    return _scale(x, scale=float(scale), bias=float(bias), bias_after_scale=bias_after_scale)


@defop("lerp")
def lerp(x, y, weight):
    return x + weight * (y - x)


# ---- unary ----------------------------------------------------------------
def _unary(name, fn, differentiable=True, cast=None):
    if cast is not None:
        inner = fn

        def fn(x):
            return inner(cast(x))
    return defop(name, differentiable=differentiable)(fn)


exp = _unary("exp", lambda x: torch.exp(x), cast=_float)
expm1 = _unary("expm1", lambda x: torch.expm1(x), cast=_float)
log = _unary("log", lambda x: torch.log(x), cast=_float)
log2 = _unary("log2", lambda x: torch.log2(x), cast=_float)
log10 = _unary("log10", lambda x: torch.log10(x), cast=_float)
log1p = _unary("log1p", lambda x: torch.log1p(x), cast=_float)
sqrt = _unary("sqrt", lambda x: torch.sqrt(x), cast=_float)
rsqrt = _unary("rsqrt", lambda x: torch.rsqrt(_floating_only("rsqrt", x)))
square = _unary("square", lambda x: torch.square(x))
abs = _unary("abs", lambda x: torch.abs(x))  # noqa: A001
sign = _unary("sign", lambda x: torch.sign(x))
neg = _unary("neg", lambda x: torch.neg(x))
negative = neg
reciprocal = _unary("reciprocal", lambda x: 1.0 / x, cast=_float64)
floor = _unary("floor", lambda x: torch.floor(x))
ceil = _unary("ceil", lambda x: torch.ceil(x))
round = _unary("round", lambda x: torch.round(x))  # noqa: A001
trunc = _unary("trunc", lambda x: torch.trunc(x))
frac = _unary("frac", lambda x: x - torch.trunc(x))
sin = _unary("sin", lambda x: torch.sin(x), cast=_float)
cos = _unary("cos", lambda x: torch.cos(x), cast=_float)
tan = _unary("tan", lambda x: torch.tan(x), cast=_float)
asin = _unary("asin", lambda x: torch.asin(x), cast=_float)
acos = _unary("acos", lambda x: torch.acos(x), cast=_float)
atan = _unary("atan", lambda x: torch.atan(x), cast=_float)
sinh = _unary("sinh", lambda x: torch.sinh(x), cast=_float)
cosh = _unary("cosh", lambda x: torch.cosh(x), cast=_float)
tanh = _unary("tanh", lambda x: torch.tanh(x), cast=_float)
asinh = _unary("asinh", lambda x: torch.asinh(x), cast=_float)
acosh = _unary("acosh", lambda x: torch.acosh(x), cast=_float)
atanh = _unary("atanh", lambda x: torch.atanh(x), cast=_float)
erf = _unary("erf", lambda x: torch.erf(x), cast=_float)
erfinv = _unary("erfinv", lambda x: torch.erfinv(x), cast=_float)
sigmoid = _unary("sigmoid", lambda x: torch.sigmoid(_floating_only("sigmoid", x)))
digamma = _unary("digamma", lambda x: torch.digamma(x), cast=_float)
lgamma = _unary("lgamma", lambda x: torch.lgamma(x), cast=_float)
i0 = _unary("i0", lambda x: torch.special.i0(x), cast=_float)
i0e = _unary("i0e", lambda x: torch.special.i0e(x), cast=_float)
i1 = _unary("i1", lambda x: torch.special.i1(x), cast=_float)
i1e = _unary("i1e", lambda x: torch.special.i1e(x), cast=_float)
deg2rad = _unary("deg2rad", lambda x: torch.deg2rad(x), cast=_float)
rad2deg = _unary("rad2deg", lambda x: torch.rad2deg(x), cast=_float)
angle = _unary("angle", lambda x: torch.angle(x), cast=_float64)
conj = _unary("conj", lambda x: torch.conj_physical(x))
real = _unary("real", lambda x: torch.real(x))
imag = _unary("imag", lambda x: torch.imag(x) if x.is_complex() else torch.zeros_like(x))


@defop("atan2")
def atan2(x, y):
    x, y = _pair(x, _t(y, x))
    return torch.atan2(_float(x), _float(y))


@defop("logit")
def _logit(x, eps=None):
    x = _float64(x)
    if eps is not None:
        x = torch.clamp(x, eps, 1.0 - eps)
    return torch.log(x / (1.0 - x))


def logit(x, eps=None, name=None):
    return _logit(x, eps=eps)


@defop("logaddexp")
def logaddexp(x, y):
    x, y = _pair(x, _t(y, x))
    return torch.logaddexp(_float(x), _float(y))


@defop("clip")
def _clip(x, min=None, max=None):  # noqa: A002
    if min is None and max is None:
        return x.clone()
    return torch.clamp(x, min, max)


def clip(x, min=None, max=None, name=None):  # noqa: A002
    return _clip(x, min=min, max=max)


@defop("stanh")
def _stanh(x, scale_a=0.67, scale_b=1.7159):
    return scale_b * torch.tanh(scale_a * _float64(x))


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    return _stanh(x, scale_a=scale_a, scale_b=scale_b)


@defop("multiplex")
def _multiplex(inputs, index):
    stacked = torch.stack(list(inputs), dim=0)  # [n, batch, ...]
    idx = index.reshape(-1).long()
    return stacked[idx, torch.arange(stacked.shape[1], device=stacked.device)]


def multiplex(inputs, index, name=None):
    return _multiplex(list(inputs), index)


# ---- cumulative -----------------------------------------------------------
def _flat_axis(x, axis):
    return (x.reshape(-1), 0) if axis is None else (x, axis)


def _running_dtype(x):
    """The dtype of a running sum or product: the input's, as in JAX (torch
    widens integers to int64), and int64 for bool."""
    return torch.int64 if x.dtype == torch.bool else x.dtype


@defop("cumsum")
def _cumsum(x, axis=None):
    x, axis = _flat_axis(x, axis)
    return torch.cumsum(x, axis, dtype=_running_dtype(x))


def cumsum(x, axis=None, dtype=None, name=None):
    out = _cumsum(x, axis=axis)
    if dtype is None:
        return out
    from .manipulation import cast

    return cast(out, dtype)


@defop("cumprod")
def _cumprod(x, dim=None):
    x, dim = _flat_axis(x, dim)
    return torch.cumprod(x, dim, dtype=_running_dtype(x))


def cumprod(x, dim=None, dtype=None, name=None):
    out = _cumprod(x, dim=dim)
    if dtype is None:
        return out
    from .manipulation import cast

    return cast(out, dtype)


def _running_index(xx, vals, ax, dtype):
    """Index of the latest element equal to the running extreme (the JAX
    package's masked running max over positions)."""
    n = xx.shape[ax]
    shape = [-1 if i == ax % xx.dim() else 1 for i in range(xx.dim())]
    idx = torch.arange(n, device=xx.device).reshape(shape)
    masked = torch.where(xx == vals, idx, torch.full_like(idx, -1))
    return torch.cummax(masked.expand(xx.shape), ax).values.to(
        dtype_mod.convert_dtype(dtype))


@defop("cummax_val")
def _cummax(x, axis):
    return torch.cummax(x, axis).values


def cummax(x, axis=None, dtype="int64", name=None):
    ax = axis if axis is not None else 0
    xx = x if axis is not None else x.reshape(-1)
    vals = _cummax(xx, axis=ax)
    return vals, _running_index(xx.detach(), vals.detach(), ax, dtype)


@defop("cummin_val")
def _cummin(x, axis):
    return torch.cummin(x, axis).values


def cummin(x, axis=None, dtype="int64", name=None):
    ax = axis if axis is not None else 0
    xx = x if axis is not None else x.reshape(-1)
    vals = _cummin(xx, axis=ax)
    return vals, _running_index(xx.detach(), vals.detach(), ax, dtype)


@defop("logcumsumexp")
def _logcumsumexp(x, axis=None):
    return torch.logcumsumexp(x, axis if axis is not None else 0)


def logcumsumexp(x, axis=None, dtype=None, name=None):
    xx = x if axis is not None else x.reshape(-1)
    return _logcumsumexp(xx, axis=axis if axis is not None else 0)


# ---- nan handling ---------------------------------------------------------
isnan = _unary("isnan", lambda x: torch.isnan(x), differentiable=False)
isinf = _unary("isinf", lambda x: torch.isinf(x), differentiable=False)
isfinite = _unary("isfinite", lambda x: torch.isfinite(x), differentiable=False)


@defop("nan_to_num")
def _nan_to_num(x, nan=0.0, posinf=None, neginf=None):
    return torch.nan_to_num(x, nan=nan, posinf=posinf, neginf=neginf)


def nan_to_num(x, nan=0.0, posinf=None, neginf=None, name=None):
    return _nan_to_num(x, nan=nan, posinf=posinf, neginf=neginf)


# ---- comparison (non-differentiable, bool outputs) ------------------------
def _cmp(name, fn):
    return defop(name, differentiable=False)(fn)


equal = _cmp("equal", lambda x, y: torch.eq(x, y))
not_equal = _cmp("not_equal", lambda x, y: torch.ne(x, y))
less_than = _cmp("less_than", lambda x, y: torch.lt(x, y))
less_equal = _cmp("less_equal", lambda x, y: torch.le(x, y))
greater_than = _cmp("greater_than", lambda x, y: torch.gt(x, y))
greater_equal = _cmp("greater_equal", lambda x, y: torch.ge(x, y))
less = less_than
greater = greater_than


def equal_all(x, y, name=None):
    return torch.tensor(x.shape == y.shape and bool(torch.equal(x, y)), device=x.device)


@defop("allclose_op", differentiable=False)
def _allclose(x, y, rtol=1e-5, atol=1e-8, equal_nan=False):
    return torch.isclose(x, y, rtol=rtol, atol=atol, equal_nan=equal_nan).all()


def allclose(x, y, rtol=1e-5, atol=1e-8, equal_nan=False, name=None):
    return _allclose(x, y, rtol=float(rtol), atol=float(atol), equal_nan=equal_nan)


@defop("isclose_op", differentiable=False)
def _isclose(x, y, rtol=1e-5, atol=1e-8, equal_nan=False):
    return torch.isclose(x, y, rtol=rtol, atol=atol, equal_nan=equal_nan)


def isclose(x, y, rtol=1e-5, atol=1e-8, equal_nan=False, name=None):
    return _isclose(x, y, rtol=float(rtol), atol=float(atol), equal_nan=equal_nan)


logical_and = _cmp("logical_and", lambda x, y: torch.logical_and(x, y))
logical_or = _cmp("logical_or", lambda x, y: torch.logical_or(x, y))
logical_xor = _cmp("logical_xor", lambda x, y: torch.logical_xor(x, y))
logical_not = _cmp("logical_not", lambda x: torch.logical_not(x))
bitwise_and = _cmp("bitwise_and", lambda x, y: torch.bitwise_and(x, y))
bitwise_or = _cmp("bitwise_or", lambda x, y: torch.bitwise_or(x, y))
bitwise_xor = _cmp("bitwise_xor", lambda x, y: torch.bitwise_xor(x, y))
bitwise_not = _cmp("bitwise_not", lambda x: torch.bitwise_not(x))
bitwise_left_shift = _cmp("bitwise_left_shift", lambda x, y: torch.bitwise_left_shift(x, y))
bitwise_right_shift = _cmp("bitwise_right_shift",
                           lambda x, y: torch.bitwise_right_shift(x, y))


# ---- products / linear helpers -------------------------------------------
@defop("dot")
def dot(x, y):
    if x.dim() == 1:
        return torch.sum(x * y)
    return torch.sum(x * y, dim=-1)


@defop("inner")
def inner(x, y):
    return torch.inner(x, y)


@defop("outer")
def outer(x, y):
    return torch.outer(x.reshape(-1), y.reshape(-1))


@defop("cross")
def _cross(x, y, axis=-1):
    return torch.linalg.cross(x, y, dim=axis)


def cross(x, y, axis=9, name=None):
    if axis == 9:  # paddle's default: the first axis of size 3
        axis = next(i for i, s in enumerate(x.shape) if s == 3)
    return _cross(x, y, axis=axis)


@defop("kron")
def kron(x, y):
    return torch.kron(x, y)


@defop("trace_op")
def _trace(x, offset=0, axis1=0, axis2=1):
    return torch.diagonal(x, offset, axis1, axis2).sum(-1)


def trace(x, offset=0, axis1=0, axis2=1, name=None):
    return _trace(x, offset=int(offset), axis1=int(axis1), axis2=int(axis2))


@defop("diagonal")
def _diagonal(x, offset=0, axis1=0, axis2=1):
    return torch.diagonal(x, offset, axis1, axis2)


def diagonal(x, offset=0, axis1=0, axis2=1, name=None):
    return _diagonal(x, offset=int(offset), axis1=int(axis1), axis2=int(axis2))


@defop("addmm")
def _addmm(input, x, y, beta=1.0, alpha=1.0):  # noqa: A002
    x, y = _pair(x, y)
    if not (x.is_floating_point() or x.is_complex()):
        input, x, y = _float64(input), _float64(x), _float64(y)
    return beta * input + alpha * torch.matmul(x, y)


def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):  # noqa: A002
    return _addmm(input, x, y, beta=float(beta), alpha=float(alpha))


gcd = _cmp("gcd", lambda x, y: torch.gcd(x, _t(y, x)))
lcm = _cmp("lcm", lambda x, y: torch.lcm(x, _t(y, x)))


@defop("heaviside")
def heaviside(x, y):
    x, y = _pair(x, _t(y, x))
    x = _float(x)
    return torch.heaviside(x, y.to(x.dtype))


@defop("hypot")
def hypot(x, y):
    x, y = _pair(x, y)
    x, y = _float(x), _float(y)
    return torch.sqrt(x * x + y * y)


@defop("ldexp")
def ldexp(x, y):
    ft = torch.promote_types(x.dtype, torch.float32)
    return x * torch.exp2(y.to(ft))


@defop("copysign")
def copysign(x, y):
    x, y = _pair(x, _t(y, x))
    return torch.copysign(_float(x), _float(y))


@defop("nextafter", differentiable=False)
def nextafter(x, y):
    x, y = _pair(x, _t(y, x))
    return torch.nextafter(_float(x), _float(y))


@defop("trapezoid")
def _trapezoid(y, x=None, dx=1.0, axis=-1):
    y = _float(y)
    if x is not None:
        return torch.trapezoid(y, x, dim=axis)
    return torch.trapezoid(y, dx=dx, dim=axis)


def trapezoid(y, x=None, dx=None, axis=-1, name=None):
    return _trapezoid(y, x=x, dx=1.0 if dx is None else dx, axis=axis)


@defop("vander")
def _vander(x, n=None, increasing=False):
    n = x.shape[0] if n is None else n
    powers = torch.arange(n, dtype=x.dtype, device=x.device)
    return torch.pow(x.unsqueeze(-1), powers if increasing else powers.flip(0))


def vander(x, n=None, increasing=False, name=None):
    return _vander(x, n=n, increasing=increasing)


# ---- in-place forms (paddle's ``x.add_(y)``) -------------------------------
def _make_inplace(fn):
    def inplace(x, *args, **kwargs):
        x.copy_(fn(x, *args, **kwargs))
        return x

    inplace.__name__ = fn.__name__ + "_"
    return inplace


add_ = _make_inplace(add)
subtract_ = _make_inplace(subtract)
multiply_ = _make_inplace(multiply)
divide_ = _make_inplace(divide)
scale_ = _make_inplace(scale)
clip_ = _make_inplace(clip)
