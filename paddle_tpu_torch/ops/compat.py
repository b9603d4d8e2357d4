"""The rest of the top-level op surface: the port of ``paddle_tpu/ops/compat.py``.

numpy-family stacking and splitting, the scatter views, ``take``,
``unfold``, ``tensordot``, distances, the special functions, three samplers
and the generated in-place family, each under the JAX op's name and, where
the JAX function is a ``defop``, through the port's dispatch (``_apply``),
so the AMP cast, the NaN/Inf scan and the operator stats see it.
``matrix_transpose`` and ``vecdot`` are the ``linalg`` namespace's
(``paddle_tpu_torch/linalg.py``), bound at the top level by ``ops``.

Kept from the JAX functions where they surprise:

- ``take(mode="raise")`` clips, as ``"clip"`` does (the JAX function cannot
  raise inside a compiled program, and neither raises here);
- ``unfold`` puts the windows' count at ``axis`` and appends the window as
  the last axis (the reference ``Tensor.unfold`` layout, torch's too);
- ``cdist``/``pdist`` at p = 2 add 1e-30 under the square root, so equal
  points have a finite gradient;
- ``log_normal`` draws float64 by default (the JAX package runs with x64),
  and ``binomial`` samples in float64 and returns int64.

The samplers draw from the device's default generator
(``framework/random.py``), so ``paddle_tpu_torch.seed`` fixes them; their
streams differ from the JAX package's and their distributions agree.

The in-place family (``_INPLACE_NAMES``, the six special-function extras and
``less_``) is built by ``math._make_inplace``: the out-of-place op, then
``x.copy_`` (or, where the op changes the shape or the dtype, as ``cast_`` or
``equal_`` do, the result takes ``x``'s place, as the JAX package's
``_replace_value`` does). Gradients follow torch's autograd: the JAX
generator keeps the tensor's old tape node, so no gradient of ``sin_``
reaches its input there (ROADMAP Queue C, "Reference caveats").
"""
from __future__ import annotations

import itertools
import math as _math

import numpy as np
import torch

from ..framework import random as rng
from ._apply import defop
from .math import _float, _float64, _make_inplace, _pair


# -- stacking / splitting -----------------------------------------------------
def add_n(inputs, name=None):
    from .math import add

    out = inputs[0]
    for x in inputs[1:]:
        out = add(out, x)
    return out


def _seq(xs):
    return list(xs) if isinstance(xs, (list, tuple)) else [xs]


def hstack(x, name=None):
    from .manipulation import concat, stack

    xs = _seq(x)
    if xs[0].ndim == 0:
        return stack(xs)
    return concat(xs, axis=0 if xs[0].ndim == 1 else 1)


def vstack(x, name=None):
    from .manipulation import concat, reshape

    return concat([reshape(t, [1, -1]) if t.ndim <= 1 else t for t in _seq(x)], axis=0)


row_stack = vstack


def column_stack(x, name=None):
    from .manipulation import concat, reshape

    return concat([reshape(t, [-1, 1]) if t.ndim <= 1 else t for t in _seq(x)], axis=1)


def dstack(x, name=None):
    from .manipulation import concat, reshape

    out = []
    for t in _seq(x):
        if t.ndim == 1:
            t = reshape(t, [1, -1, 1])
        elif t.ndim == 2:
            t = reshape(t, list(t.shape) + [1])
        out.append(t)
    return concat(out, axis=2)


def hsplit(x, num_or_indices, name=None):
    from .manipulation import tensor_split

    return tensor_split(x, num_or_indices, axis=0 if x.ndim == 1 else 1)


def vsplit(x, num_or_indices, name=None):
    from .manipulation import tensor_split

    return tensor_split(x, num_or_indices, axis=0)


def dsplit(x, num_or_indices, name=None):
    from .manipulation import tensor_split

    return tensor_split(x, num_or_indices, axis=2)


@defop("block_diag")
def block_diag(inputs):
    xs = [torch.atleast_2d(x) for x in inputs]
    dt = xs[0].dtype
    for x in xs[1:]:
        dt = torch.promote_types(dt, x.dtype)
    return torch.block_diag(*[x.to(dt) for x in xs])


@defop("cartesian_prod")
def cartesian_prod(x):
    grids = torch.meshgrid(*list(x), indexing="ij")
    return torch.stack([g.reshape(-1) for g in grids], dim=-1)


def combinations(x, r=2, with_replacement=False, name=None):
    from .indexing import getitem
    from .manipulation import stack

    n = int(x.shape[0])
    idx = (itertools.combinations_with_replacement(range(n), r)
           if with_replacement else itertools.combinations(range(n), r))
    idx = np.array(list(idx), "int64").reshape(-1, r)
    rows = [getitem(x, torch.from_numpy(idx[:, j].copy()).to(x.device)) for j in range(r)]
    return stack(rows, axis=1)


# -- views / scatters ---------------------------------------------------------
@defop("diagonal_scatter")
def diagonal_scatter(x, y, offset=0, axis1=0, axis2=1):
    out = x.clone()
    out.diagonal(offset, axis1, axis2).copy_(y)
    return out


@defop("select_scatter")
def select_scatter(x, values, axis, index):
    out = x.clone()
    out.select(axis, index).copy_(values)
    return out


@defop("slice_scatter")
def slice_scatter(x, value, axes, starts, ends, strides):
    idx = [slice(None)] * x.ndim
    for ax, s, e, st in zip(axes, starts, ends, strides):
        idx[int(ax)] = slice(int(s), int(e), int(st))
    out = x.clone()
    out[tuple(idx)] = value.to(x.dtype) if isinstance(value, torch.Tensor) else value
    return out


@defop("take")
def take(x, index, mode="raise"):
    flat = x.reshape(-1)
    n = flat.shape[0]
    idx = index.to(torch.int64)
    if mode == "wrap":
        idx = torch.remainder(idx, n)
    else:  # "raise" clips as "clip" does (the module docstring)
        idx = torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)
    return flat[idx]


@defop("unflatten")
def unflatten(x, axis, shape):
    axis = axis % x.ndim
    new = list(x.shape[:axis]) + [int(s) for s in shape] + list(x.shape[axis + 1:])
    return x.reshape(new)


@defop("unfold")
def unfold(x, axis, size, step):
    # torch's layout is the reference's: (4, 5).unfold(1, 3, 2) -> (4, 2, 3)
    return x.unfold(axis % x.ndim, int(size), int(step))


def reverse(x, axis, name=None):
    from .manipulation import flip

    return flip(x, axis)


# -- math ---------------------------------------------------------------------
@defop("tensordot")
def tensordot(x, y, axes=2):
    x, y = _pair(x, y)
    if isinstance(axes, (list, tuple)):
        axes = [list(int(i) for i in a) if isinstance(a, (list, tuple)) else [int(a)]
                for a in axes]
    return torch.tensordot(x, y, dims=axes)


def _distance(diff, p):
    if p == 2.0:
        return torch.sqrt(torch.sum(diff * diff, dim=-1) + 1e-30)
    return torch.sum(torch.abs(diff) ** p, dim=-1) ** (1.0 / p)


@defop("cdist")
def cdist(x, y, p=2.0, compute_mode="use_mm_for_euclid_dist_if_necessary"):
    return _distance(x[..., :, None, :] - y[..., None, :, :], p)


@defop("pdist")
def pdist(x, p=2.0):
    iu, ju = np.triu_indices(x.shape[0], k=1)
    return _distance(x[torch.from_numpy(iu).to(x.device)]
                     - x[torch.from_numpy(ju).to(x.device)], p)


@defop("sinc")
def sinc(x):
    return torch.sinc(_float(x))


@defop("sgn")
def sgn(x):
    return torch.sgn(x)


@defop("signbit", differentiable=False)
def signbit(x):
    return torch.signbit(x)


@defop("positive")
def positive(x):
    return torch.positive(x)


@defop("frexp", differentiable=False)
def frexp(x):
    return tuple(torch.frexp(x))  # (mantissa, int32 exponent)


@defop("renorm")
def renorm(x, p, axis, max_norm):
    moved = torch.movedim(x, axis, 0)
    flat = moved.reshape(moved.shape[0], -1)
    norms = torch.sum(torch.abs(flat) ** p, dim=1) ** (1.0 / p)
    factor = torch.where(norms > max_norm, max_norm / (norms + 1e-7), 1.0)
    out = flat * factor[:, None]
    return torch.movedim(out.reshape(moved.shape), 0, axis)


@defop("cumulative_trapezoid")
def cumulative_trapezoid(y, x=None, dx=1.0, axis=-1):
    y0 = torch.movedim(_float64(y), axis, -1)
    avg = (y0[..., 1:] + y0[..., :-1]) / 2.0
    if x is not None:
        x = torch.as_tensor(x, device=y.device)
        xd = torch.diff(torch.movedim(x, axis, -1) if x.ndim > 1 else x, dim=-1)
        seg = avg * xd
    else:
        seg = avg * dx
    return torch.movedim(torch.cumsum(seg, dim=-1), -1, axis)


def _jax_linspace(lo, hi, num, dtype, device):
    """jnp.linspace's arithmetic: start * (1 - i/div) + stop * (i/div), the
    endpoint appended as stop itself."""
    lo = torch.as_tensor(lo, dtype=dtype, device=device)
    hi = torch.as_tensor(hi, dtype=dtype, device=device)
    if num == 1:
        return lo.reshape(1)
    div = num - 1
    step = torch.arange(div, dtype=dtype, device=device) / div
    return torch.cat([lo * (1 - step) + hi * step, hi.reshape(1)])


@defop("histogram_bin_edges", differentiable=False)
def histogram_bin_edges(x, bins=100, min=0.0, max=0.0):  # noqa: A002
    if min == 0.0 and max == 0.0:
        lo, hi = torch.min(x), torch.max(x)
        dt = x.dtype if x.is_floating_point() else torch.float64
    else:  # Python numbers: x64's float64
        lo, hi, dt = min, max, torch.float64
    return _jax_linspace(lo, hi, int(bins) + 1, dt, x.device)


@defop("isin", differentiable=False)
def isin(x, test_x, assume_unique=False, invert=False):
    return torch.isin(x, test_x, invert=invert)


@defop("isneginf", differentiable=False)
def isneginf(x):
    return torch.isneginf(x)


@defop("isposinf", differentiable=False)
def isposinf(x):
    return torch.isposinf(x)


@defop("isreal", differentiable=False)
def isreal(x):
    return torch.isreal(x)


def is_empty(x, name=None):
    return torch.tensor(x.numel() == 0, device=x.device)


@defop("as_complex")
def as_complex(x):
    return torch.complex(x[..., 0], x[..., 1])


@defop("as_real")
def as_real(x):
    return torch.stack([torch.real(x), torch.imag(x)], dim=-1)


# -- special functions --------------------------------------------------------
@defop("gammaln")
def gammaln(x):
    return torch.special.gammaln(_float(x))


@defop("gammainc")
def gammainc(x, y):
    return torch.special.gammainc(*_pair(_float(x), _float(y)))


@defop("gammaincc")
def gammaincc(x, y):
    return torch.special.gammaincc(*_pair(_float(x), _float(y)))


@defop("multigammaln")
def multigammaln(x, p):
    x = _float64(x)
    j = torch.arange(1, p + 1, dtype=x.dtype, device=x.device)
    return (p * (p - 1) / 4.0) * _math.log(_math.pi) + torch.sum(
        torch.special.gammaln(x[..., None] + (1.0 - j) / 2.0), dim=-1)


@defop("polygamma")
def polygamma(x, n):
    x, n = _float(x), int(n)
    if n == 0:
        return torch.special.digamma(x)
    # (-1)^(n+1) n! zeta(n + 1, x), the JAX function's route: torch's own
    # n = 1 (its trigamma) reads 4e-10 relative from it at float64
    return ((-1) ** (n + 1) * _math.factorial(n)) * torch.special.zeta(float(n + 1), x)


# -- samplers -----------------------------------------------------------------
def _device_of(*xs):
    from .. import resolve_device

    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    return resolve_device(None)


def standard_gamma(x, name=None):
    with torch.no_grad():
        return torch._standard_gamma(x, generator=rng.generator(x.device))


def binomial(count, prob, name=None):
    dev = _device_of(count, prob)
    # float64 inside, int64 out, as the JAX function samples
    c = torch.as_tensor(count, device=dev).to(torch.float64)
    p = torch.as_tensor(prob, device=dev).to(torch.float64)
    c, p = torch.broadcast_tensors(c, p)
    return torch.binomial(c.contiguous(), p.contiguous(),
                          generator=rng.generator(dev)).to(torch.int64)


def log_normal(mean=1.0, std=2.0, shape=None, name=None):
    dev = _device_of()
    z = torch.randn(tuple(int(s) for s in (shape or [])), dtype=torch.float64, device=dev,
                    generator=rng.generator(dev))
    return torch.exp(mean + std * z)


# -- misc ---------------------------------------------------------------------
def set_printoptions(precision=None, threshold=None, edgeitems=None,
                     sci_mode=None, linewidth=None):
    """How tensors print: ``torch.set_printoptions`` with the knobs given (the
    JAX package forwards them to numpy, which prints its tensors)."""
    kw = dict(precision=precision, threshold=threshold, edgeitems=edgeitems,
              linewidth=linewidth, sci_mode=sci_mode)
    torch.set_printoptions(**{k: v for k, v in kw.items() if v is not None})


def tolist(x):
    return x.tolist()


def to_dlpack(x):
    return torch.utils.dlpack.to_dlpack(x)


def from_dlpack(capsule):
    return torch.utils.dlpack.from_dlpack(capsule)


# -- the generated in-place family --------------------------------------------
_INPLACE_NAMES = [
    "abs", "acos", "atan", "bitwise_and", "bitwise_not", "bitwise_or",
    "bitwise_xor", "bitwise_left_shift", "bitwise_right_shift", "cast",
    "copysign", "cos", "cumprod", "cumsum", "digamma", "equal", "erf",
    "expm1", "flatten", "floor_divide", "floor_mod", "frac", "gcd",
    "greater_equal", "greater_than", "hypot", "i0", "lcm", "ldexp",
    "less_equal", "less_than", "lgamma", "log", "log10", "log2",
    "logical_and", "logical_not", "logical_or", "logit", "masked_fill",
    "masked_scatter", "mod", "nan_to_num", "neg", "pow", "remainder",
    "sin", "sinh", "square", "t", "tan", "tanh", "transpose", "tril",
    "triu", "trunc", "where",
]


def _install_inplace(namespace):
    """``name_`` for each of ``_INPLACE_NAMES`` the namespace has and whose
    in-place form it lacks, the six special-function extras and ``less_``."""
    made = {}
    for name in _INPLACE_NAMES:
        fn = namespace.get(name)
        if callable(fn) and name + "_" not in namespace:
            made[name + "_"] = _make_inplace(fn)
    for fn in (gammaln, gammainc, gammaincc, multigammaln, polygamma, sinc):
        made.setdefault(fn.__name__ + "_", _make_inplace(fn))
    made.setdefault("less_", made.get("less_than_") or _make_inplace(namespace["less_than"]))
    return made
