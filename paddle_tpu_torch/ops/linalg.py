"""``paddle_tpu/ops/linalg.py`` for the port: the matrix products
(``matmul`` with ``transpose_x``/``transpose_y``, ``mm``, ``bmm``, ``mv``,
``multi_dot``; white-list ops under AMP) and the linear-algebra half
(decompositions, solvers, ``det``/``slogdet``, ``matrix_power``,
``matrix_rank``, ``cond``, ``matrix_exp``, ``householder_product``,
``corrcoef``/``cov``, ``histogram*`` and ``bincount``). ``dot`` is in
``ops/math.py``, as in the JAX package.

The products are cuBLAS's on the card; the decompositions are
``torch.linalg``'s (cuSOLVER/MAGMA on the card), as the JAX package's are
XLA's linalg ops, outside any Pallas kernel. Each op keeps the JAX op's
name and output conventions: ``slogdet`` stacks (sign, log|det|), ``lu``
returns 1-based int32 pivots, ``lstsq`` gives (solution, residuals, rank,
singular values) with residuals and singular values empty where numpy's
are, and ``eig``/``eigvals`` are complex.
Operands of different dtypes are promoted with ``framework/dtype.py``
``promote_types`` before the product (float16 with float32 gives float32),
inside the op, so an AMP cast of a white-list op still comes first.
"""
from __future__ import annotations

import numpy as np
import torch

from ..framework import dtype as dtype_mod
from ._apply import defop


def _promoted(x, y):
    """Both operands in their promoted dtype (``jnp.promote_types``')."""
    if x.dtype == y.dtype:
        return x, y
    d = dtype_mod.promote_types(x.dtype, y.dtype)
    return x.to(d), y.to(d)


@defop("matmul", amp_category="white")
def _matmul(x, y, transpose_x=False, transpose_y=False):
    if transpose_x and x.dim() > 1:
        x = x.transpose(-1, -2)
    if transpose_y and y.dim() > 1:
        y = y.transpose(-1, -2)
    return torch.matmul(*_promoted(x, y))


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    return _matmul(x, y, transpose_x=bool(transpose_x), transpose_y=bool(transpose_y))


mm = matmul


@defop("bmm", amp_category="white")
def bmm(x, y):
    return torch.matmul(*_promoted(x, y))


@defop("mv", amp_category="white")
def mv(x, vec):
    return torch.matmul(*_promoted(x, vec))


@defop("multi_dot", amp_category="white")
def _multi_dot(xs):
    return torch.linalg.multi_dot(list(xs))


def multi_dot(x, name=None):
    return _multi_dot(list(x))


# ---- decompositions ----------------------------------------------------------
def _mT(x):  # noqa: N802
    return x.transpose(-1, -2)


@defop("cholesky")
def _cholesky(x, upper=False):
    L = torch.linalg.cholesky(x)
    return _mT(L).conj() if upper else L


def cholesky(x, upper=False, name=None):
    return _cholesky(x, upper=bool(upper))


@defop("cholesky_solve")
def _cholesky_solve(x, y, upper=False):
    return torch.cholesky_solve(x, y, upper=upper)


def cholesky_solve(x, y, upper=False, name=None):
    """Solves A z = x for A = L L^H given its factor ``y`` (``upper``: y = L^H)."""
    return _cholesky_solve(x, y, upper=bool(upper))


@defop("cholesky_inverse")
def _cholesky_inverse(x, upper=False):
    return torch.cholesky_inverse(x, upper=upper)


def cholesky_inverse(x, upper=False, name=None):
    return _cholesky_inverse(x, upper=bool(upper))


@defop("qr")
def _qr(x, mode="reduced"):
    q, r = torch.linalg.qr(x, mode=mode)
    return q, r


def qr(x, mode="reduced", name=None):
    if mode == "r":
        return torch.linalg.qr(x.detach(), mode="r")[1]
    return _qr(x, mode=mode)


@defop("svd")
def _svd(x, full_matrices=False):
    u, s, vh = torch.linalg.svd(x, full_matrices=full_matrices)
    return u, s, vh


def svd(x, full_matrices=False, name=None):
    return _svd(x, full_matrices=bool(full_matrices))


def svd_lowrank(x, q=6, niter=2, M=None, name=None):  # noqa: N803
    """The JAX package's: the first ``q`` triplets of the full SVD, V (not
    V^H) as the third output."""
    u, s, vh = _svd(x, full_matrices=False)
    q = min(q, s.shape[-1])
    return u[..., :q], s[..., :q], _mT(vh)[..., :q]


@defop("eigh")
def _eigh(x, UPLO="L"):  # noqa: N803
    # jnp.linalg.eigh(symmetrize_input=True) reads the symmetric part
    w, v = torch.linalg.eigh((x + _mT(x).conj()) / 2)
    return w, v


def eigh(x, UPLO="L", name=None):  # noqa: N803
    return _eigh(x, UPLO=UPLO)


def eigvalsh(x, UPLO="L", name=None):  # noqa: N803
    return _eigh(x, UPLO=UPLO)[0]


def eig(x, name=None):
    """Eigenvalues and right eigenvectors (complex), not differentiable, as
    the JAX package's host-LAPACK ``eig``."""
    w, v = torch.linalg.eig(x.detach())
    return w, v


def eigvals(x, name=None):
    return torch.linalg.eigvals(x.detach())


@defop("inverse")
def inv(x):
    return torch.linalg.inv(x)


inverse = inv


@defop("pinv")
def _pinv(x, rcond=1e-15, hermitian=False):
    return torch.linalg.pinv(x, rtol=rcond, hermitian=hermitian)


def pinv(x, rcond=1e-15, hermitian=False, name=None):
    return _pinv(x, rcond=float(rcond), hermitian=bool(hermitian))


@defop("solve")
def solve(x, y):
    return torch.linalg.solve(*_promoted(x, y))


@defop("triangular_solve")
def _triangular_solve(x, y, upper=True, transpose=False, unitriangular=False):
    a = _mT(x) if transpose else x
    return torch.linalg.solve_triangular(a, y, upper=upper != transpose,
                                         unitriangular=unitriangular)


def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False, name=None):
    return _triangular_solve(x, y, upper=bool(upper), transpose=bool(transpose),
                             unitriangular=bool(unitriangular))


def lstsq(x, y, rcond=None, driver=None, name=None):
    """(solution, residuals, rank, singular values) of min ||x s - y||, as
    ``jnp.linalg.lstsq``: the pseudo-inverse's solution (SVD, singular
    values below ``rcond`` times the largest dropped), the squared norm of
    every column's residual (shape (1,) for a vector ``y``), and the rank
    (int64), on every device."""
    a, b = x.detach(), y.detach()
    m, n = a.shape[-2:]
    u, s, vh = torch.linalg.svd(a, full_matrices=False)
    eps = torch.finfo(s.dtype).eps
    keep = (s > 0) & (s >= (max(m, n) * eps if rcond is None else rcond) * s[..., :1])
    s_inv = torch.where(keep, 1.0 / torch.where(keep, s, torch.ones_like(s)), torch.zeros_like(s))
    vec = b.dim() == a.dim() - 1
    bb = b.unsqueeze(-1) if vec else b
    sol = _mT(vh).conj() @ (s_inv.unsqueeze(-1) * (_mT(u).conj() @ bb))
    res = ((bb - a @ sol).abs() ** 2).sum(-2)
    return (sol.squeeze(-1) if vec else sol), res, keep.sum(-1).to(torch.int64), s


def lu(x, pivot=True, get_infos=False, name=None):
    """(LU, pivots) with paddle's 1-based int32 pivots (and a 0 info)."""
    lu_mat, piv = torch.linalg.lu_factor(x.detach())
    piv = piv.to(torch.int32)
    if get_infos:
        return lu_mat, piv, torch.zeros((), dtype=torch.int32, device=x.device)
    return lu_mat, piv


def lu_unpack(x, y, unpack_ludata=True, unpack_pivots=True, name=None):
    """(P, L, U) from ``lu``'s output: x = P L U, P a permutation matrix."""
    P, L, U = torch.lu_unpack(x.detach(), y.to(torch.int32))
    return P, L, U


@defop("det")
def det(x):
    return torch.linalg.det(x)


@defop("slogdet")
def _slogdet(x):
    sign, logdet = torch.linalg.slogdet(x)
    return torch.stack([sign, logdet])


def slogdet(x, name=None):
    return _slogdet(x)


@defop("matrix_power")
def _matrix_power(x, n):
    return torch.linalg.matrix_power(x, n)


def matrix_power(x, n, name=None):
    return _matrix_power(x, n=int(n))


def matrix_rank(x, tol=None, hermitian=False, name=None):
    """The rank (int64): singular values above ``tol`` count (the JAX
    package passes it as ``jnp.linalg.matrix_rank``'s ``rtol``, which that
    function compares with the singular values as they are); without it,
    above ``max(m, n) * eps`` times the largest."""
    if isinstance(tol, torch.Tensor):
        tol = float(tol.item())
    if tol is None:
        r = torch.linalg.matrix_rank(x.detach(), hermitian=hermitian)
    else:
        r = torch.linalg.matrix_rank(x.detach(), atol=tol, rtol=0.0, hermitian=hermitian)
    return r.to(torch.int64)


def cond(x, p=None, name=None):
    return torch.linalg.cond(x.detach(), p=p)


@defop("matrix_exp")
def matrix_exp(x):
    return torch.linalg.matrix_exp(x)


@defop("householder_product")
def householder_product(x, tau):
    return torch.linalg.householder_product(x, tau)


@defop("corrcoef")
def _corrcoef(x, rowvar=True):
    return torch.corrcoef(x if rowvar else _mT(x))


def corrcoef(x, rowvar=True, name=None):
    return _corrcoef(x, rowvar=bool(rowvar))


@defop("cov")
def _cov(x, rowvar=True, ddof=True, fweights=None, aweights=None):
    return torch.cov(x if rowvar else _mT(x), correction=1 if ddof else 0,
                     fweights=fweights, aweights=aweights)


def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None, name=None):
    return _cov(x, rowvar=bool(rowvar), ddof=bool(ddof), fweights=fweights, aweights=aweights)


def _float_of(x):
    return x if x.is_floating_point() else x.to(torch.float64 if x.dtype == torch.int64
                                                else torch.float32)


@defop("histogram", differentiable=False)
def _histogram(x, bins=100, min=0, max=0, weight=None, density=False):  # noqa: A002
    xs = x.reshape(-1)
    rng = None if (min == 0 and max == 0) else (float(min), float(max))
    xf = _float_of(xs)
    if rng is None:
        rng = (float(xf.min()), float(xf.max()))
    idx, edges = _bin_index(xf, rng[0], rng[1], bins)
    w = (torch.ones_like(xf) if weight is None else weight.reshape(-1).to(xf.dtype))
    hist = torch.zeros(bins, dtype=w.dtype, device=x.device).index_add_(
        0, idx.clamp(min=0), torch.where(idx >= 0, w, torch.zeros_like(w)))
    if density:
        hist = hist / (hist.sum() * (edges[1:] - edges[:-1]))
    return hist


def histogram(x, bins=100, min=0, max=0, weight=None, density=False, name=None):  # noqa: A002
    """Counts (or weights, or a density) over ``bins`` equal bins of
    [min, max] (the data's range when both are 0), the last bin closed, as
    ``jnp.histogram``: float counts, in the input's float dtype."""
    return _histogram(x, bins=int(bins), min=min, max=max, weight=weight, density=density)


def _bin_index(v, lo, hi, bins):
    """The bin of each value of ``v`` among ``bins`` equal bins of [lo, hi]
    (the last bin closed), -1 outside."""
    edges = torch.linspace(lo, hi, bins + 1, dtype=v.dtype, device=v.device)
    idx = torch.searchsorted(edges, v.contiguous(), right=True) - 1
    idx = torch.where(v == edges[-1], torch.full_like(idx, bins - 1), idx)
    return torch.where((idx >= 0) & (idx < bins), idx, torch.full_like(idx, -1)), edges


def histogramdd(x, bins=10, ranges=None, density=False, weights=None, name=None):
    """``jnp.histogramdd`` over the rows of ``x`` (N, D): (hist, edges);
    ``ranges`` is one (min, max) pair a dim."""
    xf = _float_of(x.detach())
    D = xf.shape[-1]
    bins = [int(bins)] * D if isinstance(bins, (int, np.integer)) else [int(b) for b in bins]
    if ranges is None:
        ranges = [(float(xf[:, d].min()), float(xf[:, d].max())) for d in range(D)]
    else:
        r = [float(v) for v in np.asarray(ranges, dtype=np.float64).reshape(-1)]
        ranges = [(r[2 * d], r[2 * d + 1]) for d in range(D)]
    flat = torch.zeros(xf.shape[0], dtype=torch.int64, device=x.device)
    valid = torch.ones(xf.shape[0], dtype=torch.bool, device=x.device)
    edges = []
    for d in range(D):
        idx, e = _bin_index(xf[:, d], ranges[d][0], ranges[d][1], bins[d])
        edges.append(e)
        valid &= idx >= 0
        flat = flat * bins[d] + idx.clamp(min=0)
    w = torch.ones_like(xf[:, 0]) if weights is None else weights.detach().to(xf.dtype)
    hist = torch.zeros(int(np.prod(bins)), dtype=w.dtype, device=x.device).index_add_(
        0, flat, torch.where(valid, w, torch.zeros_like(w))).reshape(bins)
    if weights is None and not density:
        hist = hist.to(torch.int64)  # jnp.histogramdd counts in integers
    if density:
        vol = torch.ones((), dtype=w.dtype, device=x.device)
        for d, e in enumerate(edges):
            shape = [1] * D
            shape[d] = -1
            vol = vol * (e[1:] - e[:-1]).reshape(shape)
        hist = hist / (hist.sum() * vol)
    return hist, edges


@defop("bincount", differentiable=False)
def _bincount(x, weights=None, minlength=0):
    return torch.bincount(x, weights=weights, minlength=minlength)


def bincount(x, weights=None, minlength=0, name=None):
    """Counts of each value of a 1-D non-negative integer tensor, length
    ``max(x) + 1`` or ``minlength`` (int64 counts, or the weights' dtype)."""
    return _bincount(x, weights=weights, minlength=int(minlength))
