"""paddle.linalg for the port: the namespace of ``paddle_tpu/linalg.py``.

``matrix_transpose`` and ``vecdot`` are the JAX package's ``ops/compat.py``
ops of those names (the rest of that file is the port's ``ops/compat.py``).
``pca_lowrank`` draws its random projection from the device's default
generator (``framework/random.py``). ``fp8_fp8_half_gemm_fused`` keeps the
JAX arithmetic: both operands rounded to float8 e4m3, their product summed
in float32, then the bias and activation, then the output dtype.
"""
from __future__ import annotations

import torch

from .framework import dtype as dtype_mod
from .framework import random as rng
from .ops._apply import apply_raw, defop
from .ops.linalg import (  # noqa: F401
    cholesky, cholesky_inverse, cholesky_solve, cond, corrcoef, cov, det, eig, eigh, eigvals,
    eigvalsh, householder_product, inv, lstsq, lu, lu_unpack, matmul, matrix_exp,
    matrix_power, matrix_rank, multi_dot, pinv, qr, slogdet, solve, svd, svd_lowrank,
    triangular_solve,
)
from .ops.math import cross, diagonal  # noqa: F401
from .ops.reduction import norm  # noqa: F401


@defop("matrix_transpose")
def matrix_transpose(x):
    return x.transpose(-1, -2)


@defop("vecdot")
def vecdot(x, y, axis=-1):
    return torch.sum(x * y, dim=axis)


def vector_norm(x, p=2.0, axis=None, keepdim=False, name=None):
    """Entry-wise p-norm (``paddle.norm``)."""
    return norm(x, p=p, axis=axis, keepdim=keepdim)


def matrix_norm(x, p="fro", axis=(-2, -1), keepdim=False, name=None):
    """fro / nuc / +-1 / +-2 / +-inf over the trailing matrix dims."""
    return torch.linalg.matrix_norm(x, ord=p, dim=tuple(axis), keepdim=keepdim)


def svdvals(x, name=None):
    return torch.linalg.svdvals(x)


def ormqr(x, tau, other, left=True, transpose=False, name=None):
    """Multiply ``other`` by Q of a Householder QR (``geqrf``'s output)."""
    q = householder_product(x, tau)
    if transpose:
        q = q.transpose(-1, -2)
    return q @ other if left else other @ q


def pca_lowrank(x, q=None, center=True, niter=2, name=None):
    """Randomized PCA: (U, S, V) of the centered matrix, as the JAX
    package's (a Gaussian range finder, ``niter`` power iterations)."""
    m, n = x.shape[-2], x.shape[-1]
    if q is None:
        q = min(6, m, n)
    v = x - x.mean(dim=-2, keepdim=True) if center else x
    gen = None if torch.compiler.is_compiling() else rng.generator(x.device)
    omega = torch.randn(tuple(v.shape[:-2]) + (n, q), dtype=v.dtype, device=v.device,
                        generator=gen)
    y = v @ omega
    for _ in range(niter):
        y = v @ (v.transpose(-1, -2) @ y)
    Q, _ = torch.linalg.qr(y)
    u_b, s, vt = torch.linalg.svd(Q.transpose(-1, -2) @ v, full_matrices=False)
    return Q @ u_b, s, vt.transpose(-1, -2)


def fp8_fp8_half_gemm_fused(x, y, transpose_x=False, transpose_y=False, bias=None,
                            scale=1.0, output_dtype="float16", activation_type="identity",
                            name=None):
    """fp8 x fp8 -> half GEMM (the module's docstring)."""
    out_dt = dtype_mod.convert_dtype(output_dtype)

    def fn(a, b, *rest):
        a8 = a.to(torch.float8_e4m3fn).float()
        b8 = b.to(torch.float8_e4m3fn).float()
        if transpose_x:
            a8 = a8.transpose(-1, -2)
        if transpose_y:
            b8 = b8.transpose(-1, -2)
        nbatch = max(a8.dim(), b8.dim()) - 2
        if a8.dim() != b8.dim() or any(a8.shape[i] != b8.shape[i] for i in range(nbatch)):
            raise ValueError("fp8_fp8_half_gemm_fused needs matching batch dims: "
                             f"{tuple(a8.shape)} vs {tuple(b8.shape)}")
        out = torch.matmul(a8, b8) * scale
        if rest:
            out = out + rest[0].float()
        if activation_type == "gelu":
            out = torch.nn.functional.gelu(out, approximate="tanh")
        elif activation_type == "relu":
            out = torch.relu(out)
        return out.to(out_dt)

    args = [x, y] + ([bias] if bias is not None else [])
    return apply_raw("fp8_fp8_half_gemm_fused", fn, args)[0]
