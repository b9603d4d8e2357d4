"""The port's op surface (paddle.* tensor ops): the counterpart of
``paddle_tpu/ops/__init__.py``'s creation, math, reduction, manipulation,
search, matrix-product and einsum ops, each under the JAX op's name, the
registry (``_apply``) and the operators that launch the hand-written kernels
(``cuda``).

The samplers (``random_ops``), paddle's ``getitem``/``setitem_``
(``indexing``) and the linear-algebra half of ``linalg`` are here too. Not
ported yet, in ROADMAP Queue A item 6 (c): ``compat``, ``parity`` and
``fused``. The methods the JAX
package installs on its ``Tensor`` (``x.astype``, ``x.stop_gradient``, ...)
are not installed on ``torch.Tensor``: the port never patches torch, and
their function forms (``cast``, ...) are here.
"""
from __future__ import annotations

from ._apply import apply, apply_raw, defop, get_registry, register_op  # noqa: F401
from ..framework.core import to_tensor  # noqa: F401
from .creation import (  # noqa: F401
    arange, assign, clone, complex, diag, diag_embed, diagflat, empty, empty_like, eye, full,
    full_like, linspace, logspace, meshgrid, numel, ones, ones_like, polar, tril,
    tril_indices, triu, triu_indices, zeros, zeros_like,
)
from .math import (  # noqa: F401
    abs, acos, acosh, add, add_, addmm, allclose, angle, asin, asinh, atan, atan2, atanh,
    bitwise_and, bitwise_left_shift, bitwise_not, bitwise_or, bitwise_right_shift,
    bitwise_xor, ceil, clip, clip_, conj, copysign, cos, cosh, cross, cummax, cummin,
    cumprod, cumsum, deg2rad, digamma, divide, divide_, dot, equal, equal_all, erf, erfinv,
    exp, expm1, floor, floor_divide, floor_mod, fmax, fmin, frac, gcd, greater,
    greater_equal, greater_than, heaviside, hypot, i0, i0e, i1, i1e, imag, inner, isclose,
    isfinite, isinf, isnan, kron, lcm, ldexp, lerp, less, less_equal, less_than, lgamma,
    log, log1p, log2, log10, logaddexp, logcumsumexp, logical_and, logical_not, logical_or,
    logical_xor, logit, maximum, minimum, mod, multiplex, multiply, multiply_, nan_to_num,
    neg, negative, nextafter, not_equal, outer, pow, rad2deg, real, reciprocal, remainder,
    round, rsqrt, scale, scale_, sigmoid, sign, sin, sinh, sqrt, square, stanh, subtract,
    subtract_, tan, tanh, trace, diagonal, trapezoid, trunc, vander,
)
from .reduction import (  # noqa: F401
    all, amax, amin, any, count_nonzero, dist, logsumexp, max, mean, median, min, nanmean,
    nanmedian, nanquantile, nansum, norm, prod, quantile, std, sum, var,
)
from .manipulation import (  # noqa: F401
    as_strided, atleast_1d, atleast_2d, atleast_3d, broadcast_shape, broadcast_tensors,
    broadcast_to, cast, chunk, concat, crop, diff, expand, expand_as, flatten, flip, gather,
    gather_nd, index_add, index_fill, index_put, index_sample, index_select, masked_fill,
    masked_scatter, masked_select, moveaxis, nonzero, pad, repeat_interleave, reshape,
    reshape_, roll, rot90, scatter, scatter_, scatter_nd, scatter_nd_add, shard_index,
    slice, split, squeeze, squeeze_, stack, strided_slice, swapaxes, t, take_along_axis,
    tensor_split, tile, transpose, unbind, unique, unique_consecutive, unsqueeze,
    unsqueeze_, unstack, view, view_as, where, put_along_axis,
)
from .search import (  # noqa: F401
    argmax, argmin, argsort, bucketize, kthvalue, mode, searchsorted, sort, topk,
)
from .linalg import (  # noqa: F401
    bincount, bmm, cholesky, cholesky_inverse, cholesky_solve, cond, corrcoef, cov, det, eig,
    eigh, eigvals, eigvalsh, histogram, histogramdd, householder_product, inv, inverse,
    lstsq, lu, lu_unpack, matmul, matrix_exp, matrix_power, matrix_rank, mm, multi_dot, mv,
    pinv, qr, slogdet, solve, svd, svd_lowrank, triangular_solve,
)
from .random_ops import (  # noqa: F401
    bernoulli, bernoulli_, cauchy_, exponential_, geometric_, gumbel_softmax, log_normal_,
    multinomial, normal, normal_, poisson, rand, rand_like, randint, randint_like, randn,
    randn_like, randperm, standard_normal, uniform, uniform_,
)
from .indexing import getitem, setitem_  # noqa: F401
from .einsum_op import einsum  # noqa: F401
from .optable import generate_op_docs, op_table  # noqa: F401
