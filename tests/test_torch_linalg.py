"""The linear-algebra half of the port (``ops/linalg.py`` and the
``paddle_tpu_torch.linalg`` namespace) against the JAX package's, on the same
seeded numpy inputs.

The cases are the JAX package's own tables (tests/test_ops_numeric.py's
linalg OpCases and tests/test_ops_numeric_tail.py's solvers) and one more
for each function they leave out, written once and called with each package
as ``P``, through ``test_torch_ops.py``'s harness: outputs and dtypes at
float32 (rtol 1e-5 / atol 1e-6, op_test's; 1e-4 where a decomposition or a
solve of a 4 x 4 system rounds through a factorization whose LAPACK call
differs between the packages), and the gradients of ``sum(out * ct)``.
Following test_ops_numeric_tail.py's waivers, the sign-ambiguous factors
(``svd``, ``qr``, ``eig*``) are compared by reconstruction and by their
invariants (singular values, eigenvalues), not entry by entry.
"""
import numpy as np
import pytest
from test_torch_ops import A, C, I, N, U, _arrays, _case_seed, _dtype, _is_float, _np, _run

import paddle_tpu as paddle
import paddle_tpu_torch as T
from paddle_tpu_torch.device import _CURRENT

DECOMP_RTOL, DECOMP_ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True)
def _on_cpu():
    before = _CURRENT[0]
    T.set_device("cpu")
    yield
    _CURRENT[0] = before


SQ = (4, 4)
_SPD_A = np.random.RandomState(7).standard_normal((4, 4)).astype(np.float32)
_SPD = (_SPD_A @ _SPD_A.T + 4.0 * np.eye(4)).astype(np.float32)
_CHOL = np.linalg.cholesky(_SPD).astype(np.float32)


def _eye(P, n, scale):
    return P.scale(P.eye(n), scale=scale)


def _spd(P, x):
    return P.add(P.matmul(x, P.transpose(x, [1, 0])), _eye(P, 4, 2.0))


CASES = [
    # tests/test_ops_numeric.py:384-413
    C("cholesky", lambda P, x: P.linalg.cholesky(_spd(P, x)), [N(*SQ)], low=False,
      rtol=DECOMP_RTOL, atol=DECOMP_ATOL),
    C("cholesky_upper", lambda P, x: P.linalg.cholesky(_spd(P, x), upper=True), [N(*SQ)],
      low=False, rtol=DECOMP_RTOL, atol=DECOMP_ATOL),
    C("det", lambda P, x: P.linalg.det(P.add(x, _eye(P, 4, 3.0))), [N(*SQ)], low=False,
      rtol=DECOMP_RTOL, atol=DECOMP_ATOL),
    C("slogdet", lambda P, x: P.linalg.slogdet(P.add(x, _eye(P, 4, 3.0))), [N(*SQ)],
      low=False, grad=False, rtol=DECOMP_RTOL, atol=DECOMP_ATOL),
    C("inverse", lambda P, x: P.linalg.inv(_spd(P, x)), [N(*SQ)], low=False,
      rtol=DECOMP_RTOL, atol=DECOMP_ATOL),
    C("solve", lambda P, x, b: P.linalg.solve(P.add(x, _eye(P, 4, 3.0)), b),
      [N(*SQ), N(4, 2)], low=False, rtol=DECOMP_RTOL, atol=DECOMP_ATOL),
    C("triangular_solve", lambda P, x, b: P.linalg.triangular_solve(
        P.add(P.tril(x), _eye(P, 4, 2.0)), b, upper=False), [N(*SQ), N(4, 2)], low=False,
      rtol=DECOMP_RTOL, atol=DECOMP_ATOL),
    C("pinv", lambda P, x: P.linalg.pinv(x), [N(4, 3)], low=False, grad=False,
      rtol=DECOMP_RTOL, atol=DECOMP_ATOL),
    # tests/test_ops_numeric_tail.py:899-905
    C("cholesky_solve", lambda P, b: P.linalg.cholesky_solve(
        b, P.to_tensor(_CHOL, place="cpu"), upper=False), [N(4, 2)], low=False,
      rtol=DECOMP_RTOL, atol=DECOMP_ATOL),
    C("cholesky_inverse", lambda P, x: P.add(P.linalg.cholesky_inverse(
        P.to_tensor(_CHOL, place="cpu"), upper=False), P.scale(x, scale=0.0)), [N(4, 4)],
      low=False, grad=False, rtol=DECOMP_RTOL, atol=DECOMP_ATOL),
    # the rest of ops/linalg.py:68-339
    C("cholesky_solve_upper", lambda P, b: P.linalg.cholesky_solve(
        b, P.to_tensor(_CHOL.T.copy(), place="cpu"), upper=True), [N(4, 3)], low=False,
      rtol=DECOMP_RTOL, atol=DECOMP_ATOL),
    C("triangular_solve_transpose_unit", lambda P, x, b: P.linalg.triangular_solve(
        P.triu(x), b, upper=True, transpose=True, unitriangular=True), [N(*SQ), N(4, 2)],
      low=False, rtol=DECOMP_RTOL, atol=DECOMP_ATOL),
    C("solve_batched", lambda P, x, b: P.linalg.solve(P.add(x, _eye(P, 3, 4.0)), b),
      [N(2, 3, 3), N(2, 3, 2)], low=False, rtol=DECOMP_RTOL, atol=DECOMP_ATOL),
    C("det_batched", lambda P, x: P.linalg.det(x), [N(3, 3, 3)], low=False,
      rtol=DECOMP_RTOL, atol=DECOMP_ATOL),
    C("matrix_power", lambda P, x: P.linalg.matrix_power(x, 3), [N(*SQ)], low=False,
      rtol=DECOMP_RTOL, atol=DECOMP_ATOL),
    C("matrix_power_negative", lambda P, x: P.linalg.matrix_power(
        P.add(x, _eye(P, 4, 4.0)), -2), [N(*SQ)], low=False, rtol=DECOMP_RTOL,
      atol=DECOMP_ATOL),
    C("matrix_rank", lambda P, x: P.linalg.matrix_rank(x), [N(4, 3)], low=False, grad=False),
    C("matrix_rank_tol", lambda P, x: P.linalg.matrix_rank(
        P.matmul(x, P.transpose(x, [1, 0])), tol=0.5), [N(4, 2)], low=False, grad=False),
    C("cond", lambda P, x: P.linalg.cond(P.add(x, _eye(P, 4, 3.0))), [N(*SQ)], low=False,
      grad=False, rtol=DECOMP_RTOL, atol=DECOMP_ATOL),
    C("cond_fro", lambda P, x: P.linalg.cond(P.add(x, _eye(P, 4, 3.0)), p="fro"),
      [N(*SQ)], low=False, grad=False, rtol=DECOMP_RTOL, atol=DECOMP_ATOL),
    C("matrix_exp", lambda P, x: P.linalg.matrix_exp(P.scale(x, scale=0.3)), [N(*SQ)],
      low=False, rtol=DECOMP_RTOL, atol=DECOMP_ATOL),
    C("householder_product", lambda P, x, t: P.linalg.householder_product(x, t),
      [N(4, 3), N(3)], low=False, rtol=DECOMP_RTOL, atol=DECOMP_ATOL),
    C("corrcoef", lambda P, x: P.linalg.corrcoef(x), [N(3, 6)], low=False,
      rtol=DECOMP_RTOL, atol=DECOMP_ATOL),
    C("corrcoef_cols", lambda P, x: P.linalg.corrcoef(x, rowvar=False), [N(6, 3)],
      low=False, rtol=DECOMP_RTOL, atol=DECOMP_ATOL),
    C("cov", lambda P, x: P.linalg.cov(x), [N(3, 6)], low=False),
    C("cov_ddof0_cols", lambda P, x: P.linalg.cov(x, rowvar=False, ddof=False), [N(6, 3)],
      low=False),
    C("cov_weights", lambda P, x, f, a: P.linalg.cov(x, fweights=f, aweights=a),
      [N(2, 5), A(np.array([1, 2, 1, 3, 1])), U((5,), 0.5, 2.0)], low=False),
    C("histogram", lambda P, x: P.histogram(x, bins=5), [N(40)], low=False, grad=False),
    C("histogram_range_weight", lambda P, x, w: P.histogram(
        x, bins=4, min=-1, max=1, weight=w), [N(30), U((30,), 0, 1)], low=False, grad=False),
    C("histogram_density", lambda P, x: P.histogram(x, bins=6, density=True), [N(50)],
      low=False, grad=False, rtol=DECOMP_RTOL, atol=DECOMP_ATOL),
    C("histogramdd", lambda P, x: P.histogramdd(x, bins=3), [N(20, 2)], low=False,
      grad=False, rtol=DECOMP_RTOL, atol=DECOMP_ATOL),
    C("histogramdd_ranges", lambda P, x, w: P.histogramdd(
        x, bins=[2, 3], ranges=[[-1.0, 1.0], [-2.0, 2.0]], weights=w, density=True),
      [N(25, 2), U((25,), 0, 1)], low=False, grad=False, rtol=DECOMP_RTOL, atol=DECOMP_ATOL),
    C("bincount", lambda P, x: P.bincount(x), [I((20,), 0, 7)], low=False),
    C("bincount_weights_minlength", lambda P, x, w: P.bincount(x, weights=w, minlength=10),
      [I((20,), 0, 5), U((20,), 0, 1)], low=False, grad=False),
    C("lstsq_tall", lambda P, x, b: P.linalg.lstsq(x, b), [N(6, 3), N(6, 2)], low=False,
      grad=False, rtol=DECOMP_RTOL, atol=DECOMP_ATOL),
    C("lstsq_vector", lambda P, x, b: P.linalg.lstsq(x, b), [N(5, 3), N(5)], low=False,
      grad=False, rtol=DECOMP_RTOL, atol=DECOMP_ATOL),
    C("lstsq_wide", lambda P, x, b: P.linalg.lstsq(x, b), [N(2, 4), N(2, 1)], low=False,
      grad=False, rtol=DECOMP_RTOL, atol=DECOMP_ATOL),
    C("lu", lambda P, x: P.linalg.lu(x, get_infos=True), [N(*SQ)], low=False, grad=False,
      rtol=DECOMP_RTOL, atol=DECOMP_ATOL),
    C("lu_unpack", lambda P, x: P.linalg.lu_unpack(*P.linalg.lu(x)), [N(*SQ)], low=False,
      grad=False, rtol=DECOMP_RTOL, atol=DECOMP_ATOL),
    C("eigvalsh", lambda P, x: P.linalg.eigvalsh(_spd(P, x)), [N(*SQ)], low=False,
      rtol=DECOMP_RTOL, atol=DECOMP_ATOL),
    # the namespace of paddle_tpu/linalg.py
    C("vector_norm", lambda P, x: P.linalg.vector_norm(x, p=3.0, axis=1), [N(3, 4)],
      low=False),
    C("matrix_norm_nuc", lambda P, x: P.linalg.matrix_norm(x, p="nuc"), [N(2, 3, 4)],
      low=False, grad=False, rtol=DECOMP_RTOL, atol=DECOMP_ATOL),
    # the JAX package computes matrix_norm, svdvals and ormqr outside its tape:
    # values only
    C("matrix_norm_fro", lambda P, x: P.linalg.matrix_norm(x), [N(3, 4)], low=False,
      grad=False),
    C("matrix_norm_inf", lambda P, x: P.linalg.matrix_norm(x, p=float("inf")), [N(3, 4)],
      low=False, grad=False),
    C("svdvals", lambda P, x: P.linalg.svdvals(x), [N(4, 3)], low=False, grad=False,
      rtol=DECOMP_RTOL, atol=DECOMP_ATOL),
    C("ormqr", lambda P, x, t, o: P.linalg.ormqr(x, t, o), [N(4, 3), N(3), N(3, 2)],
      low=False, grad=False, rtol=DECOMP_RTOL, atol=DECOMP_ATOL),
    C("ormqr_right_transpose", lambda P, x, t, o: P.linalg.ormqr(
        x, t, o, left=False, transpose=True), [N(3, 3), N(3), N(2, 3)], low=False,
      grad=False, rtol=DECOMP_RTOL, atol=DECOMP_ATOL),
    C("matrix_transpose", lambda P, x: P.linalg.matrix_transpose(x), [N(2, 3, 4)]),
    C("vecdot", lambda P, x, y: P.linalg.vecdot(x, y), [N(3, 4), N(3, 4)]),
    C("linalg_norm_cross_diagonal", lambda P, x, y: [
        P.linalg.norm(x), P.linalg.cross(x, y, axis=1), P.linalg.diagonal(x)],
      [N(3, 3), N(3, 3)], low=False),
    C("fp8_gemm", lambda P, x, y, b: P.linalg.fp8_fp8_half_gemm_fused(
        x, y, transpose_y=True, bias=b, scale=0.5, output_dtype="float32",
        activation_type="relu"), [N(2, 3, 8), N(2, 4, 8), N(4)], low=False, grad=False),
]


def _check(fn, inputs, grad, rtol, atol):
    """``test_torch_ops.py``'s comparison: outputs and dtypes at float32,
    then the gradients of ``sum(out * ct)``."""
    seed = _case_seed(fn)
    arrays = _arrays(inputs, seed)
    rng = np.random.RandomState(seed + 1)
    cts = [rng.standard_normal(64).astype(np.float32) for _ in range(8)]
    jout, _ = _run(paddle, fn, arrays, False, False, None)
    tout, _ = _run(T, fn, arrays, False, False, None)
    assert len(jout) == len(tout)
    for j, t in zip(jout, tout):
        assert _dtype(t) == _dtype(j)
        assert _np(t).shape == _np(j).shape
        np.testing.assert_allclose(_np(t), _np(j), rtol=rtol, atol=atol)
    if grad and any(np.issubdtype(a.dtype, np.floating) for a in arrays):
        shaped = [c[:_np(o).size] for c, o in zip(cts, [o for o in jout if _is_float(o)])]
        _, jgrads = _run(paddle, fn, arrays, True, False, shaped)
        _, tgrads = _run(T, fn, arrays, True, False, shaped)
        for jg, tg in zip(jgrads, tgrads):
            if jg is None:
                assert tg is None or not np.any(tg)
                continue
            np.testing.assert_allclose(tg, jg, rtol=rtol, atol=atol)


@pytest.mark.parametrize("fn,inputs,low,grad,rtol,atol", CASES)
def test_linalg_matches_jax(fn, inputs, low, grad, rtol, atol):
    _check(fn, inputs, grad, rtol, atol)


def _tensors(P, *arrays, grad=False):
    return [P.to_tensor(a, place="cpu", stop_gradient=not grad) for a in arrays]


class TestSignAmbiguousByReconstruction:
    """svd, qr, eigh, eig and svd_lowrank: factors equal up to signs (or
    phases), so each package is held to its reconstruction and both to the
    same invariants."""

    def _x(self, shape=(5, 3), seed=0):
        return np.random.RandomState(seed).standard_normal(shape).astype(np.float32)

    def test_svd(self):
        x = self._x()
        for full in (False, True):
            svals = []
            for P in (paddle, T):
                u, s, vh = (_np(t) for t in P.linalg.svd(*_tensors(P, x), full_matrices=full))
                k = s.shape[-1]
                np.testing.assert_allclose(u[:, :k] * s @ vh[:k], x, rtol=1e-5, atol=1e-5)
                np.testing.assert_allclose(u.T @ u, np.eye(u.shape[1]), atol=1e-5)
                svals.append(s)
            np.testing.assert_allclose(svals[1], svals[0], rtol=1e-5)

    def test_svd_gradient_of_the_singular_values(self):
        x = self._x()
        grads = []
        for P in (paddle, T):
            (t,) = _tensors(P, x, grad=True)
            P.sum(P.linalg.svd(t)[1]).backward()
            grads.append(_np(t.grad))
        np.testing.assert_allclose(grads[1], grads[0], rtol=1e-4, atol=1e-5)

    @pytest.mark.parametrize("mode", ["reduced", "complete", "r"])
    def test_qr(self, mode):
        x = self._x()
        rs = []
        for P in (paddle, T):
            out = P.linalg.qr(*_tensors(P, x), mode=mode)
            if mode == "r":
                rs.append(np.abs(_np(out)))
                continue
            q, r = (_np(t) for t in out)
            np.testing.assert_allclose(q @ r, x, rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(q.T @ q, np.eye(q.shape[1]), atol=1e-5)
            assert np.allclose(r, np.triu(r))
            rs.append(np.abs(r))
        np.testing.assert_allclose(rs[1], rs[0], rtol=1e-4, atol=1e-5)

    def test_eigh(self):
        a = self._x((4, 4))
        sym = a + a.T
        ws = []
        for P in (paddle, T):
            w, v = (_np(t) for t in P.linalg.eigh(*_tensors(P, sym)))
            np.testing.assert_allclose(v @ np.diag(w) @ v.T, sym, rtol=1e-4, atol=1e-4)
            ws.append(w)
        np.testing.assert_allclose(ws[1], ws[0], rtol=1e-5, atol=1e-5)

    def test_eig_and_eigvals(self):
        x = self._x((4, 4), seed=3)
        ws = []
        for P in (paddle, T):
            w, v = (_np(t) for t in P.linalg.eig(*_tensors(P, x)))
            np.testing.assert_allclose(x @ v, v * w, rtol=1e-4, atol=1e-4)
            ev = _np(P.linalg.eigvals(*_tensors(P, x)))
            assert ev.dtype == w.dtype == np.complex64
            ws.append(np.sort_complex(ev))
        np.testing.assert_allclose(ws[1], ws[0], rtol=1e-4, atol=1e-5)

    def test_svd_lowrank(self):
        x = self._x((6, 4))
        for P in (paddle, T):
            u, s, v = (_np(t) for t in P.linalg.svd_lowrank(*_tensors(P, x), q=4))
            np.testing.assert_allclose(u * s @ v.T, x, rtol=1e-4, atol=1e-4)

    def test_pca_lowrank_spans_the_centered_matrix(self):
        x = self._x((8, 3), seed=5)
        centered = x - x.mean(0)
        for P in (paddle, T):
            P.seed(0)
            u, s, v = (_np(t) for t in P.linalg.pca_lowrank(*_tensors(P, x), q=3))
            np.testing.assert_allclose(u * s @ v.T, centered, rtol=1e-4, atol=1e-4)


class TestDtypesAndErrors:
    def test_lu_reconstructs_and_pivots_are_one_based_int32(self):
        x = np.random.RandomState(1).standard_normal((4, 4)).astype(np.float32)
        for P in (paddle, T):
            lu, piv = P.linalg.lu(*_tensors(P, x))
            assert _dtype(piv) == "int32" and _np(piv).min() >= 1
            p, l, u = (_np(t) for t in P.linalg.lu_unpack(lu, piv))
            np.testing.assert_allclose(p @ l @ u, x, rtol=1e-5, atol=1e-5)

    def test_bincount_is_not_differentiable_and_counts_int64(self):
        x = np.array([0, 3, 3, 1], np.int64)
        for P in (paddle, T):
            out = P.bincount(P.to_tensor(x, place="cpu"))
            assert _dtype(out) == "int64"
            np.testing.assert_array_equal(_np(out), [1, 1, 0, 2])

    def test_float64_decompositions(self):
        a = np.random.RandomState(2).standard_normal((5, 5))
        spd = a @ a.T + 5 * np.eye(5)
        for P in (paddle, T):
            (t,) = _tensors(P, spd)
            L = _np(P.linalg.cholesky(t))
            assert L.dtype == np.float64
            np.testing.assert_allclose(L @ L.T, spd, rtol=1e-12)
            np.testing.assert_allclose(_np(P.linalg.inv(t)) @ spd, np.eye(5), atol=1e-12)
            sign, logdet = _np(P.linalg.slogdet(t))
            np.testing.assert_allclose(sign * np.exp(logdet), np.linalg.det(spd), rtol=1e-12)

    def test_mixed_dtype_products_promote(self):
        """Queue C Open 5 (b): float16 with float32, and float16 with
        bfloat16, give float32 (jnp.promote_types), in matmul, mm, bmm, mv
        and solve."""
        a = np.random.RandomState(3).standard_normal((2, 3, 3)).astype(np.float32)
        for P in (paddle, T):
            x16, x32, xbf = (P.cast(P.to_tensor(a, place="cpu"), d)
                             for d in ("float16", "float32", "bfloat16"))
            assert _dtype(P.matmul(x16, x32)) == "float32"
            assert _dtype(P.matmul(x16, xbf)) == "float32"
            assert _dtype(P.bmm(x16, x32)) == "float32"
            assert _dtype(P.mm(x16[0], xbf[0])) == "float32"
            assert _dtype(P.mv(x16[0], x32[0, 0])) == "float32"


def test_every_jax_name_exists():
    """Every public function of the JAX ``ops/linalg.py`` and of
    ``paddle_tpu.linalg`` is in the port's namespace of the same name."""
    from paddle_tpu.ops import linalg as jops_linalg

    skip = {"annotations", "np", "jax", "jnp", "Tensor", "defop", "flags", "dtype_mod"}
    ops_names = {n for n in dir(jops_linalg) if not n.startswith("_")
                 and callable(getattr(jops_linalg, n))} - skip
    missing = {n for n in ops_names if not hasattr(T, n) and not hasattr(T.linalg, n)}
    assert not missing, missing
    ns_names = {n for n in dir(paddle.linalg) if not n.startswith("_")} - skip
    assert ns_names <= set(dir(T.linalg)), ns_names - set(dir(T.linalg))
