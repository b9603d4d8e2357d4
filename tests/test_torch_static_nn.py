"""The port's static.nn (paddle_tpu_torch/static/nn.py) against the JAX
package's: control flow eager, under ``jit.to_static`` and captured, and the
builders.

Each builder case builds the same program in both packages, carries the
JAX parameters (``Program.all_parameters()``, in order; the layouts are
equal) into the port's, replays both on the same numpy feed and holds the
fetches at float32 rtol 1e-5 / atol 1e-6. The two cases whose values come
from a random draw the port cannot reproduce (nce's negatives, spectral
norm's starting vector) are held to their laws instead.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as T
from paddle_tpu.static import nn as jsnn
from paddle_tpu_torch.static import nn as snn
from test_torch_ops import _np, _on_cpu  # noqa: F401

RTOL, ATOL = 1e-5, 1e-6
BOTH = (paddle, T)
SNN = {paddle: jsnn, T: snn}


def _t(x, **kw):
    return T.to_tensor(np.asarray(x), place="cpu", **kw)


def _both(build, feed, fetch, steps=1):
    """Build ``build(P, S)`` under a program_guard in both packages, carry
    the JAX parameters into the port's, replay each ``steps`` times; the
    port's and the JAX fetches of the last run."""
    progs = []
    for P in BOTH:
        P.seed(0)
        main = P.static.Program()
        with P.static.program_guard(main, P.static.Program()):
            build(P, SNN[P])
        progs.append(main)
    jps, tps = progs[0].all_parameters(), progs[1].all_parameters()
    assert [tuple(p.shape) for p in jps] == [tuple(p.shape) for p in tps]
    with torch.no_grad():
        for jp, tp in zip(jps, tps):
            tp.copy_(torch.from_numpy(_np(jp)))
    outs = []
    for P, main in zip(BOTH, progs):
        exe = P.static.Executor()
        for _ in range(steps):
            res = exe.run(main, feed=feed, fetch_list=fetch)
        outs.append(res)
    return outs[1], outs[0]


def _close(got, ref, rtol=RTOL, atol=ATOL):
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


# -- control flow ---------------------------------------------------------------
class TestCondEager:
    def test_picks_branch(self):
        a, b = _t([1.0]), _t([2.0])
        assert float(snn.cond(a < b, lambda: a + b, lambda: a * b)[0]) == 3.0
        assert float(snn.cond(a > b, lambda: a + b, lambda: a * b)[0]) == 2.0

    def test_none_fns(self):
        assert snn.cond(_t([1.0]) > 0) is None

    def test_nest_structure(self):
        p = _t([0.1]) < _t([0.23])
        a, b = snn.cond(p, lambda: (_t([1]), _t([2])), lambda: (_t([3]), _t([4])))
        assert int(a[0]) == 1 and int(b[0]) == 2

    def test_grad_through_taken_branch(self):
        x = _t([3.0], stop_gradient=False)
        snn.cond(x.sum() > 0, lambda: x * 2.0, lambda: x * 5.0).backward()
        assert float(x.grad[0]) == 2.0

    def test_numel_check(self):
        with pytest.raises(ValueError):
            snn.cond(_t([1.0, 2.0]) > 0, lambda: _t([1.0]), lambda: _t([2.0]))

    def test_not_callable(self):
        with pytest.raises(TypeError):
            snn.cond(_t([1.0]) > 0, 1, None)


class TestControlFlowUnderToStatic:
    # the JAX package stages lax.cond / lax.while_loop / lax.switch; the
    # port's to_static breaks the graph at the predicate and runs the
    # concrete-bool path: the values are the JAX function's, and nothing raises
    def test_cond(self):
        f = T.jit.to_static(lambda x: snn.cond(x.sum() > 0, lambda: x * 2.0,
                                               lambda: x - 1.0))
        np.testing.assert_allclose(_np(f(_t([1.0, 2.0]))), [2.0, 4.0])
        np.testing.assert_allclose(_np(f(_t([-1.0, -2.0]))), [-2.0, -3.0])

    def test_grad_through_cond(self):
        sf = T.jit.to_static(lambda x: snn.cond(x.sum() > 0, lambda: (x * 2.0).sum(),
                                                lambda: (x * 5.0).sum()))
        for xv, g in (([1.0, 2.0], 2.0), ([-1.0, -2.0], 5.0)):
            x = _t(xv, stop_gradient=False)
            sf(x).backward()
            np.testing.assert_allclose(_np(x.grad), [g, g])

    def test_while_loop_data_dependent_bound(self):
        def f(x, bound):
            i = torch.zeros((), dtype=torch.int64)
            return snn.while_loop(lambda i, v: i < bound, lambda i, v: [i + 1, v + 1.0],
                                  [i, x])[1]

        sf = T.jit.to_static(f)
        for b in (3, 7):
            np.testing.assert_allclose(_np(sf(_t([0.0]), _t(np.asarray(b, "int64")))), [b])

    def test_case_and_switch_case(self):
        f = T.jit.to_static(lambda x: snn.case([(x.sum() < 0, lambda: x * 0.0),
                                                (x.sum() < 10, lambda: x * 2.0)],
                                               default=lambda: x * 3.0))
        for xv, want in ((1.0, 2.0), (20.0, 60.0), (-5.0, -0.0)):
            np.testing.assert_allclose(_np(f(_t([xv]))), [want])
        g = T.jit.to_static(lambda idx, x: snn.switch_case(
            idx, [lambda: x * 1.0, lambda: x * 2.0, lambda: x * 3.0],
            default=lambda: x * 0.0))
        x = _t([1.0, 1.0])
        np.testing.assert_allclose(_np(g(_t(np.asarray(1, "int32")), x)), [2.0, 2.0])
        np.testing.assert_allclose(_np(g(_t(np.asarray(5, "int32")), x)), [0.0, 0.0])
        np.testing.assert_allclose(_np(g(_t(np.asarray(-5, "int32")), x)), [0.0, 0.0])


class TestCondCaptured:
    def test_executor_redecides_per_run(self):
        def build(P, S):
            x = P.static.data("x", [2], "float32")
            S.cond(x.sum() > 0, lambda: x * 2.0, lambda: x - 1.0).name = "out"

        for xv in ([1.0, 2.0], [-1.0, -2.0]):
            got, ref = _both(build, {"x": np.array(xv, "float32")}, ["out"])
            _close(got, ref)

    def test_structure_mismatch_raises(self):
        main = T.static.Program()
        with T.static.program_guard(main):
            x = T.static.data("x", [2], "float32")
            with pytest.raises(TypeError):
                snn.cond(x.sum() > 0, lambda: (x, x), lambda: x)


class TestWhileLoop:
    def test_eager(self):
        ten = _t(np.asarray(10, "int64"))
        assert int(snn.while_loop(lambda i: i < ten, lambda i: i + 1,
                                  [_t(np.asarray(0, "int64"))])[0]) == 10

    def test_eager_multi_var(self):
        out = snn.while_loop(lambda i, s: i < 5, lambda i, s: [i + 1, s + 2.0],
                             [_t(np.asarray(0, "int64")), _t([0.0])])
        assert int(out[0]) == 5 and float(out[1][0]) == 10.0

    def test_eager_grad(self):
        x = _t([2.0], stop_gradient=False)
        out = snn.while_loop(lambda i, v: i < 3, lambda i, v: [i + 1, v * 2.0],
                             [_t(np.asarray(0, "int64")), x])
        out[1].backward()
        assert float(x.grad[0]) == 8.0

    def test_captured_reexecutes_per_feed(self):
        def build(P, S):
            x = P.static.data("x", [1], "float32")
            i = P.to_tensor(np.asarray(0, "int64"))
            out = S.while_loop(lambda i, v: v.sum() < 20.0, lambda i, v: [i + 1, v * 2.0],
                               [i, x])
            out[1].name = "out"

        for xv, want in ((1.0, 32.0), (15.0, 30.0)):
            got, ref = _both(build, {"x": np.array([xv], "float32")}, ["out"])
            _close(got, ref)
            np.testing.assert_allclose(got[0], [want])

    def test_validation(self):
        with pytest.raises(TypeError):
            snn.while_loop(1, lambda i: i, [_t([1.0])])
        with pytest.raises(ValueError):
            snn.while_loop(lambda: True, lambda: 1, [])


class TestCaseSwitch:
    @pytest.mark.parametrize("which", ["first_true", "default", "last_is_default"])
    def test_case_matches_jax(self, which):
        outs = []
        for P in BOTH:
            x = P.to_tensor(np.array([0.3], "float32"))
            y = P.to_tensor(np.array([0.1], "float32"))
            S = SNN[P]
            if which == "first_true":
                o = S.case([(x < y, lambda: x + y), (x > y, lambda: x - y)],
                           default=lambda: x * y)
            elif which == "default":
                o = S.case([(x < y, lambda: x + y)], default=lambda: x * y)
            else:
                o = S.case([(x < y, lambda: x + y), (x < y, lambda: x - y)])
            outs.append(_np(o))
        np.testing.assert_allclose(outs[1], outs[0], rtol=RTOL)

    @pytest.mark.parametrize("idx", [2, 7, 1])
    def test_switch_case_matches_jax(self, idx):
        outs = []
        for P in BOTH:
            i = P.to_tensor(np.asarray(idx, "int32"))
            o = SNN[P].switch_case(i, {1: lambda: P.to_tensor(np.array([1.0], "float32")),
                                       2: lambda: P.to_tensor(np.array([2.0], "float32"))},
                                   default=lambda: P.to_tensor(np.array([9.0], "float32")))
            outs.append(_np(o))
        np.testing.assert_array_equal(outs[1], outs[0])

    def test_duplicate_keys(self):
        with pytest.raises(ValueError):
            snn.switch_case(_t(np.asarray(0, "int32")),
                            [(0, lambda: _t([1.0])), (0, lambda: _t([2.0]))])

    def test_captured_case(self):
        def build(P, S):
            x = P.static.data("x", [1], "float32")
            S.case([(x.sum() < 0, lambda: x * 0.5), (x.sum() < 10, lambda: x * 2.0)],
                   default=lambda: x * 3.0).name = "out"

        for xv in (-4.0, 3.0, 30.0):
            got, ref = _both(build, {"x": np.array([xv], "float32")}, ["out"])
            _close(got, ref)


class TestStaticPyLayer:
    def test_custom_backward_eager(self):
        x = _t([2.0], stop_gradient=False)
        out = snn.static_pylayer(lambda v: v * 3.0, [x], backward_fn=lambda g: g * 100.0)
        out.backward()
        np.testing.assert_allclose(_np(out), [6.0])
        np.testing.assert_allclose(_np(x.grad), [100.0])

    def test_no_backward_stops_gradient(self):
        x = _t([2.0], stop_gradient=False)
        assert not snn.static_pylayer(lambda v: v * 3.0, [x]).requires_grad

    def test_captured_replay_custom_backward(self):
        main = T.static.Program()
        with T.static.program_guard(main):
            x = T.static.data("x", [1], "float32")
            w = T.Parameter(torch.tensor([1.0]))
            out = snn.static_pylayer(lambda v: v * 3.0, [x * w], backward_fn=lambda g: g * 100.0)
            out.name = "out"
            T.static.append_backward(out.sum(), parameter_list=[w])
        (r,) = T.static.Executor().run(main, feed={"x": np.array([5.0], "float32")},
                                       fetch_list=["out"])
        np.testing.assert_allclose(r, [15.0])
        np.testing.assert_allclose(_np(w.grad), [500.0])   # the custom backward, replayed

    def test_mixed_output_alignment(self):
        main = T.static.Program()
        with T.static.program_guard(main):
            x = T.static.data("x", [1], "float32")
            const, out = snn.static_pylayer(lambda v: (7, v * 3.0), [x], backward_fn=lambda g: g)
            out.name = "out"
        assert const == 7
        (r,) = T.static.Executor().run(main, feed={"x": np.array([5.0], "float32")},
                                       fetch_list=["out"])
        np.testing.assert_allclose(r, [15.0])


# -- builders -----------------------------------------------------------------
R = np.random.RandomState(0)
X48 = R.randn(4, 8).astype("float32")
IMG = R.randn(2, 6, 4, 4).astype("float32")
IMG3 = R.randn(2, 3, 8, 8).astype("float32")
VOL = R.randn(1, 2, 4, 4, 4).astype("float32")
SEQ = R.randn(2, 4, 3).astype("float32")
LENS = np.array([2, 4], "int64")

BUILDERS = {
    "fc": (lambda P, S: S.fc(P.static.data("x", [None, 8], "float32"), 16,
                             activation="relu"), {"x": X48}),
    "fc_multi_input": (lambda P, S: S.fc([P.static.data("x", [None, 8], "float32")] * 2, 5),
                       {"x": X48}),
    "fc_flatten_dims": (lambda P, S: S.fc(P.static.data("x", [None, 3, 4, 5], "float32"), 7,
                                          num_flatten_dims=2),
                        {"x": R.randn(2, 3, 4, 5).astype("float32")}),
    "embedding": (lambda P, S: S.embedding(P.static.data("x", [None, 2], "int64"), (10, 6)),
                  {"x": np.array([[1, 2], [3, 0], [9, 9]], "int64")}),
    "batch_norm": (lambda P, S: S.batch_norm(P.static.data("x", [None, 6, 4, 4], "float32")),
                   {"x": IMG}),
    "batch_norm_test": (lambda P, S: S.batch_norm(P.static.data("x", [None, 6, 4, 4],
                                                                "float32"), is_test=True),
                        {"x": IMG}),
    "layer_norm": (lambda P, S: S.layer_norm(P.static.data("x", [None, 6, 4, 4], "float32"),
                                             begin_norm_axis=1), {"x": IMG}),
    "group_norm": (lambda P, S: S.group_norm(P.static.data("x", [None, 6, 4, 4], "float32"),
                                             groups=3), {"x": IMG}),
    "instance_norm": (lambda P, S: S.instance_norm(P.static.data("x", [None, 6, 4, 4],
                                                                 "float32")), {"x": IMG}),
    "conv2d": (lambda P, S: S.conv2d(P.static.data("x", [None, 3, 8, 8], "float32"), 5, 3,
                                     padding=1, act="relu"), {"x": IMG3}),
    "conv2d_transpose": (lambda P, S: S.conv2d_transpose(
        P.static.data("x", [None, 3, 8, 8], "float32"), 5, filter_size=2, stride=2),
        {"x": IMG3}),
    "conv3d": (lambda P, S: S.conv3d(P.static.data("x", [None, 2, 4, 4, 4], "float32"), 3, 3,
                                     padding=1), {"x": VOL}),
    "conv3d_transpose": (lambda P, S: S.conv3d_transpose(
        P.static.data("x", [None, 2, 4, 4, 4], "float32"), 3, filter_size=2, stride=2),
        {"x": VOL}),
    "bilinear": (lambda P, S: S.bilinear_tensor_product(
        P.static.data("x", [None, 4], "float32"), P.static.data("y", [None, 5], "float32"), 6),
        {"x": R.randn(3, 4).astype("float32"), "y": R.randn(3, 5).astype("float32")}),
    "prelu_channel": (lambda P, S: S.prelu(P.static.data("x", [None, 6, 4, 4], "float32"),
                                           mode="channel"), {"x": IMG}),
    "data_norm": (lambda P, S: S.data_norm(P.static.data("x", [None, 8], "float32")),
                  {"x": X48}),
    "row_conv": (lambda P, S: S.row_conv(P.static.data("x", [None, 4, 3], "float32"), 2),
                 {"x": SEQ}),
    "deform_conv2d": (lambda P, S: S.deform_conv2d(
        P.static.data("x", [None, 3, 8, 8], "float32"),
        P.static.data("off", [None, 18, 8, 8], "float32"),
        P.static.data("m", [None, 9, 8, 8], "float32"), 4, 3, padding=1),
        {"x": IMG3, "off": R.randn(2, 18, 8, 8).astype("float32"),
         "m": R.rand(2, 9, 8, 8).astype("float32")}),
    "sequence_conv": (lambda P, S: S.sequence_conv(P.static.data("x", [None, 4, 3],
                                                                 "float32"), 5),
                      {"x": SEQ}),
    "sequence_pool_avg": (lambda P, S: S.sequence_pool(
        P.static.data("x", [None, 4, 3], "float32"), "average",
        seq_lens=P.static.data("l", [None], "int64")), {"x": SEQ, "l": LENS}),
    "sequence_pool_max": (lambda P, S: S.sequence_pool(
        P.static.data("x", [None, 4, 3], "float32"), "max",
        seq_lens=P.static.data("l", [None], "int64")), {"x": SEQ, "l": LENS}),
    "sequence_pool_sqrt": (lambda P, S: S.sequence_pool(
        P.static.data("x", [None, 4, 3], "float32"), "sqrt"), {"x": SEQ}),
    "sequence_softmax": (lambda P, S: S.sequence_softmax(
        P.static.data("x", [None, 4], "float32"), seq_lens=P.static.data("l", [None], "int64")),
        {"x": SEQ[:, :, 0].copy(), "l": LENS}),
    "sequence_last_step": (lambda P, S: S.sequence_last_step(
        P.static.data("x", [None, 4, 3], "float32"),
        seq_lens=P.static.data("l", [None], "int64")), {"x": SEQ, "l": LENS}),
    "sequence_first_step": (lambda P, S: S.sequence_first_step(
        P.static.data("x", [None, 4, 3], "float32")), {"x": SEQ}),
    "sequence_expand": (lambda P, S: S.sequence_expand(
        P.static.data("x", [None, 3], "float32"), P.static.data("y", [None, 4, 3], "float32")),
        {"x": R.randn(2, 3).astype("float32"), "y": SEQ}),
}


class TestBuilders:
    @pytest.mark.parametrize("name", sorted(BUILDERS))
    def test_replay_matches_jax(self, name):
        make, feed = BUILDERS[name]

        def build(P, S):
            make(P, S).name = "out"

        got, ref = _both(build, feed, ["out"])
        _close(got, ref)

    def test_builders_train_via_minimize_like_jax(self):
        def build(P, S):
            x = P.static.data("x", [None, 4], "float32")
            y = P.static.data("y", [None, 1], "float32")
            pred = S.fc(S.fc(x, 8, activation="relu"), 1)
            loss = ((pred - y) ** 2).mean()
            loss.name = "loss"
            P.optimizer.SGD(learning_rate=0.1).minimize(loss)

        r = np.random.RandomState(0)
        xb = r.randn(16, 4).astype("float32")
        feed = {"x": xb, "y": (xb.sum(1, keepdims=True) * 0.5).astype("float32")}
        got, ref = _both(build, feed, ["loss"], steps=30)
        _close(got, ref, rtol=1e-4, atol=1e-5)
        main = T.static.Program()
        with T.static.program_guard(main):
            snn.fc(T.static.data("x", [None, 4], "float32"), 2)
        assert len(main.all_parameters()) == 2

    def test_nce_shape_and_fresh_negatives_per_run(self):
        main = T.static.Program()
        with T.static.program_guard(main):
            feat = T.static.data("feat", [None, 8], "float32")
            lab = T.static.data("lab", [None, 1], "int64")
            snn.nce(feat, lab, 20, num_neg_samples=5).name = "nce"
        r = np.random.RandomState(0)
        feed = {"feat": r.randn(5, 8).astype("float32"),
                "lab": r.randint(0, 20, (5, 1)).astype("int64")}
        exe = T.static.Executor()
        a = exe.run(main, feed=feed, fetch_list=["nce"])[0]
        b = exe.run(main, feed=feed, fetch_list=["nce"])[0]
        assert a.shape == (5, 1) and np.isfinite(a).all() and not np.allclose(a, b)

    def test_prelu_element_law(self):
        # the JAX package's F.prelu reshapes an element-mode alpha to
        # [1, C, 1, 1] and raises, so the port is held to PReLU's law: one
        # alpha (0.25 at build) an element of x.shape[1:]
        main = T.static.Program()
        with T.static.program_guard(main):
            snn.prelu(T.static.data("x", [None, 6, 4, 4], "float32"), mode="element").name = "out"
        assert [tuple(p.shape) for p in main.all_parameters()] == [(6, 4, 4)]
        (got,) = T.static.Executor().run(main, feed={"x": IMG}, fetch_list=["out"])
        np.testing.assert_allclose(got, np.where(IMG > 0, IMG, 0.25 * IMG), rtol=RTOL, atol=ATOL)

    def test_spectral_norm_law(self):
        w = _t(np.random.RandomState(0).randn(6, 8).astype("float32"))
        for dim in (0, 1):
            sn = _np(snn.spectral_norm(w, dim=dim, power_iters=4))
            assert sn.shape == (6, 8)
            assert abs(np.linalg.svd(sn, compute_uv=False)[0] - 1.0) < 0.15

    def test_eager_shapes(self):
        x = _t(X48)
        assert tuple(snn.fc(x, 16).shape) == (4, 16)
        assert tuple(snn.sparse_embedding(_t(np.array([[1, 2]], "int64")), (10, 6)).shape) == \
            (1, 2, 6)
        with pytest.raises(ValueError):
            snn.prelu(_t(IMG), mode="bad")
        with pytest.raises(ValueError):
            snn.conv2d_transpose(_t(IMG3), 5)
        with pytest.raises(ValueError):
            snn.sequence_pool(_t(SEQ), "median")

    def test_dynamic_batch_sequence_replay(self):
        main = T.static.Program()
        with T.static.program_guard(main):
            x = T.static.data("seq", [None, 4, 3], "float32")
            snn.sequence_conv(x, 2, filter_size=3).name = "sc"
            snn.row_conv(x, 2).name = "rc"
        exe = T.static.Executor()
        sc, rc = exe.run(main, feed={"seq": np.random.RandomState(0).randn(5, 4, 3).astype(
            "float32")}, fetch_list=["sc", "rc"])
        assert sc.shape == (5, 4, 2) and rc.shape == (5, 4, 3)
