"""Graph breaks under paddle_tpu_torch.jit.to_static against
paddle_tpu.jit.to_static: the counterparts of tests/test_sot.py and of
tests/test_jit.py's TestGraphBreakFallback and TestPerSignatureGraphBreak,
each held to the JAX package's result on the same inputs (fp32, on the CPU).

Dynamo cuts a broken function into graphs at its own places (a resume frame
after every host read, one more for each branch a guard sends it down), so
where the JAX tape counts N segments these tests assert the results and
``>= 2`` graphs, never JAX's exact count. Dynamo also replays a function's
side effects on Python objects on every compiled call, where jax tracing
runs them once: the tests count compiled graphs, not calls of the body.
"""
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu_torch import jit

BACKEND = "aot_eager"


@pytest.fixture(autouse=True)
def _fresh_dynamo():
    torch._dynamo.reset()
    yield
    torch._dynamo.reset()


def _seg_count(sf):
    return sum(sf.compiled_segment_counts().values())


def _both(f, jf, **kw):
    return (jit.to_static(f, full_graph=False, backend=BACKEND, **kw),
            paddle.jit.to_static(jf, full_graph=False, **kw))


def _pt(a, **kw):
    return paddle.to_tensor(np.asarray(a), **kw)


def _tt(a):
    return torch.from_numpy(np.array(a))


def _quiet(fn, *args, **kwargs):
    """Call, swallowing the one-time graph-break warning (asserted elsewhere)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn(*args, **kwargs)


class TestSegments:
    def test_compiled_eager_compiled_matches_eager_and_jax(self):
        def f(x):
            h = torch.tanh(x) * 2.0
            gate = float(h.sum())                  # host read
            return (h * 3.0 if gate > 0 else h - 1.0).sum()

        def jf(x):
            h = paddle.tanh(x) * 2.0
            gate = float(h.sum())
            return (h * 3.0 if gate > 0 else h - 1.0).sum()

        sf, jsf = _both(f, jf)
        xn = np.random.RandomState(0).rand(3, 3).astype("float32") + 0.1
        with pytest.warns(UserWarning, match="compiled segments"):
            first = sf(_tt(xn))
        ref = _quiet(jsf, _pt(xn)).numpy()
        eager = f(_tt(xn))
        np.testing.assert_allclose(first.numpy(), eager.numpy(), rtol=1e-6)
        np.testing.assert_allclose(first.numpy(), ref, rtol=1e-5)
        second = sf(_tt(xn))                       # replay
        np.testing.assert_allclose(second.numpy(), eager.numpy(), rtol=1e-6)
        assert _seg_count(sf) >= 2, sf.compiled_segment_counts()

    def test_guard_divergence_takes_the_other_branch(self):
        def f(x):
            if bool(x.sum() > 0):
                return x * 2.0
            return x * 5.0

        def jf(x):
            if bool(x.sum() > 0):
                return x * 2.0
            return x * 5.0

        sf, jsf = _both(f, jf)
        pos, neg = np.array([1.0, 2.0], "float32"), np.array([-1.0, -2.0], "float32")
        with pytest.warns(UserWarning):
            sf(_tt(pos))
        for x in (pos, pos, neg, neg, pos):
            np.testing.assert_array_equal(sf(_tt(x)).numpy(), _quiet(jsf, _pt(x)).numpy())

    def test_gradients_flow_through_segments(self):
        def f(x):
            h = x * 3.0
            k = float(h.sum())
            return (h * 2.0).sum() if k > 0 else (h * 7.0).sum()

        def jf(x):
            h = x * 3.0
            k = float(h.sum())
            return (h * 2.0).sum() if k > 0 else (h * 7.0).sum()

        sf, jsf = _both(f, jf)
        for xn in ([1.0, 1.0], [2.0, 0.5], [-2.0, -1.0]):
            x = _tt(np.array(xn, "float32")).requires_grad_()
            jx = _pt(np.array(xn, "float32"), stop_gradient=False)
            _quiet(sf, x).backward()
            _quiet(jsf, jx).backward()
            np.testing.assert_array_equal(x.grad.numpy(), jx.grad.numpy())

    def test_replay_reads_live_parameter_values(self):
        lin = torch.nn.Linear(2, 2)
        jlin = paddle.nn.Linear(2, 2)
        with torch.no_grad():
            lin.weight.copy_(_tt(jlin.weight.numpy()).T)
            lin.bias.copy_(_tt(jlin.bias.numpy()))

        def f(x):
            h = lin(x)
            if float(h.sum()) > -1e30:             # always true
                return h * 1.0
            return h

        def jf(x):
            h = jlin(x)
            if float(h.sum()) > -1e30:
                return h * 1.0
            return h

        sf, jsf = _both(f, jf)
        x = np.ones((1, 2), "float32")
        a, b = _quiet(sf, _tt(x)), sf(_tt(x))
        np.testing.assert_allclose(a.detach().numpy(), _quiet(jsf, _pt(x)).numpy(), rtol=1e-6)
        np.testing.assert_array_equal(a.detach().numpy(), b.detach().numpy())
        # new weights: the replay must read them, not a value baked at capture
        with torch.no_grad():
            lin.weight.zero_()
            lin.bias.fill_(7.0)
        import jax.numpy as jnp
        jlin.weight._replace_value(jnp.zeros((2, 2), jnp.float32))
        jlin.bias._replace_value(jnp.asarray([7.0, 7.0], jnp.float32))
        c = sf(_tt(x))
        np.testing.assert_array_equal(c.detach().numpy(), [[7.0, 7.0]])
        np.testing.assert_array_equal(c.detach().numpy(), jsf(_pt(x)).numpy())

    def test_multiple_breaks(self):
        def f(x):
            a = x * 2.0
            s1 = float(a.sum())
            b = a + s1
            s2 = float(b.max())
            return b * (1.0 if s2 > 0 else -1.0)

        def jf(x):
            a = x * 2.0
            s1 = float(a.sum())
            b = a + s1
            s2 = float(b.max())
            return b * (1.0 if s2 > 0 else -1.0)

        sf, jsf = _both(f, jf)
        x = np.array([0.5, 1.5], "float32")
        cold, warm = _quiet(sf, _tt(x)), sf(_tt(x))
        ref = _quiet(jsf, _pt(x)).numpy()
        np.testing.assert_allclose(cold.numpy(), ref, rtol=1e-6)
        np.testing.assert_allclose(warm.numpy(), ref, rtol=1e-6)
        assert _seg_count(sf) >= 2, sf.compiled_segment_counts()

    def test_aliased_args(self):
        def f(u, v):
            if bool((u.sum() + v.sum()) > 0):
                return u - v
            return u + v

        sf = jit.to_static(f, full_graph=False, backend=BACKEND)
        jsf = paddle.jit.to_static(f, full_graph=False)
        x, a, b = (np.full(2, c, "float32") for c in (5.0, 5.0, 1.0))
        tx = _tt(x)
        np.testing.assert_array_equal(_quiet(sf, tx, tx).numpy(), [0.0, 0.0])
        np.testing.assert_array_equal(sf(_tt(a), _tt(b)).numpy(), [4.0, 4.0])
        np.testing.assert_array_equal(sf(tx, tx).numpy(), [0.0, 0.0])
        jx = _pt(x)
        np.testing.assert_array_equal(_quiet(jsf, jx, jx).numpy(), [0.0, 0.0])

    def test_dropout_mask_fresh_each_call(self):
        def f(x):
            h = torch.nn.functional.dropout(x, p=0.5, training=True)
            if bool(x.sum() > -1e30):
                return h * 1.0
            return h

        sf = jit.to_static(f, full_graph=False, backend=BACKEND)
        x = torch.ones(64)
        a, b = _quiet(sf, x), sf(x)
        assert not torch.equal(a, b)

    def test_detach_inside_body_is_not_stale(self):
        def f(x):
            d = x.detach() + 0.0
            if bool(x.sum() > 0):
                return d * 2.0
            return d

        sf = jit.to_static(f, full_graph=False, backend=BACKEND)
        jsf = paddle.jit.to_static(f, full_graph=False)
        for xn in ([1.0, 2.0], [10.0, 20.0]):
            x = np.array(xn, "float32")
            np.testing.assert_array_equal(_quiet(sf, _tt(x)).numpy(),
                                          _quiet(jsf, _pt(x)).numpy())

    def test_nested_to_static_replays_live(self):
        inner = jit.to_static(lambda x: x * 10.0, backend=BACKEND)

        def f(x):
            h = inner(x)
            if bool(h.sum() > -1e30):
                return h + 1.0
            return h

        sf = jit.to_static(f, full_graph=False, backend=BACKEND)
        with torch.no_grad():
            np.testing.assert_array_equal(_quiet(sf, _tt([1.0])).numpy(), [11.0])
            np.testing.assert_array_equal(sf(_tt([3.0])).numpy(), [31.0])
        assert _seg_count(sf) >= 1


class TestGraphBreakFallback:
    def test_full_graph_false_falls_back(self):
        def f(x):
            if float(x.sum()) > 0:
                return x * 2
            return x - 1

        sf, jsf = _both(f, f)
        with pytest.warns(UserWarning, match="graph break"):
            out = sf(torch.ones(3))
        np.testing.assert_array_equal(out.numpy(), 2.0)
        out2 = sf(-torch.ones(3))                  # the branch is taken anew
        np.testing.assert_array_equal(out2.numpy(), -2.0)
        np.testing.assert_array_equal(_quiet(jsf, _pt(-np.ones(3, "float32"))).numpy(), -2.0)

    @pytest.mark.parametrize("read", ["float", "item", "if"])
    def test_full_graph_true_raises_naming_the_line(self, read):
        def f(x):
            if read == "float":
                gate = float(x.sum()) > 0
            elif read == "item":
                gate = x.sum().item() > 0
            else:
                gate = x.sum() > 0
            if gate:
                return x * 2
            return x - 1

        sf = jit.to_static(f, full_graph=True, backend=BACKEND)
        with pytest.raises((torch._dynamo.exc.Unsupported, torch._dynamo.exc.UserError),
                           match=r"line \d+"):
            sf(torch.ones(3))
        assert len(sf._cache) == 0 and not sf._fallback

    def test_clean_functions_stay_compiled(self):
        def g(x):
            return torch.where(x > 0, x * 2, x - 1)

        def jg(x):
            return paddle.where(x > 0, x * 2, x - 1)

        sf, jsf = _both(g, jg)
        x = np.array([1.0, -1.0], "float32")
        np.testing.assert_array_equal(sf(_tt(x)).numpy(), jsf(_pt(x)).numpy())
        assert not sf._fallback and len(sf._cache) == 1


class TestPerSignatureGraphBreak:
    def test_breaking_signature_segments_others_stay_compiled(self):
        def f(x, mode="train"):
            if mode == "eval":
                if float(x.sum()) > 0:
                    return x * 2
                return x
            return x * 3

        sf, jsf = _both(f, f)
        xt, jx = torch.ones(3), _pt(np.ones(3, "float32"))
        np.testing.assert_array_equal(sf(xt, mode="train").numpy(), [3, 3, 3])
        assert len(sf._cache) == 1 and not sf._fallback_keys
        whole = sf._cache[sf.concrete_program_specs()[0]][1]
        assert whole.graphs == 1
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            np.testing.assert_array_equal(sf(xt, mode="eval").numpy(), [2, 2, 2])
        assert any("graph break" in str(r.message) for r in rec)
        assert len(sf._fallback_keys) == 1      # only the eval signature broke
        # the train signature keeps its one whole graph: no recompile
        np.testing.assert_array_equal(sf(xt, mode="train").numpy(), [3, 3, 3])
        assert whole.graphs == 1 and len(sf._cache) == 1
        with warnings.catch_warnings(record=True) as rec2:
            warnings.simplefilter("always")
            out = sf(xt, mode="eval")
        np.testing.assert_array_equal(out.numpy(), _quiet(jsf, jx, mode="eval").numpy())
        assert not any("graph break" in str(r.message) for r in rec2)
        assert _seg_count(sf) >= 1

    def test_other_signatures_stay_whole_compiled(self):
        def f(x, flag=False):
            # a read whose value Python uses (Dynamo captures an unused one)
            if flag and float(x.sum()) > 100.0:
                return x
            return x * 2.0

        sf = jit.to_static(f, full_graph=False, backend=BACKEND)
        x = torch.ones(2)
        np.testing.assert_array_equal(sf(x).numpy(), [2.0, 2.0])
        assert len(sf.concrete_program_specs()) == 1
        with pytest.warns(UserWarning):
            sf(x, flag=True)
        np.testing.assert_array_equal(sf(x, flag=True).numpy(), [2.0, 2.0])
        assert len(sf.concrete_program_specs()) == 1
        np.testing.assert_array_equal(sf(x).numpy(), [2.0, 2.0])
