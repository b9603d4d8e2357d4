"""paddle.autograd of the port (PyLayer, the functional transforms,
saved_tensors_hooks, backward and grad with ``no_grad_vars``) against the JAX
package's, on the same numpy inputs.

Each case is written once and run with each package as ``P``. Tolerances:
float32 rtol 1e-6 (tests/test_autograd.py's own) for the transforms, whose
values are a few float32 products; 1e-5 / 1e-6 (op_test's) where a gradient
goes through a reduction. The flash-attention kernel op is held to the JAX
Pallas kernel in interpret mode at tests/test_pallas.py's backward
tolerance, 1e-4.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu_torch as T
from paddle_tpu.ops.pallas.flash_attention import flash_attention_fwd as jax_flash
from paddle_tpu_torch.device import _CURRENT
from paddle_tpu_torch.ops.cuda import flash_attention as port_fa

PACKAGES = [pytest.param(paddle, id="jax"), pytest.param(T, id="torch")]


@pytest.fixture(autouse=True)
def _on_cpu(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")
    before = _CURRENT[0]
    T.set_device("cpu")
    yield
    _CURRENT[0] = before


def _t(P, a, grad=False):
    return P.to_tensor(np.asarray(a, np.float32), place="cpu", stop_gradient=not grad)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().numpy()
    return np.asarray(t.numpy())


def _both(fn):
    """fn(P) on both packages -> (jax result, port result) as numpy trees."""
    def conv(x):
        if isinstance(x, (tuple, list)):
            return [conv(v) for v in x]
        return None if x is None else _np(x)
    return conv(fn(paddle)), conv(fn(T))


def _assert_tree(a, b, rtol=1e-6, atol=1e-7):
    if isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b)
        for x, y in zip(a, b):
            _assert_tree(x, y, rtol, atol)
        return
    assert (a is None) == (b is None)
    if a is not None:
        assert a.shape == b.shape
        np.testing.assert_allclose(b, a, rtol=rtol, atol=atol)


class TestNamespace:
    def test_every_jax_name_exists(self):
        for mod, tmod in ((paddle.autograd, T.autograd),
                          (paddle.incubate.autograd, T.incubate.autograd)):
            names = {n for n in dir(mod) if not n.startswith("_")} - {
                "functional", "py_layer", "tape"}
            assert names <= set(dir(tmod)), names - set(dir(tmod))
        for name in ("grad", "no_grad", "enable_grad", "is_grad_enabled", "set_grad_enabled"):
            assert getattr(T, name) is getattr(T.autograd, name)


class TestPyLayer:
    @pytest.mark.parametrize("P", PACKAGES)
    def test_pylayer(self, P):
        """tests/test_autograd.py test_pylayer on each package."""
        class Double(P.autograd.PyLayer):
            @staticmethod
            def forward(ctx, x):
                ctx.save_for_backward(x)
                return x * 2

            @staticmethod
            def backward(ctx, gy):
                return gy * 2

        x = P.to_tensor([3.0], place="cpu", stop_gradient=False)
        y = Double.apply(x)
        y.sum().backward()
        np.testing.assert_allclose(_np(y), [6.0])
        np.testing.assert_allclose(_np(x.grad), [2.0])

    def test_saved_tensors_and_two_outputs(self):
        def run(P):
            class MulExp(P.autograd.PyLayer):
                @staticmethod
                def forward(ctx, x, y, power=2.0):
                    e = P.exp(x)
                    ctx.save_for_backward(x, y, e)
                    ctx.power = power
                    return P.multiply(x, y), e

                @staticmethod
                def backward(ctx, g1, g2):
                    x, y, e = ctx.saved_tensor()
                    return (P.add(P.multiply(g1, y), P.multiply(g2, e)),
                            P.multiply(g1, x) * ctx.power)

            x, y = _t(P, [0.5, -1.0, 2.0], True), _t(P, [1.5, 2.0, -3.0], True)
            a, b = MulExp.apply(x, y, power=3.0)
            P.sum(P.add(P.multiply(a, _t(P, [1.0, 2.0, 3.0])), b)).backward()
            return [a, b, x.grad, y.grad]

        _assert_tree(*_both(run))

    def test_missing_and_none_grads_are_zeros(self):
        def run(P):
            class FirstOnly(P.autograd.PyLayer):
                @staticmethod
                def forward(ctx, x, y, z):
                    return P.add(P.add(x, y), z)

                @staticmethod
                def backward(ctx, g):
                    return g, None  # nothing for z, None for y

            x, y, z = (_t(P, [1.0, 2.0], True) for _ in range(3))
            P.sum(FirstOnly.apply(x, y, z)).backward()
            return [x.grad, y.grad, z.grad]

        (jx, jy, jz), (tx, ty, tz) = _both(run)
        _assert_tree([jx, jy, jz], [tx, ty, tz])
        assert not np.any(ty) and not np.any(tz)

    @pytest.mark.parametrize("P", PACKAGES)
    def test_outputs_need_grad_only_with_grad_on_and_an_input_that_needs_it(self, P):
        class Ident(P.autograd.PyLayer):
            @staticmethod
            def forward(ctx, x):
                return x * 1.0

            @staticmethod
            def backward(ctx, g):
                return g

        def needs(t):
            return t.requires_grad if isinstance(t, torch.Tensor) else not t.stop_gradient

        assert needs(Ident.apply(_t(P, [1.0], True)))
        assert not needs(Ident.apply(_t(P, [1.0], False)))
        with P.no_grad():
            assert not needs(Ident.apply(_t(P, [1.0], True)))

    @pytest.mark.parametrize("P", PACKAGES)
    def test_forward_runs_without_grad(self, P):
        seen = []

        class Probe(P.autograd.PyLayer):
            @staticmethod
            def forward(ctx, x):
                seen.append(P.is_grad_enabled())
                return x * 2.0

            @staticmethod
            def backward(ctx, g):
                seen.append(P.is_grad_enabled())
                return g * 2.0

        P.sum(Probe.apply(_t(P, [1.0], True))).backward()
        assert seen == [False, False]


class TestFunctionalTransforms:
    """tests/test_autograd.py's TestFunctionalTransforms through both
    packages, and the output structure of tuple inputs and outputs."""

    def test_jacobian_single_input(self):
        _assert_tree(*_both(lambda P: P.autograd.jacobian(
            lambda x: (x * x).sum(), _t(P, [1.0, 2.0, 3.0]))))

    def test_jacobian_vector_output(self):
        j, t = _both(lambda P: P.autograd.jacobian(lambda x: x ** 3, _t(P, [1.0, 2.0])))
        _assert_tree(j, t)
        np.testing.assert_allclose(t, np.diag([3.0, 12.0]), rtol=1e-6)

    def test_hessian(self):
        j, t = _both(lambda P: P.autograd.hessian(lambda x: (x ** 3).sum(), _t(P, [1.0, 2.0])))
        _assert_tree(j, t)
        np.testing.assert_allclose(t, np.diag([6.0, 12.0]), rtol=1e-6)

    def test_jvp_vjp_consistency(self):
        def run(P):
            x, v = _t(P, [0.5, -1.0]), _t(P, [1.0, 0.0])
            out, tangent = P.incubate.autograd.jvp(lambda x: P.sin(x), x, v)
            out2, grads = P.incubate.autograd.vjp(lambda x: P.sin(x), x, v)
            return [out, tangent, out2, grads]

        j, t = _both(run)
        _assert_tree(j, t, atol=1e-7)
        np.testing.assert_allclose(t[1], [np.cos(0.5), 0.0], atol=1e-7)

    def test_batched_jacobian(self):
        j, t = _both(lambda P: P.autograd.Jacobian(
            lambda x: (x * 2).sum(), _t(P, np.ones((4, 3))), is_batched=True))
        _assert_tree(j, t)
        assert t.shape == (4, 3)

    def test_hessian_through_model_ops(self):
        X = np.array([[1.0, 2.0], [3.0, 4.0]], np.float32)

        def run(P):
            Xt = _t(P, X)
            return P.autograd.hessian(lambda w: (P.matmul(Xt, w) ** 2).sum(),
                                      _t(P, [[0.5], [1.5]]))

        j, t = _both(run)
        _assert_tree(j, t, rtol=1e-5)
        np.testing.assert_allclose(t.reshape(2, 2), 2.0 * X.T @ X, rtol=1e-5)

    def test_tuple_inputs_and_outputs(self):
        def run(P):
            xs = (_t(P, [1.0, 2.0]), _t(P, [0.5, -1.0]))

            def f(a, b):
                return P.multiply(a, b), P.sum(P.exp(a))

            jac = P.autograd.jacobian(f, xs)
            hes = P.autograd.hessian(lambda a, b: P.sum(P.multiply(P.multiply(a, a), b)), xs)
            out, tan = P.autograd.jvp(f, xs)  # v=None: ones
            out2, cot = P.autograd.vjp(f, xs)
            return [jac, hes, out, tan, out2, cot]

        _assert_tree(*_both(run), rtol=1e-6)

    def test_vjp_with_cotangent_and_jvp_tangent(self):
        def run(P):
            x = _t(P, [[1.0, 2.0], [3.0, -1.0]])
            v = _t(P, [[0.5, 1.0], [-2.0, 0.25]])
            f = lambda x: P.tanh(P.matmul(x, x))  # noqa: E731
            return [P.autograd.vjp(f, x, v)[1], P.autograd.jvp(f, x, v)[1]]

        _assert_tree(*_both(run), rtol=1e-5, atol=1e-6)

    def test_batched_hessian(self):
        _assert_tree(*_both(lambda P: P.autograd.Hessian(
            lambda x: P.sum(P.multiply(P.exp(x), x)), _t(P, [[0.1, 0.2], [0.3, -0.4]]),
            is_batched=True)), rtol=1e-5)


class TestThroughTheKernelOp:
    """The flash-attention op (on the CPU, the plain versions behind the same
    torch.library op the card launches) under the transforms."""

    def _qkv(self):
        r = np.random.RandomState(0)
        return [r.randn(1, 8, 2, 32).astype(np.float32) for _ in range(3)]

    def test_vjp_equals_autograd_and_jax(self):
        q, k, v = self._qkv()
        ct = np.random.RandomState(1).randn(*q.shape).astype(np.float32)
        tq = [torch.from_numpy(a) for a in (q, k, v)]

        def f(q, k, v):
            return port_fa.flash_attention_fwd(q, k, v, causal=True)

        out, grads = T.autograd.vjp(f, tq, torch.from_numpy(ct))
        req = [a.clone().requires_grad_(True) for a in tq]
        ref = torch.autograd.grad(f(*req), req, torch.from_numpy(ct))
        for g, r in zip(grads, ref):
            assert torch.equal(g, r)
        _, jpull = jax.vjp(lambda q, k, v: jax_flash(q, k, v, causal=True),
                           *(jnp.asarray(a) for a in (q, k, v)))
        for g, jg in zip(grads, jpull(jnp.asarray(ct))):
            np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-4, atol=1e-4)

    def test_jvp_raises_in_both(self):
        """A JAX custom_vjp function cannot be jvp'd, nor can the port's
        kernel op, which has an autograd formula and no forward-mode rule;
        hessian (forward over reverse) raises in both too."""
        q, k, v = self._qkv()
        with pytest.raises(TypeError):
            jax.jvp(lambda q: jax_flash(q, jnp.asarray(k), jnp.asarray(v)),
                    (jnp.asarray(q),), (jnp.ones_like(jnp.asarray(q)),))
        with pytest.raises(TypeError, match="forward-mode"):
            T.autograd.jvp(lambda q: port_fa.flash_attention_fwd(
                q, torch.from_numpy(k), torch.from_numpy(v)), torch.from_numpy(q))
        with pytest.raises(Exception):  # noqa: B017 (in interpret mode, an AssertionError)
            jax.hessian(lambda q: jnp.sum(jax_flash(q, jnp.asarray(k), jnp.asarray(v))))(
                jnp.asarray(q))
        with pytest.raises((TypeError, RuntimeError)):
            T.autograd.hessian(lambda q: T.sum(port_fa.flash_attention_fwd(
                q, torch.from_numpy(k[:, :2]), torch.from_numpy(v[:, :2]))),
                torch.from_numpy(q[:, :2]))

    def test_jacobian_through_the_kernel_op_matches_jax(self):
        q, k, v = (a[:, :4, :1, :8] for a in self._qkv())
        tj = T.autograd.jacobian(lambda q: port_fa.flash_attention_fwd(
            q, torch.from_numpy(k), torch.from_numpy(v), causal=True), torch.from_numpy(q))
        jj = jax.jacrev(lambda q: jax_flash(q, jnp.asarray(k), jnp.asarray(v), causal=True))(
            jnp.asarray(q))
        assert tuple(tj.shape) == jj.shape == q.shape * 2
        np.testing.assert_allclose(tj.numpy(), np.asarray(jj), rtol=1e-4, atol=1e-4)


class TestSavedTensorsHooks:
    def test_pack_unpack_see_saved_tensors_and_keep_gradients(self):
        def run(P):
            packed = []

            def pack(t):
                packed.append(1)
                return t

            x = _t(P, [0.5, 1.5, -2.0], True)
            with P.autograd.saved_tensors_hooks(pack, lambda t: t):
                y = P.sum(P.multiply(P.exp(x), x))
            y.backward()
            assert packed
            return [y, x.grad]

        _assert_tree(*_both(run), rtol=1e-6)

    def test_unpack_hook_value_is_what_backward_reads(self):
        x = T.to_tensor([1.0, 2.0], stop_gradient=False)
        with T.autograd.saved_tensors_hooks(lambda t: t * 0 + 3.0, lambda t: t):
            y = T.sum(T.multiply(x, x))
        y.backward()
        np.testing.assert_allclose(x.grad.numpy(), [6.0, 6.0])


class TestGrad:
    def _graph(self, P):
        x = _t(P, [1.0, 2.0, -0.5], True)
        a = P.multiply(x, x)
        b = P.exp(x)
        out = P.sum(P.add(P.multiply(a, b), b))
        return x, a, b, out

    def test_no_grad_vars_matches_jax(self):
        def run(P):
            x, a, b, out = self._graph(P)
            return [P.grad(out, x, no_grad_vars=[a], retain_graph=True)[0],
                    P.grad(out, [x, a], no_grad_vars=[b])[0]]

        _assert_tree(*_both(run), rtol=1e-6)

    def test_input_reached_only_through_a_blocked_var(self):
        def run(P):
            x = _t(P, [1.0, 2.0], True)
            a = P.multiply(x, x)
            out = P.sum(P.exp(a))
            got = P.grad(out, x, no_grad_vars=[a], allow_unused=True, retain_graph=True)
            with pytest.raises(RuntimeError, match="unused"):
                P.grad(out, x, no_grad_vars=[a])
            return got

        j, t = _both(run)
        assert j == [None] and t == [None]

    def test_grad_of_an_input_in_no_grad_vars_is_none(self):
        def run(P):
            x = _t(P, [1.0, 2.0], True)
            y = _t(P, [3.0, 4.0], True)
            out = P.sum(P.multiply(x, y))
            return P.grad(out, [x, y], no_grad_vars=[y], allow_unused=True)

        j, t = _both(run)
        assert j[1] is None and t[1] is None
        _assert_tree(j[0], t[0])

    def test_create_graph_second_order(self):
        def run(P):
            x = _t(P, [0.5, 1.5], True)
            (g,) = P.grad(P.sum(P.multiply(P.multiply(x, x), x)), x, create_graph=True)
            (h,) = P.grad(P.sum(g), x)
            return [g, h]

        _assert_tree(*_both(run), rtol=1e-6)

    def test_backward_with_grad_tensors(self):
        def run(P):
            x = _t(P, [1.0, 2.0], True)
            y = P.multiply(x, x)
            P.autograd.backward([y], [_t(P, [0.5, -1.0])])
            return [x.grad]

        _assert_tree(*_both(run))
