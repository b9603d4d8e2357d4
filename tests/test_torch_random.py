"""The port's samplers (``ops/random_ops.py``) against the JAX package's.

The two packages draw from different generators (torch's Philox/MT streams,
JAX's threefry keys), so they are compared by distribution, not value by
value: the same call in each package gives the same dtype and shape; each
package's seeded draw repeats itself; and every continuous sampler's
2**14 samples pass a Kolmogorov-Smirnov test against scipy's CDF at the
stated bound, D < 1.95 / sqrt(n) (the 0.1% critical value), in both
packages; the discrete ones hold their support and their mean within 6
standard errors. ``gumbel_softmax``'s op is held to JAX's on the same noise
(values and the straight-through gradient, float32 op_test tolerance).
"""
import numpy as np
import pytest
import torch
from scipy import stats

import paddle_tpu as paddle
import paddle_tpu_torch as T
from paddle_tpu.framework.core import Tensor as JTensor
from paddle_tpu.ops import random_ops as jrandom
from paddle_tpu_torch import jit
from paddle_tpu_torch.device import _CURRENT
from paddle_tpu_torch.ops import random_ops as trandom

PACKAGES = [pytest.param(paddle, id="jax"), pytest.param(T, id="torch")]
N = 2 ** 14
KS_BOUND = 1.95 / np.sqrt(N)


@pytest.fixture(autouse=True)
def _on_cpu():
    before = _CURRENT[0]
    T.set_device("cpu")
    yield
    _CURRENT[0] = before
    torch._dynamo.reset()


def _np(t):
    if isinstance(t, torch.Tensor):
        t = t.detach()
        return (t.float() if t.dtype in (torch.bfloat16, torch.float16) else t).numpy()
    return np.asarray(t.numpy())


def _dtype(t):
    return str(t.dtype).removeprefix("torch.") if isinstance(t, torch.Tensor) else \
        np.dtype(t.dtype).name


def _tensor(P, a):
    return P.to_tensor(np.asarray(a), place="cpu")


DRAWS = [
    ("rand", lambda P: P.rand([3, 4])),
    ("rand_f64", lambda P: P.rand([5], dtype="float64")),
    ("randn", lambda P: P.randn((2, 3))),
    ("randn_bf16", lambda P: P.randn([4], dtype="bfloat16")),
    ("standard_normal", lambda P: P.standard_normal([3])),
    ("normal", lambda P: P.normal(1.0, 2.0, [2, 2])),
    ("normal_tensor", lambda P: P.normal(_tensor(P, np.zeros((3, 1), np.float32)),
                                         _tensor(P, np.ones((1, 2), np.float64)))),
    ("uniform", lambda P: P.uniform([6], min=-2.0, max=3.0)),
    ("uniform_seed", lambda P: P.uniform([4], dtype="float64", seed=11)),
    ("randint", lambda P: P.randint(2, 9, [4, 2])),
    ("randint_high_none_int32", lambda P: P.randint(5, shape=[3], dtype="int32")),
    ("randint_like", lambda P: P.randint_like(_tensor(P, np.zeros((2, 3), np.int32)), 0, 4)),
    ("randperm", lambda P: P.randperm(7)),
    ("randperm_int32", lambda P: P.randperm(5, dtype="int32")),
    ("bernoulli", lambda P: P.bernoulli(_tensor(P, np.full((4, 3), 0.3, np.float32)))),
    ("poisson", lambda P: P.poisson(_tensor(P, np.full((5,), 2.5, np.float32)))),
    ("multinomial", lambda P: P.multinomial(_tensor(P, np.array([0.1, 0.2, 0.7], np.float32)),
                                            2)),
    ("multinomial_rows_replace", lambda P: P.multinomial(
        _tensor(P, np.array([[0.5, 0.5, 0.0], [0.2, 0.3, 0.5]], np.float32)), 4,
        replacement=True)),
    ("rand_like", lambda P: P.rand_like(_tensor(P, np.zeros((2, 2), np.float64)))),
    ("randn_like_dtype", lambda P: P.randn_like(_tensor(P, np.zeros((3,), np.float32)),
                                                dtype="float64")),
    ("gumbel_softmax", lambda P: P.nn.functional.gumbel_softmax(
        _tensor(P, np.zeros((2, 5), np.float32)), hard=True)),
]
FILLS = ["uniform_", "normal_", "bernoulli_", "exponential_", "cauchy_", "geometric_",
         "log_normal_"]


def _fill(P, name):
    x = _tensor(P, np.zeros((3, 4), np.float32))
    args = {"geometric_": (0.3,)}.get(name, ())
    out = getattr(P, name)(x, *args) if hasattr(P, name) else getattr(jrandom, name)(x, *args)
    assert out is x
    return x


@pytest.mark.parametrize("name,draw", DRAWS, ids=[d[0] for d in DRAWS])
def test_dtype_shape_and_seeded_repeat(name, draw):
    outs = {}
    for P in (paddle, T):
        P.seed(1234)
        a = draw(P)
        P.seed(1234)
        b = draw(P)
        np.testing.assert_array_equal(_np(a), _np(b))
        outs[P] = a
    j, t = outs[paddle], outs[T]
    assert _dtype(t) == _dtype(j)
    assert tuple(t.shape) == tuple(j.shape)


@pytest.mark.parametrize("name", FILLS)
def test_in_place_fills(name):
    outs = []
    for P in (paddle, T):
        P.seed(7)
        a = _np(_fill(P, name)).copy()
        P.seed(7)
        np.testing.assert_array_equal(_np(_fill(P, name)), a)
        outs.append(a)
    assert outs[0].shape == outs[1].shape and outs[0].dtype == outs[1].dtype


def test_fill_writes_a_leaf_that_requires_grad_without_recording():
    w = torch.zeros(4, requires_grad=True)
    T.normal_(w)
    assert w.is_leaf and w.requires_grad and w.grad_fn is None
    assert torch.count_nonzero(w) == 4


CONTINUOUS = [
    ("rand", lambda P: P.rand([N]), stats.uniform().cdf),
    ("uniform", lambda P: P.uniform([N], min=-2.0, max=3.0), stats.uniform(-2, 5).cdf),
    ("randn", lambda P: P.randn([N]), stats.norm().cdf),
    ("normal", lambda P: P.normal(1.5, 0.5, [N]), stats.norm(1.5, 0.5).cdf),
    ("exponential_", lambda P: _big_fill(P, "exponential_", 2.0), stats.expon(scale=0.5).cdf),
    ("cauchy_", lambda P: _big_fill(P, "cauchy_", 1.0, 2.0), stats.cauchy(1.0, 2.0).cdf),
    ("log_normal_", lambda P: _big_fill(P, "log_normal_", 0.5, 0.25),
     stats.lognorm(s=0.25, scale=np.exp(0.5)).cdf),
    ("normal_", lambda P: _big_fill(P, "normal_", -1.0, 3.0), stats.norm(-1.0, 3.0).cdf),
    ("uniform_", lambda P: _big_fill(P, "uniform_", 0.0, 4.0), stats.uniform(0, 4).cdf),
]


def _big_fill(P, name, *args):
    x = _tensor(P, np.zeros((N,), np.float32))
    fn = getattr(P, name) if hasattr(P, name) else getattr(jrandom, name)
    return fn(x, *args)


@pytest.mark.parametrize("name,draw,cdf", CONTINUOUS, ids=[c[0] for c in CONTINUOUS])
def test_continuous_distribution(name, draw, cdf):
    for P in (paddle, T):
        P.seed(3)
        d = stats.kstest(_np(draw(P)).astype(np.float64), cdf).statistic
        assert d < KS_BOUND, (P.__name__, d)


def _mean_within(samples, mean, var, sigmas=6.0):
    se = np.sqrt(var / samples.size)
    assert abs(samples.mean() - mean) < sigmas * se, (samples.mean(), mean)


@pytest.mark.parametrize("P", PACKAGES)
def test_discrete_distributions(P):
    P.seed(5)
    r = _np(P.randint(-3, 4, [N]))
    assert r.min() == -3 and r.max() == 3
    _mean_within(r, 0.0, (7 ** 2 - 1) / 12)
    counts = np.bincount(r + 3, minlength=7)
    assert (np.abs(counts - N / 7) < 6 * np.sqrt(N / 7)).all()
    b = _np(P.bernoulli(_tensor(P, np.full((N,), 0.3, np.float32))))
    assert set(np.unique(b)) <= {0.0, 1.0}
    _mean_within(b, 0.3, 0.21)
    p = _np(P.poisson(_tensor(P, np.full((N,), 4.0, np.float32))))
    assert (p >= 0).all() and (p == np.round(p)).all()
    _mean_within(p, 4.0, 4.0)
    g = _np(_big_fill(P, "geometric_", 0.25))
    assert g.min() >= 1 and (g == np.round(g)).all()
    _mean_within(g, 4.0, 0.75 / 0.25 ** 2)
    m = _np(P.multinomial(_tensor(P, np.array([0.1, 0.2, 0.7], np.float32)), N,
                          replacement=True))
    freq = np.bincount(m, minlength=3) / N
    np.testing.assert_allclose(freq, [0.1, 0.2, 0.7], atol=6 * np.sqrt(0.25 / N))


@pytest.mark.parametrize("P", PACKAGES)
def test_randperm_is_a_permutation(P):
    P.seed(0)
    np.testing.assert_array_equal(np.sort(_np(P.randperm(1000))), np.arange(1000))


@pytest.mark.parametrize("P", PACKAGES)
def test_multinomial_without_replacement(P):
    P.seed(2)
    probs = _tensor(P, np.array([[0.05, 0.4, 0.05, 0.3, 0.2], [0.2] * 5], np.float32))
    out = _np(P.multinomial(probs, 5))
    for row in out:
        assert sorted(row.tolist()) == list(range(5))
    one = _np(P.multinomial(_tensor(P, np.array([0.0, 1.0, 0.0], np.float32)), 1))
    np.testing.assert_array_equal(one, [1])
    with pytest.raises(ValueError):
        P.multinomial(_tensor(P, np.array([0.5, 0.5], np.float32)), 3)


@pytest.mark.parametrize("P", PACKAGES)
def test_uniform_seed_is_its_own_stream(P):
    """``uniform(seed=s)`` draws from a generator of its own: the same s
    gives the same values, and the global stream does not move."""
    P.seed(9)
    a1 = _np(P.rand([4]))
    s1 = _np(P.uniform([3], seed=21))
    a2 = _np(P.rand([4]))
    P.seed(9)
    np.testing.assert_array_equal(_np(P.rand([4])), a1)
    np.testing.assert_array_equal(_np(P.uniform([3], seed=21)), s1)
    np.testing.assert_array_equal(_np(P.rand([4])), a2)
    assert not np.array_equal(_np(P.uniform([3], seed=22)), s1)


class TestGumbelSoftmax:
    def _inputs(self):
        r = np.random.RandomState(0)
        x = r.standard_normal((3, 5)).astype(np.float32)
        u = r.uniform(size=(3, 5)).astype(np.float32)
        g = -np.log(-np.log(u + 1e-20) + 1e-20)
        ct = r.standard_normal((3, 5)).astype(np.float32)
        return x, g, ct

    @pytest.mark.parametrize("hard", [False, True])
    def test_op_matches_jax_on_the_same_noise(self, hard):
        x, g, ct = self._inputs()
        jx = paddle.to_tensor(x, stop_gradient=False)
        jy = jrandom._gs(jx, JTensor(g), temperature=0.5, hard=hard, axis=-1)
        paddle.sum(paddle.multiply(jy, paddle.to_tensor(ct))).backward()
        tx = torch.from_numpy(x).requires_grad_(True)
        ty = trandom._gs(tx, torch.from_numpy(g), temperature=0.5, hard=hard, axis=-1)
        T.sum(T.multiply(ty, torch.from_numpy(ct))).backward()
        np.testing.assert_allclose(_np(ty), _np(jy), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(_np(tx.grad), _np(jx.grad), rtol=1e-5, atol=1e-6)
        if hard:
            assert set(np.unique(_np(ty))) == {0.0, 1.0}
            np.testing.assert_array_equal(_np(ty).sum(-1), 1.0)

    def test_hard_gradient_is_the_softmax_gradient(self):
        """Straight through: the hard sample's gradient is the soft one's."""
        x, g, ct = self._inputs()
        grads = []
        for hard in (False, True):
            tx = torch.from_numpy(x).requires_grad_(True)
            y = trandom._gs(tx, torch.from_numpy(g), temperature=0.7, hard=hard)
            (y * torch.from_numpy(ct)).sum().backward()
            grads.append(tx.grad)
        torch.testing.assert_close(grads[1], grads[0], rtol=1e-6, atol=1e-7)


def test_seeded_draw_under_to_static_repeats():
    """Inside a compiled graph the samplers draw without an explicit
    generator (Dynamo cannot take one): the default generator seeds the
    graph's RNG, so a seeded compiled run repeats itself."""
    fn = jit.to_static(lambda x: T.add(x, T.rand([4])), backend="aot_eager")
    x = torch.zeros(4)
    T.seed(17)
    a = fn(x)
    T.seed(17)
    b = fn(x)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert 0.0 <= float(a.min()) and float(a.max()) < 1.0


def test_every_jax_sampler_exists():
    names = {n for n in dir(jrandom) if not n.startswith("_")} - {
        "annotations", "np", "jax", "jnp", "rng", "dtype_mod", "Tensor", "defop"}
    assert names <= set(dir(trandom)), names - set(dir(trandom))
    for n in names:
        if hasattr(paddle, n):
            assert hasattr(T, n), n
