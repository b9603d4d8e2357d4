"""``ops.fuse`` of the port (one ``torch.compile`` region per key of the
static arguments) against the JAX package's ``fuse`` (one ``jax.jit``
region per key), and the fused ``_rope_cos_sin`` of the port's LLaMA module
against the JAX model's.

Tolerances: the fused function equals its eager self within 1e-6 (Inductor
fuses the elementwise chain without reassociating it); against the JAX
function 1e-6 at float32 up to 16 positions. Past that the two packages'
tables part by the rounding of the angle t * inv_freq: XLA's pow and
torch's round theta ** x to neighbouring floats (1 ulp, 1.2e-7 relative),
which position t multiplies, so the bound there is 2 * t_max * 2**-23.
bfloat16 tables within one bfloat16 ulp (2**-8) of the JAX ones.
Inductor compiles on the CPU here, as in tests/test_torch_jit.py.
"""
import inspect

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.llama import _rope_cos_sin as jax_rope_cos_sin
from paddle_tpu_torch.models.llama import _rope_cos_sin
from paddle_tpu_torch.ops import fuse


@pytest.fixture(autouse=True)
def _fresh_dynamo():
    torch._dynamo.reset()
    yield
    torch._dynamo.reset()


def _chain(x, scale, shift):
    return torch.tanh(x * scale) + shift


def test_variant_per_static_key_signature_and_wrapped():
    f = fuse(_chain, static_argnums=(1, 2))
    assert f.__wrapped__ is _chain
    assert inspect.signature(f) == inspect.signature(_chain)
    assert f.__name__ == "_chain"
    x = torch.randn(4, 8)
    for scale, shift in ((2.0, 0.5), (2.0, 0.5), (3.0, 0.5), (2.0, -1.0)):
        np.testing.assert_allclose(f(x, scale, shift).numpy(),
                                   _chain(x, scale, shift).numpy(), rtol=1e-6, atol=1e-6)
    assert sorted(f.variants) == [(2.0, -1.0), (2.0, 0.5), (3.0, 0.5)]
    # each key compiled one program of its own
    assert all(backend.graphs == 1 for _, backend in f.variants.values())


def test_decorator_forms_match_jax_contract():
    @fuse
    def plain(x):
        return torch.sigmoid(x) * 2

    @fuse(static_argnums=0)
    def by_n(n, x):
        return x.reshape(n, -1).sum(0)

    x = torch.arange(12.0)
    np.testing.assert_allclose(plain(x).numpy(), (torch.sigmoid(x) * 2).numpy(), rtol=1e-6)
    assert list(plain.variants) == [()]
    np.testing.assert_allclose(by_n(3, x).numpy(), x.reshape(3, -1).sum(0).numpy())
    np.testing.assert_allclose(by_n(4, x).numpy(), x.reshape(4, -1).sum(0).numpy())
    assert sorted(by_n.variants) == [(3,), (4,)]

    # the JAX decorator's same contract: wrapped, signature, static variants
    from paddle_tpu.ops import fuse as jfuse

    import jax.numpy as jnp

    def jchain(x, scale, shift):
        return jnp.tanh(x * scale) + shift

    jf = jfuse(jchain, static_argnums=(1, 2))
    assert jf.__wrapped__ is jchain
    assert inspect.signature(jf) == inspect.signature(jchain)
    xn = np.random.RandomState(0).randn(4, 8).astype("float32")
    np.testing.assert_allclose(
        fuse(_chain, static_argnums=(1, 2))(torch.from_numpy(xn), 2.0, 0.5).numpy(),
        np.asarray(jf(jnp.asarray(xn), 2.0, 0.5)), rtol=1e-6, atol=1e-6)


def test_more_keys_than_the_recompile_limit_stay_compiled():
    f = fuse(_chain, static_argnums=(1,))
    x = torch.randn(8)
    limit = torch._dynamo.config.recompile_limit
    for k in range(limit + 2):
        np.testing.assert_allclose(f(x, float(k + 1), 0.0).numpy(),
                                   _chain(x, float(k + 1), 0.0).numpy(), rtol=1e-6, atol=1e-6)
    assert len(f.variants) == limit + 2
    assert all(backend.graphs == 1 for _, backend in f.variants.values())


def test_compile_failure_raises_no_fallback():
    @fuse
    def host_read(x):
        if x.sum().item() > 0:  # a host read: no whole graph
            return x * 2
        return x

    with pytest.raises((torch._dynamo.exc.Unsupported, torch._dynamo.exc.UserError)):
        host_read(torch.ones(3))
    assert host_read.variants == {}


def test_inside_a_compiled_region_traces_inline():
    f = fuse(_chain, static_argnums=(1, 2))

    @torch.compile(backend="aot_eager", fullgraph=True)
    def outer(x):
        return f(x, 2.0, 0.5) * 3

    x = torch.randn(5)
    np.testing.assert_allclose(outer(x).numpy(), (_chain(x, 2.0, 0.5) * 3).numpy(), rtol=1e-6)
    assert f.variants == {}  # no region of its own: inlined into the outer graph


@pytest.mark.parametrize("seq,dim", [(8, 32), (16, 64)])
def test_rope_cos_sin_matches_jax(seq, dim):
    jc, js = jax_rope_cos_sin(seq, dim, 10000.0, "float32")
    tc, ts = _rope_cos_sin(seq, dim, 10000.0, torch.float32, "cpu")
    assert tc.shape == (seq, dim) and tc.dtype == torch.float32
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-6)


@pytest.mark.parametrize("seq,dim,theta", [(128, 128, 10000.0), (512, 64, 500000.0)])
def test_rope_cos_sin_long_tables_within_angle_rounding(seq, dim, theta):
    jc, js = jax_rope_cos_sin(seq, dim, theta, "float32")
    tc, ts = _rope_cos_sin(seq, dim, theta, torch.float32, "cpu")
    ec, es = _rope_cos_sin.__wrapped__(seq, dim, theta, torch.float32, "cpu")
    bound = 2 * seq * 2.0 ** -23
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=bound)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=bound)
    # fused against eager: the same arithmetic
    np.testing.assert_allclose(tc.numpy(), ec.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), es.numpy(), rtol=0, atol=1e-6)


def test_rope_cos_sin_bfloat16_and_one_variant_per_key():
    jc, js = jax_rope_cos_sin(16, 32, 10000.0, paddle.bfloat16)
    tc, ts = _rope_cos_sin(16, 32, 10000.0, torch.bfloat16, "cpu")
    assert tc.dtype == torch.bfloat16
    np.testing.assert_allclose(tc.float().numpy(), np.asarray(jc, np.float32), atol=2.0 ** -8)
    np.testing.assert_allclose(ts.float().numpy(), np.asarray(js, np.float32), atol=2.0 ** -8)
    before = len(_rope_cos_sin.variants)
    _rope_cos_sin(16, 32, 10000.0, torch.bfloat16, "cpu")
    assert len(_rope_cos_sin.variants) == before
    assert (16, 32, 10000.0, torch.bfloat16, "cpu") in _rope_cos_sin.variants
