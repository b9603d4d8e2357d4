"""The port's Adam and AdamW constructors against the JAX package's: the
same parameter names, order and defaults, so that a positional call means
the same thing on both sides, and the same options accepted.
"""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.framework.core import Parameter as JaxParameter
from paddle_tpu_torch.optimizer import Adam, AdamW


def _params(sig):
    return [(n, p.default) for n, p in sig.parameters.items() if n != "self"]


@pytest.mark.parametrize("name", ["Adam", "AdamW"])
def test_signature_matches_jax(name):
    ref = inspect.signature(getattr(paddle.optimizer, name).__init__)
    out = inspect.signature({"Adam": Adam, "AdamW": AdamW}[name].__init__)
    assert _params(out) == _params(ref)


def test_positional_eighth_argument_is_lazy_mode():
    # Adam(lr, beta1, beta2, eps, parameters, weight_decay, grad_clip, True):
    # the True is lazy_mode in both packages, so a bf16 parameter keeps no
    # float32 master and each step rounds to bf16. Weights of ~1e-2 move
    # visibly at lr 1e-3 (a bf16 step there is ~6e-5).
    r = np.random.RandomState(0)
    w = (r.randn(4, 3) * 1e-2).astype(np.float32)
    grads = [r.randn(4, 3).astype(np.float32) for _ in range(3)]
    jp = JaxParameter(jnp.asarray(w, dtype=jnp.bfloat16))
    tp = torch.nn.Parameter(torch.from_numpy(w).to(torch.bfloat16))
    jopt = paddle.optimizer.Adam(1e-3, 0.9, 0.999, 1e-8, [jp], None, None, True)
    topt = Adam(1e-3, 0.9, 0.999, 1e-8, [tp], None, None, True)
    for g in grads:
        (jp.astype("float32") * paddle.to_tensor(g)).sum().backward()
        jopt.step()
        jopt.clear_grad()
        (tp.float() * torch.from_numpy(g)).sum().backward()
        topt.step()
        topt.clear_grad()
    assert topt._master_weights == {} and jopt._master_weights == {}
    assert not topt._multi_precision
    ref = np.asarray(jp.astype("float32").numpy())
    out = tp.detach().float().numpy()
    assert not np.array_equal(out, w.astype(np.float32))
    # the same float32 update rounded once to bf16 on each side
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("cls,kw", [
    (Adam, dict(lazy_mode=True)),
    (Adam, dict(use_multi_tensor=True)),
    (AdamW, dict(lazy_mode=True)),
    (AdamW, dict(lr_ratio=lambda p: 0.5)),
])
def test_ignored_options_are_accepted(cls, kw):
    # the JAX package accepts these and ignores them: the port does too
    p = torch.nn.Parameter(torch.ones(3))
    jp = JaxParameter(jnp.ones(3, jnp.float32))
    getattr(paddle.optimizer, cls.__name__)(parameters=[jp], **kw)
    opt = cls(parameters=[p], **kw)
    p.grad = torch.full((3,), 0.5)
    opt.step()
    ref = cls(parameters=[q := torch.nn.Parameter(torch.ones(3))])
    q.grad = torch.full((3,), 0.5)
    ref.step()
    assert torch.equal(p, q)
