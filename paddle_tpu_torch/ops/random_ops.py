"""Random sampling ops: the port of ``paddle_tpu/ops/random_ops.py``.

The JAX package draws from functional PRNG keys split off its global state;
the port draws from the device's default ``torch.Generator``
(``framework/random.py`` ``generator``), passed to each torch sampler
explicitly, so ``paddle_tpu_torch.seed`` fixes every draw on the CPU and on
the card (the two packages' streams differ; their distributions agree).
``uniform(seed=s)`` draws from a fresh generator seeded with ``s``, as the
JAX function draws from ``jax.random.key(s)``. Samples are built on the
current device (``resolve_device``); the ``*_like`` and in-place forms on
their tensor's. The in-place fills write under no-grad, as the JAX
package's ``_replace_value`` does.

Under ``jit.to_static`` the samplers pass no generator: Dynamo cannot take
a ``torch.Generator``, so a compiled graph draws with Inductor's own
Philox RNG, seeded from the same default generator. A seeded compiled run
is deterministic from run to run; its values are not eager's.
"""
from __future__ import annotations

import numpy as np
import torch

from ..framework import dtype as dtype_mod
from ..framework import random as rng
from ._apply import defop


def _dt(dtype, default=None):
    d = dtype_mod.convert_dtype(dtype)
    return d if d is not None else (default or dtype_mod.get_default_dtype())


def _shape(shape):
    if isinstance(shape, torch.Tensor):
        return tuple(int(s) for s in shape.reshape(-1).tolist())
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(s) for s in shape)


def _device(device=None):
    from .. import resolve_device

    return resolve_device(None) if device is None else torch.device(device)


def _gen(device):
    """The explicit generator, or None inside a compiled region."""
    if torch.compiler.is_compiling():
        return None
    return rng.generator(device)


def rand(shape, dtype=None, name=None):
    return uniform(shape, dtype=dtype, min=0.0, max=1.0)


def randn(shape, dtype=None, name=None):
    dev = _device()
    return torch.randn(_shape(shape), dtype=_dt(dtype), device=dev, generator=_gen(dev))


def standard_normal(shape, dtype=None, name=None):
    return randn(shape, dtype)


def normal(mean=0.0, std=1.0, shape=None, name=None):
    if isinstance(mean, torch.Tensor) or isinstance(std, torch.Tensor):
        ref = mean if isinstance(mean, torch.Tensor) else std
        m = mean if isinstance(mean, torch.Tensor) else torch.tensor(mean, device=ref.device)
        s = std if isinstance(std, torch.Tensor) else torch.tensor(std, device=ref.device)
        d = dtype_mod.promote_types(m.dtype, s.dtype)
        out_shape = torch.broadcast_shapes(m.shape, s.shape)
        z = torch.randn(out_shape, dtype=d, device=ref.device, generator=_gen(ref.device))
        return z * s.to(d) + m.to(d)
    dev = _device()
    shape = _shape(shape if shape is not None else [1])
    z = torch.randn(shape, dtype=dtype_mod.get_default_dtype(), device=dev, generator=_gen(dev))
    return z * std + mean


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0, name=None):  # noqa: A002
    dev = _device()
    if seed:
        gen = torch.Generator(dev).manual_seed(int(seed))
    else:
        gen = _gen(dev)
    u = torch.rand(_shape(shape), dtype=_dt(dtype), device=dev, generator=gen)
    return u * (float(max) - float(min)) + float(min)


def uniform_(x, min=-1.0, max=1.0, seed=0, name=None):  # noqa: A002
    gen = (torch.Generator(x.device).manual_seed(int(seed)) if seed else _gen(x.device))
    with torch.no_grad():
        x.uniform_(float(min), float(max), generator=gen)
    return x


def randint(low=0, high=None, shape=(1,), dtype="int64", name=None):
    if high is None:
        low, high = 0, low
    dev = _device()
    return torch.randint(int(low), int(high), _shape(shape), dtype=_dt(dtype, torch.int64),
                         device=dev, generator=_gen(dev))


def randint_like(x, low=0, high=None, dtype=None, name=None):
    if high is None:
        low, high = 0, low
    return torch.randint(int(low), int(high), tuple(x.shape), dtype=_dt(dtype, x.dtype),
                         device=x.device, generator=_gen(x.device))


def randperm(n, dtype="int64", name=None):
    dev = _device()
    return torch.randperm(int(n), dtype=_dt(dtype, torch.int64), device=dev,
                          generator=_gen(dev))


def bernoulli(x, name=None):
    return torch.bernoulli(x.detach(), generator=_gen(x.device))


def bernoulli_(x, p=0.5, name=None):
    with torch.no_grad():
        x.bernoulli_(float(p), generator=_gen(x.device))
    return x


def poisson(x, name=None):
    return torch.poisson(x.detach(), generator=_gen(x.device))


def multinomial(x, num_samples=1, replacement=False, name=None):
    """Category indices (int64) drawn with the probabilities ``x`` (a row,
    or one row a sample, normalized); without replacement no index
    repeats within a row, and more samples than categories raise
    ``ValueError``, as ``jax.random.choice`` does."""
    n = int(num_samples)
    if not replacement and n > x.shape[-1]:
        raise ValueError("Cannot take a larger sample than population when 'replace=False'")
    return torch.multinomial(x.detach().float(), n, replacement=bool(replacement),
                             generator=_gen(x.device))


def exponential_(x, lam=1.0, name=None):
    with torch.no_grad():
        x.exponential_(float(lam), generator=_gen(x.device))
    return x


def cauchy_(x, loc=0, scale=1, name=None):
    with torch.no_grad():
        x.cauchy_(float(loc), float(scale), generator=_gen(x.device))
    return x


def geometric_(x, probs, name=None):
    """The trial of the first success, 1, 2, ... (the JAX package's
    ``ceil(log1p(-u) / log1p(-p))``)."""
    with torch.no_grad():
        x.geometric_(float(probs), generator=_gen(x.device))
    return x


def log_normal_(x, mean=1.0, std=2.0, name=None):
    with torch.no_grad():
        x.log_normal_(float(mean), float(std), generator=_gen(x.device))
    return x


def normal_(x, mean=0.0, std=1.0, name=None):
    with torch.no_grad():
        x.normal_(float(mean), float(std), generator=_gen(x.device))
    return x


def rand_like(x, dtype=None, name=None):
    return torch.rand(tuple(x.shape), dtype=_dt(dtype, x.dtype), device=x.device,
                      generator=_gen(x.device))


def randn_like(x, dtype=None, name=None):
    return torch.randn(tuple(x.shape), dtype=_dt(dtype, x.dtype), device=x.device,
                       generator=_gen(x.device))


@defop("gumbel_softmax_inner")
def _gs(x, g, temperature=1.0, hard=False, axis=-1):
    y = torch.softmax((x + g.to(x.dtype)) / temperature, dim=axis)
    if hard:
        idx = torch.argmax(y, dim=axis, keepdim=True)
        y_hard = torch.zeros_like(y).scatter_(axis, idx, 1.0)
        # straight-through: the forward is y_hard, the gradient the softmax's
        y = y_hard - y.detach() + y
    return y


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None):
    """Gumbel noise drawn outside the op (so a master-grad rerun of the op
    sees the same noise), then the op ``gumbel_softmax_inner``."""
    u = torch.rand(tuple(x.shape), dtype=torch.float32, device=x.device,
                   generator=_gen(x.device))
    g = -torch.log(-torch.log(u + 1e-20) + 1e-20)
    return _gs(x, g, temperature=float(temperature), hard=bool(hard), axis=int(axis))
