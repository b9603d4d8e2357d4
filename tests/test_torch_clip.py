"""Gradient clipping of the PyTorch port against the JAX package's
(paddle_tpu/nn/clip.py): the same gradients, from numpy seeds, through every
clipper on both sides, with a ``need_clip=False`` parameter and in bfloat16.
The JAX formulas are not torch's (``clip / max(norm, clip)`` for the global
norm, ``min(max / max(total, 1e-6), 1)`` for ``clip_grad_norm_``), so the
port is held to them."""
import numpy as np
import pytest

import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu.nn import clip as jclip
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.framework import Parameter
from paddle_tpu_torch.nn import clip as tclip

_SHAPES = [(3, 4), (7,), (2, 2, 3)]


def _grads(seed, scale=1.0):
    r = np.random.RandomState(seed)
    return [(r.randn(*s) * scale).astype(np.float32) for s in _SHAPES]


def _pairs(arrays, dtype, skip=()):
    """(JAX pairs, port pairs) over fresh parameters; ``skip`` indices have
    ``need_clip`` False."""
    jpairs, tpairs = [], []
    for i, a in enumerate(arrays):
        jp = paddle.Parameter(paddle.to_tensor(np.zeros_like(a)).value)
        tp = Parameter(torch.zeros(a.shape))
        jp.need_clip = tp.need_clip = i not in skip
        jg = paddle.to_tensor(a)
        tg = torch.from_numpy(a)
        if dtype == "bfloat16":
            jg, tg = jg.astype("bfloat16"), tg.bfloat16()
        jpairs.append((jp, jg))
        tpairs.append((tp, tg))
    return jpairs, tpairs


def _np(g):
    return np.asarray(g.numpy() if not isinstance(g, torch.Tensor) else g.float().numpy(),
                      np.float32)


_CLIPS = {
    "value": lambda m: m.ClipGradByValue(0.7),
    "value_min": lambda m: m.ClipGradByValue(0.9, min=-0.2),
    "norm": lambda m: m.ClipGradByNorm(1.5),
    "global_norm": lambda m: m.ClipGradByGlobalNorm(2.0),
    "global_norm_no_clip": lambda m: m.ClipGradByGlobalNorm(1e3),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("skip", [(), (1,)], ids=["all", "need_clip_false"])
@pytest.mark.parametrize("name", sorted(_CLIPS))
def test_clip_matches_jax(name, skip, dtype):
    arrays = _grads(1, scale=2.0)
    jpairs, tpairs = _pairs(arrays, dtype, skip)
    ref = _CLIPS[name](jnn)(jpairs)
    out = _CLIPS[name](tnn)(tpairs)
    assert [p for p, _ in out] == [p for p, _ in tpairs]
    # bf16: both round the product to bf16 (one step is 2**-8 relative)
    tol = dict(rtol=1e-6, atol=1e-6) if dtype == "float32" else dict(rtol=2 ** -7, atol=1e-3)
    for i, ((_, jg), (_, tg)) in enumerate(zip(ref, out)):
        assert tg.dtype == tpairs[i][1].dtype
        np.testing.assert_allclose(_np(tg), _np(jg), **tol, err_msg=str(i))
        if i in skip:
            assert tg is tpairs[i][1]


def test_global_norm_scales_to_the_clip():
    arrays = _grads(2, scale=5.0)
    _, tpairs = _pairs(arrays, "float32")
    out = tnn.ClipGradByGlobalNorm(1.0)(tpairs)
    total = np.sqrt(sum(float((a.astype(np.float64) ** 2).sum()) for a in arrays))
    np.testing.assert_allclose(float(tclip.global_norm([g for _, g in tpairs])), total,
                               rtol=1e-6)
    np.testing.assert_allclose(float(tclip.global_norm([g for _, g in out])), 1.0, rtol=1e-6)
    # the pairs' gradients are new tensors: the caller's are untouched
    for (_, g), a in zip(tpairs, arrays):
        np.testing.assert_array_equal(g.numpy(), a)


def _with_grads(arrays, dtype):
    jps, tps = [], []
    for a in arrays:
        jp = paddle.Parameter(paddle.to_tensor(np.zeros_like(a)).value)
        jg = paddle.to_tensor(a)
        tp = Parameter(torch.zeros(a.shape, dtype=getattr(torch, dtype)))
        tp.grad = torch.from_numpy(a.copy()).to(tp.dtype)
        if dtype == "bfloat16":
            jg = jg.astype("bfloat16")
        jp._grad = jg
        jps.append(jp)
        tps.append(tp)
    return jps, tps


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("norm_type,max_norm", [(2.0, 1.0), (2.0, 1e4), (1.0, 3.0),
                                                (float("inf"), 0.5)],
                         ids=["l2", "l2_no_clip", "l1", "inf"])
def test_clip_grad_norm_matches_jax(norm_type, max_norm, dtype):
    arrays = _grads(3, scale=2.0)
    jps, tps = _with_grads(arrays, dtype)
    ref = jclip.clip_grad_norm_(jps, max_norm, norm_type=norm_type)
    out = tclip.clip_grad_norm_(tps, max_norm, norm_type=norm_type)
    tol = dict(rtol=1e-6, atol=1e-6) if dtype == "float32" else dict(rtol=2 ** -7, atol=1e-3)
    np.testing.assert_allclose(float(out), float(ref.numpy()), **tol)
    for jp, tp in zip(jps, tps):
        assert tp.grad.dtype == (torch.float32 if dtype == "float32" else torch.bfloat16)
        np.testing.assert_allclose(_np(tp.grad), _np(jp.grad), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_clip_grad_value_matches_jax(dtype):
    arrays = _grads(4, scale=2.0)
    jps, tps = _with_grads(arrays, dtype)
    jclip.clip_grad_value_(jps, 0.8)
    tclip.clip_grad_value_(tps, 0.8)
    for jp, tp in zip(jps, tps):
        np.testing.assert_array_equal(_np(tp.grad), _np(jp.grad))


def test_single_tensor_and_no_grads():
    p = Parameter(torch.zeros(3))
    assert float(tclip.clip_grad_norm_(p, 1.0)) == 0.0
    p.grad = torch.tensor([3.0, 4.0, 0.0])
    assert float(tclip.clip_grad_norm_(p, 1.0)) == pytest.approx(5.0)
    torch.testing.assert_close(p.grad, torch.tensor([0.6, 0.8, 0.0]))
