"""The port's layers (paddle_tpu_torch/nn/layer/{common,activation,norm,loss}.py)
against the JAX package's: each layer built in both packages, the JAX
layer's ``state_dict`` carried into the port's with ``set_state_dict`` as
numpy arrays (the layouts are equal, so no transpose), then the outputs,
the gradients of ``sum(out * ct)`` with respect to the inputs and to every
parameter (by ``state_dict`` key), and the state after the call (running
statistics, power-iteration vectors) compared at float32 rtol 1e-5 /
atol 1e-6. Training layers run three steps, then eval.
"""
import numpy as np
import pytest

import paddle_tpu as paddle
import paddle_tpu_torch as T
from test_torch_ops import A, I, N, U, _make, _np, _on_cpu  # noqa: F401

RTOL, ATOL = 1e-5, 1e-6


def _sd(layer):
    return {k: _np(v) for k, v in layer.state_dict().items()}


def carry(jl, tl):
    """The JAX layer's state into the port's; both ways' keys agree."""
    missing, unexpected = tl.set_state_dict(_sd(jl))
    assert missing == [] and unexpected == []
    assert list(tl.state_dict()) == list(jl.state_dict())


def _tensor(P, a):
    grad = np.issubdtype(a.dtype, np.floating)
    return P.to_tensor(a, place="cpu", stop_gradient=not grad)


def _call(P, layer, arrays, cts, steps):
    """``steps`` forwards of ``layer`` (the last one differentiated): the
    outputs, the input gradients, the parameter gradients by key and the
    state after."""
    outs = None
    for _ in range(steps):
        xs = [_tensor(P, a) for a in arrays]
        outs = layer(*xs)
    outs = list(outs) if isinstance(outs, (tuple, list)) else [outs]
    loss = None
    for o, ct in zip(outs, cts):
        term = P.sum(P.multiply(o, P.to_tensor(ct[:_np(o).size].reshape(_np(o).shape),
                                               place="cpu")))
        loss = term if loss is None else P.add(loss, term)
    loss.backward()
    grads = [None if x.grad is None else _np(x.grad) for x in xs]
    pgrads = {n: (None if p.grad is None else _np(p.grad)) for n, p in layer.named_parameters()}
    return [_np(o) for o in outs], grads, pgrads, _sd(layer)


def L(name, make, inputs, steps=1, train=True):
    return pytest.param(make, inputs, steps, train, id=name)


def _nn(P):
    return P.nn


ACT_LAYERS = [L(n, lambda P, n=n, a=a: getattr(_nn(P), n)(*a), [N(2, 6, 3)])
              for n, a in [("ReLU", ()), ("ReLU6", ()), ("Sigmoid", ()), ("Tanh", ()),
                           ("Silu", ()), ("Swish", ()), ("Mish", ()), ("Hardswish", ()),
                           ("Hardsigmoid", ()), ("Hardtanh", (-0.5, 0.5)), ("Tanhshrink", ()),
                           ("Softsign", ()), ("Softshrink", (0.2,)), ("Hardshrink", (0.2,)),
                           ("Softplus", (2.0, 3.0)), ("ELU", (0.7,)), ("CELU", (0.7,)),
                           ("SELU", ()), ("LeakyReLU", (0.1,)), ("GELU", (True,)),
                           ("LogSoftmax", (1,)), ("Softmax", ()), ("ThresholdedReLU", (0.3,)),
                           ("Maxout", (3,)), ("GLU", (1,))]]
ACT_LAYERS += [
    L("PReLU", lambda P: _nn(P).PReLU(3, 0.1), [N(2, 3, 4)]),
    L("PReLU_nhwc", lambda P: _nn(P).PReLU(3, 0.1, data_format="NHWC"), [N(2, 4, 3)]),
    L("Softmax2D", lambda P: _nn(P).Softmax2D(), [N(2, 3, 4, 4)]),
]

NORM_LAYERS = [
    L("LayerNorm", lambda P: _nn(P).LayerNorm([4, 5]), [N(2, 3, 4, 5)]),
    L("RMSNorm", lambda P: _nn(P).RMSNorm(8), [N(2, 3, 8)]),
    L("BatchNorm", lambda P: _nn(P).BatchNorm(3), [N(4, 3, 5)], steps=3),
    L("BatchNorm1D", lambda P: _nn(P).BatchNorm1D(3), [N(8, 3)], steps=3),
    L("BatchNorm1D_ncl", lambda P: _nn(P).BatchNorm1D(3, momentum=0.8), [N(4, 3, 5)], steps=3),
    L("BatchNorm2D", lambda P: _nn(P).BatchNorm2D(3), [N(4, 3, 5, 5)], steps=3),
    L("BatchNorm2D_nhwc", lambda P: _nn(P).BatchNorm2D(3, data_format="NHWC"),
      [N(4, 5, 5, 3)], steps=3),
    L("BatchNorm3D", lambda P: _nn(P).BatchNorm3D(2), [N(2, 2, 3, 3, 3)], steps=3),
    L("BatchNorm2D_eval", lambda P: _nn(P).BatchNorm2D(3), [N(4, 3, 5, 5)], train=False),
    L("SyncBatchNorm", lambda P: _nn(P).SyncBatchNorm(3), [N(4, 3, 5, 5)], steps=3),
    L("GroupNorm", lambda P: _nn(P).GroupNorm(2, 4), [N(2, 4, 3, 3)]),
    L("GroupNorm_nhwc", lambda P: _nn(P).GroupNorm(2, 4, data_format="NHWC"), [N(2, 3, 3, 4)]),
    L("InstanceNorm1D", lambda P: _nn(P).InstanceNorm1D(3), [N(2, 3, 6)]),
    L("InstanceNorm2D", lambda P: _nn(P).InstanceNorm2D(3), [N(2, 3, 4, 4)]),
    L("InstanceNorm3D", lambda P: _nn(P).InstanceNorm3D(3), [N(2, 3, 3, 3, 3)]),
    L("LocalResponseNorm", lambda P: _nn(P).LocalResponseNorm(3), [N(2, 5, 3, 3)]),
    L("SpectralNorm", lambda P: _nn(P).SpectralNorm([6, 4], dim=0, power_iters=2), [N(6, 4)],
      steps=2),
    L("SpectralNorm_dim1", lambda P: _nn(P).SpectralNorm([3, 5, 2], dim=1), [N(3, 5, 2)]),
    L("Linear", lambda P: _nn(P).Linear(8, 4), [N(3, 8)]),
    L("Linear_no_bias", lambda P: _nn(P).Linear(8, 4, bias_attr=False), [N(2, 3, 8)]),
    L("Embedding", lambda P: _nn(P).Embedding(10, 4, padding_idx=2),
      [A(np.array([[1, 2, 3], [2, 9, 0]]))]),
    L("Embedding_negative_padding", lambda P: _nn(P).Embedding(10, 4, padding_idx=-1),
      [A(np.array([[1, 9, 3]]))]),
]

_lbl = A(np.array([0, 3, 1, 2, 4, 3]))
_pm = A(np.where(np.arange(6) % 2, 1.0, -1.0).astype(np.float32))
LOSS_LAYERS = [
    L("CrossEntropyLoss", lambda P: _nn(P).CrossEntropyLoss(ignore_index=3,
                                                          label_smoothing=0.1),
      [N(6, 5), _lbl]),
    L("CrossEntropyLoss_weight", lambda P: _nn(P).CrossEntropyLoss(
        weight=P.to_tensor(np.linspace(0.5, 2, 5).astype(np.float32), place="cpu"),
        reduction="sum"), [N(6, 5), _lbl]),
    L("MSELoss", lambda P: _nn(P).MSELoss("sum"), [N(3, 4), N(3, 4)]),
    L("L1Loss", lambda P: _nn(P).L1Loss(), [N(3, 4), N(3, 4)]),
    L("NLLLoss", lambda P: _nn(P).NLLLoss(ignore_index=1), [N(6, 5), _lbl]),
    L("BCELoss", lambda P: _nn(P).BCELoss(), [U((3, 4), 0.05, 0.95), U((3, 4), 0, 1)]),
    L("BCEWithLogitsLoss", lambda P: _nn(P).BCEWithLogitsLoss(reduction="none"),
      [N(3, 4), U((3, 4), 0, 1)]),
    L("SmoothL1Loss", lambda P: _nn(P).SmoothL1Loss(delta=0.5), [N(3, 4), N(3, 4)]),
    L("HuberLoss", lambda P: _nn(P).HuberLoss(delta=0.5), [N(3, 4), N(3, 4)]),
    L("KLDivLoss", lambda P: _nn(P).KLDivLoss("batchmean"), [N(3, 4), U((3, 4), 0.1, 1)]),
    L("MarginRankingLoss", lambda P: _nn(P).MarginRankingLoss(0.2), [N(6), N(6), _pm]),
    L("HingeEmbeddingLoss", lambda P: _nn(P).HingeEmbeddingLoss(0.5), [N(6), _pm]),
    L("CosineEmbeddingLoss", lambda P: _nn(P).CosineEmbeddingLoss(0.1),
      [N(6, 4), N(6, 4), _pm]),
    L("TripletMarginLoss", lambda P: _nn(P).TripletMarginLoss(swap=True),
      [N(5, 4), N(5, 4), N(5, 4)]),
    L("SoftMarginLoss", lambda P: _nn(P).SoftMarginLoss(), [N(6), _pm]),
    L("MultiLabelSoftMarginLoss", lambda P: _nn(P).MultiLabelSoftMarginLoss(),
      [N(3, 4), A((np.arange(12).reshape(3, 4) % 3 == 0).astype(np.float32))]),
    L("PoissonNLLLoss", lambda P: _nn(P).PoissonNLLLoss(full=True), [N(3, 4), U((3, 4), 0, 4)]),
    L("GaussianNLLLoss", lambda P: _nn(P).GaussianNLLLoss(),
      [N(3, 4), N(3, 4), U((3, 4), 0.1, 2)]),
    L("CTCLoss", lambda P: _nn(P).CTCLoss(blank=0, reduction="sum"),
      [U((6, 2, 4), -3, 0), A(np.array([[1, 2], [3, 3]])), A(np.array([6, 5])),
       A(np.array([2, 2]))]),
]


@pytest.mark.parametrize("make,inputs,steps,train", ACT_LAYERS + NORM_LAYERS + LOSS_LAYERS)
def test_layer_matches_jax(make, inputs, steps, train):
    rng = np.random.RandomState(7)
    arrays = [_make(s, rng) for s in inputs]
    cts = [rng.standard_normal(4096).astype(np.float32) for _ in range(4)]
    paddle.seed(1)
    jl = make(paddle)
    tl = make(T)
    carry(jl, tl)
    if not train:
        jl.eval()
        tl.eval()
    got = [_call(P, layer, arrays, cts, steps) for P, layer in ((paddle, jl), (T, tl))]
    (jo, jg, jpg, jsd), (to, tg, tpg, tsd) = got
    for a, b in zip(to, jo):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    for a, b in zip(tg, jg):
        if a is None or b is None:
            assert not np.any(b if a is None else a)
            continue
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    assert set(tpg) == set(jpg)
    for k in jpg:
        if jpg[k] is None or tpg[k] is None:
            assert not np.any(jpg[k] if tpg[k] is None else tpg[k]), k
            continue
        np.testing.assert_allclose(tpg[k], jpg[k], rtol=RTOL, atol=ATOL, err_msg=k)
    assert list(tsd) == list(jsd)
    for k in jsd:
        np.testing.assert_allclose(tsd[k], jsd[k], rtol=RTOL, atol=ATOL, err_msg=k)


def test_batchnorm_running_stats_follow_paddles_momentum():
    """Three training steps of BatchNorm2D: the buffers are
    0.9 * old + 0.1 * batch (the variance unbiased), as in JAX, not torch's
    rule; eval normalises by them."""
    x = np.random.RandomState(0).randn(4, 3, 5, 5).astype(np.float32)
    bn = T.nn.BatchNorm2D(3)
    mean, var = np.zeros(3), np.ones(3)
    n = x.size // 3
    for _ in range(3):
        bn(T.to_tensor(x, place="cpu"))
        m, v = x.mean((0, 2, 3)), x.var((0, 2, 3)) * n / (n - 1)
        mean, var = 0.9 * mean + 0.1 * m, 0.9 * var + 0.1 * v
    np.testing.assert_allclose(_np(bn._mean), mean, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_np(bn._variance), var, rtol=1e-5, atol=1e-6)
    bn.eval()
    out = _np(bn(T.to_tensor(x, place="cpu")))
    want = (x - mean[None, :, None, None]) / np.sqrt(var[None, :, None, None] + 1e-5)
    np.testing.assert_allclose(out, want, rtol=1e-4, atol=1e-5)


def test_sync_batchnorm_converts_a_net_like_jax():
    got = []
    for P in (paddle, T):
        net = P.nn.Sequential(P.nn.Linear(4, 3), P.nn.BatchNorm1D(3))
        conv = P.nn.SyncBatchNorm.convert_sync_batchnorm(net)
        got.append([type(m).__name__ for m in conv.sublayers()])
    assert got[1] == got[0] == ["Linear", "SyncBatchNorm"]
