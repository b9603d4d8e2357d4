"""The activation, norm and loss functionals of the port
(paddle_tpu_torch/nn/functional/{activation,norm,loss}.py) against the JAX
package's, case by case.

Each case is written once and called with each package as ``P`` on the same
numpy inputs (from a seed per case): outputs and their dtypes, and the
gradients of ``sum(out * ct)`` for the same random ``ct`` on both sides with
respect to every floating input. Tolerances: float32 rtol 1e-5 / atol 1e-6,
as tests/test_torch_ops.py (tests/test_nn.py holds the JAX layers to 1e-5).
Every reduction of every loss, ``cross_entropy`` with ``ignore_index``,
label smoothing, soft labels, ``weight=`` and ``use_softmax=False``,
``ctc_loss`` over ragged lengths, ``batch_norm`` three training steps then
eval with its running statistics, and the channel-last forms of
``instance_norm``, ``group_norm`` and ``local_response_norm``.
"""
import numpy as np
import pytest

import paddle_tpu as paddle
import paddle_tpu_torch as T
from test_torch_ops import (A, I, N, U, _case_seed, _dtype, _is_float, _make, _np,  # noqa: F401
                            _on_cpu, _run)

RTOL, ATOL = 1e-5, 1e-6


def C(name, fn, inputs=(), grad=True, rtol=RTOL, atol=ATOL, same_dtype=True):
    return pytest.param(fn, inputs, grad, rtol, atol, same_dtype, id=name)


def F(P):
    return P.nn.functional


def S(*shape):
    """±1 labels."""
    return A(np.where(np.random.RandomState(sum(shape)).rand(*shape) > 0.5, 1.0, -1.0)
             .astype(np.float32))


def _ctc(P, lp, labels, ilen, llen, reduction):
    return F(P).ctc_loss(F(P).log_softmax(lp, -1), labels, ilen, llen, blank=0,
                         reduction=reduction)


def _bn_steps(P, x, w, b, data_format="NCHW"):
    c = x.shape[1] if data_format.startswith("NC") else x.shape[-1]
    rm, rv = P.zeros([c]), P.ones([c])
    outs = [F(P).batch_norm(x, rm, rv, w, b, training=True, momentum=0.9,
                            data_format=data_format) for _ in range(3)]
    return outs + [rm, rv, F(P).batch_norm(x, rm, rv, w, b, training=False,
                                           data_format=data_format)]


ACT = [
    C("relu", lambda P, x: F(P).relu(x), [N(3, 4)]),
    C("relu6", lambda P, x: F(P).relu6(x), [U((3, 4), -8, 8)]),
    C("sigmoid", lambda P, x: F(P).sigmoid(x), [N(3, 4)]),
    C("tanh", lambda P, x: F(P).tanh(x), [N(3, 4)]),
    C("silu", lambda P, x: F(P).silu(x), [N(3, 4)]),
    C("swish", lambda P, x: F(P).swish(x), [N(3, 4)]),
    C("mish", lambda P, x: F(P).mish(x), [N(3, 4)]),
    C("hardswish", lambda P, x: F(P).hardswish(x), [U((3, 4), -5, 5)]),
    C("hardsigmoid", lambda P, x: F(P).hardsigmoid(x), [U((3, 4), -5, 5)]),
    C("hardsigmoid_slope", lambda P, x: F(P).hardsigmoid(x, 0.3, 0.2), [U((3, 4), -5, 5)]),
    C("hardtanh", lambda P, x: F(P).hardtanh(x, -0.5, 0.7), [N(3, 4)]),
    C("tanhshrink", lambda P, x: F(P).tanhshrink(x), [N(3, 4)]),
    C("softsign", lambda P, x: F(P).softsign(x), [N(3, 4)]),
    C("selu", lambda P, x: F(P).selu(x), [N(3, 4)]),
    C("celu", lambda P, x: F(P).celu(x, 0.5), [N(3, 4)]),
    C("elu", lambda P, x: F(P).elu(x, 1.5), [N(3, 4)]),
    C("leaky_relu", lambda P, x: F(P).leaky_relu(x, 0.2), [N(3, 4)]),
    C("prelu_scalar", lambda P, x, w: F(P).prelu(x, w), [N(2, 3, 4), U((1,), 0.1, 0.5)]),
    C("prelu_nchw", lambda P, x, w: F(P).prelu(x, w), [N(2, 3, 4, 4), U((3,), 0.1, 0.5)]),
    C("prelu_nhwc", lambda P, x, w: F(P).prelu(x, w, data_format="NHWC"),
      [N(2, 4, 4, 3), U((3,), 0.1, 0.5)]),
    C("gelu", lambda P, x: F(P).gelu(x), [N(3, 4)]),
    C("gelu_tanh", lambda P, x: F(P).gelu(x, approximate=True), [N(3, 4)]),
    C("softmax", lambda P, x: F(P).softmax(x, axis=1), [N(2, 5, 3)]),
    C("softmax_dtype", lambda P, x: F(P).softmax(x, dtype="float64"), [N(2, 5)],
      grad=False),
    C("log_softmax", lambda P, x: F(P).log_softmax(x, axis=-1), [N(2, 5, 3)]),
    C("softplus", lambda P, x: F(P).softplus(x, beta=2.0, threshold=5.0), [U((4, 5), -6, 6)]),
    C("softshrink", lambda P, x: F(P).softshrink(x, 0.3), [N(3, 4)]),
    C("hardshrink", lambda P, x: F(P).hardshrink(x, 0.3), [N(3, 4)]),
    C("thresholded_relu", lambda P, x: F(P).thresholded_relu(x, 0.5, 0.1), [N(3, 4)]),
    C("maxout", lambda P, x: F(P).maxout(x, 2, axis=1), [N(2, 6, 3)]),
    C("glu", lambda P, x: F(P).glu(x, axis=-1), [N(3, 6)]),
    C("swiglu", lambda P, x: F(P).swiglu(x), [N(3, 6)]),
    C("swiglu_pair", lambda P, x, y: F(P).swiglu(x, y), [N(3, 4), N(3, 4)]),
]

NORM = [
    C("layer_norm", lambda P, x, w, b: F(P).layer_norm(x, [4, 5], w, b, 1e-5),
      [N(2, 3, 4, 5), N(4, 5), N(4, 5)]),
    C("layer_norm_plain", lambda P, x: F(P).layer_norm(x, 5), [N(3, 5)]),
    C("rms_norm", lambda P, x, w: F(P).rms_norm(x, w, None, 1e-6), [N(2, 3, 8), N(8)]),
    C("batch_norm_train_eval", lambda P, x, w, b: _bn_steps(P, x, w, b),
      [N(4, 3, 5, 5), N(3), N(3)]),
    C("batch_norm_nhwc", lambda P, x, w, b: _bn_steps(P, x, w, b, "NHWC"),
      [N(4, 5, 5, 3), N(3), N(3)]),
    C("batch_norm_1d", lambda P, x, w, b: _bn_steps(P, x, w, b, "NC"), [N(8, 3), N(3), N(3)]),
    C("batch_norm_global_stats", lambda P, x, m, v: F(P).batch_norm(
        x, m, v, training=True, use_global_stats=True), [N(4, 3, 5), N(3), U((3,), 0.5, 2)]),
    C("instance_norm_nchw", lambda P, x, w, b: F(P).instance_norm(x, weight=w, bias=b),
      [N(2, 3, 4, 5), N(3), N(3)]),
    C("instance_norm_nhwc", lambda P, x, w, b: F(P).instance_norm(
        x, weight=w, bias=b, data_format="NHWC"), [N(2, 4, 5, 3), N(3), N(3)]),
    C("group_norm_nchw", lambda P, x, w, b: F(P).group_norm(x, 2, 1e-5, w, b),
      [N(2, 4, 3, 3), N(4), N(4)]),
    C("group_norm_nhwc", lambda P, x, w, b: F(P).group_norm(x, 2, 1e-5, w, b, "NHWC"),
      [N(2, 3, 3, 4), N(4), N(4)]),
    C("local_response_norm", lambda P, x: F(P).local_response_norm(x, 3), [N(2, 5, 3, 3)]),
    C("local_response_norm_nhwc", lambda P, x: F(P).local_response_norm(
        x, 4, alpha=1e-2, beta=0.5, k=2.0, data_format="NHWC"), [N(2, 3, 3, 5)]),
]

REDUCTIONS = ("mean", "sum", "none")
LOSS = [
    C("cross_entropy", lambda P, x, y: F(P).cross_entropy(x, y), [N(6, 5), I((6,), 0, 5)]),
    C("cross_entropy_ignore", lambda P, x, y: F(P).cross_entropy(x, y, ignore_index=2),
      [N(6, 5), A(np.array([0, 2, 1, 2, 4, 3]))]),
    C("cross_entropy_smoothing", lambda P, x, y: F(P).cross_entropy(
        x, y, label_smoothing=0.1), [N(6, 5), I((6,), 0, 5)]),
    C("cross_entropy_soft", lambda P, x, y: F(P).cross_entropy(
        x, F(P).softmax(y), soft_label=True), [N(6, 5), N(6, 5)]),
    C("cross_entropy_soft_smoothing", lambda P, x, y: F(P).cross_entropy(
        x, F(P).softmax(y), soft_label=True, label_smoothing=0.2), [N(6, 5), N(6, 5)]),
    C("cross_entropy_axis1", lambda P, x, y: F(P).cross_entropy(x, y, axis=1),
      [N(2, 5, 3), I((2, 1, 3), 0, 5)]),
    C("cross_entropy_probs", lambda P, x, y: F(P).cross_entropy(
        F(P).softmax(x), y, use_softmax=False), [N(6, 5), I((6,), 0, 5)]),
    C("softmax_with_cross_entropy", lambda P, x, y: F(P).softmax_with_cross_entropy(
        x, y, return_softmax=True), [N(6, 5), I((6, 1), 0, 5)]),
    C("nll_loss", lambda P, x, y: F(P).nll_loss(F(P).log_softmax(x), y, ignore_index=1),
      [N(6, 5), A(np.array([0, 1, 1, 2, 4, 3]))]),
]
for _r in REDUCTIONS:
    LOSS += [
        C(f"cross_entropy_weight_{_r}", lambda P, x, y, w, r=_r: F(P).cross_entropy(
            x, y, weight=w, ignore_index=3, reduction=r),
          [N(6, 5), A(np.array([0, 3, 1, 2, 4, 3])), U((5,), 0.5, 2)]),
        C(f"nll_loss_weight_{_r}", lambda P, x, y, w, r=_r: F(P).nll_loss(
            x, y, weight=w, reduction=r), [N(6, 5), I((6,), 0, 5), U((5,), 0.5, 2)]),
        C(f"mse_{_r}", lambda P, x, y, r=_r: F(P).mse_loss(x, y, r), [N(3, 4), N(3, 4)]),
        C(f"l1_{_r}", lambda P, x, y, r=_r: F(P).l1_loss(x, y, r), [N(3, 4), N(3, 4)]),
        C(f"smooth_l1_{_r}", lambda P, x, y, r=_r: F(P).smooth_l1_loss(x, y, r, delta=0.7),
          [N(3, 4), N(3, 4)]),
        C(f"huber_{_r}", lambda P, x, y, r=_r: F(P).huber_loss(x, y, 0.7, r),
          [N(3, 4), N(3, 4)]),
        C(f"bce_{_r}", lambda P, x, y, w, r=_r: F(P).binary_cross_entropy(x, y, w, r),
          [U((3, 4), 0.05, 0.95), U((3, 4), 0, 1), U((4,), 0.5, 2)]),
        C(f"bce_logits_{_r}", lambda P, x, y, w, pw, r=_r: F(P).binary_cross_entropy_with_logits(
            x, y, w, r, pos_weight=pw), [N(3, 4), U((3, 4), 0, 1), U((4,), 0.5, 2),
                                         U((4,), 0.5, 2)]),
        C(f"kl_div_{_r}", lambda P, x, y, r=_r: F(P).kl_div(F(P).log_softmax(x), F(P).softmax(y),
                                                            r), [N(3, 4), N(3, 4)]),
        C(f"margin_ranking_{_r}", lambda P, x, o, y, r=_r: F(P).margin_ranking_loss(
            x, o, y, 0.1, r), [N(6), N(6), S(6)]),
        C(f"hinge_embedding_{_r}", lambda P, x, y, r=_r: F(P).hinge_embedding_loss(
            x, y, 0.5, r), [N(3, 4), S(3, 4)]),
        C(f"cosine_embedding_{_r}", lambda P, a, b, y, r=_r: F(P).cosine_embedding_loss(
            a, b, y, 0.1, r), [N(5, 4), N(5, 4), S(5)]),
        C(f"triplet_margin_{_r}", lambda P, a, p, n, r=_r: F(P).triplet_margin_loss(
            a, p, n, reduction=r), [N(5, 4), N(5, 4), N(5, 4)]),
        C(f"soft_margin_{_r}", lambda P, x, y, r=_r: F(P).soft_margin_loss(x, y, r),
          [N(3, 4), S(3, 4)]),
        C(f"multi_label_soft_margin_{_r}", lambda P, x, y, w, r=_r:
          F(P).multi_label_soft_margin_loss(x, y, w, r),
          [N(3, 4), A(np.array([[1, 0, 1, 0], [0, 0, 1, 1], [1, 1, 0, 0]], np.float32)),
           U((4,), 0.5, 2)]),
        C(f"poisson_nll_{_r}", lambda P, x, y, r=_r: F(P).poisson_nll_loss(x, y, reduction=r),
          [N(3, 4), U((3, 4), 0, 4)]),
        C(f"gaussian_nll_{_r}", lambda P, x, y, v, r=_r: F(P).gaussian_nll_loss(
            x, y, v, reduction=r), [N(3, 4), N(3, 4), U((3, 4), 0.1, 2)]),
        C(f"ctc_{_r}", lambda P, lp, y, il, ll, r=_r: _ctc(P, lp, y, il, ll, r),
          [N(7, 3, 5), I((3, 3), 1, 5), A(np.array([7, 5, 6])), A(np.array([3, 1, 2]))]),
    ]
LOSS += [
    C("kl_div_batchmean", lambda P, x, y: F(P).kl_div(F(P).log_softmax(x), F(P).softmax(y),
                                                      "batchmean"), [N(3, 4), N(3, 4)]),
    C("kl_div_log_target", lambda P, x, y: F(P).kl_div(
        F(P).log_softmax(x), F(P).log_softmax(y), "sum", log_target=True), [N(3, 4), N(3, 4)]),
    C("triplet_margin_swap_p1", lambda P, a, p, n: F(P).triplet_margin_loss(
        a, p, n, margin=0.5, p=1.0, swap=True), [N(5, 4), N(5, 4), N(5, 4)]),
    C("poisson_nll_full_linear", lambda P, x, y: F(P).poisson_nll_loss(
        x, y, log_input=False, full=True), [U((3, 4), 0.2, 3), U((3, 4), 0, 4)]),
    # the JAX function adds a numpy float64 constant, which makes its result
    # float64 (the package runs JAX with x64 on); the port's stays float32
    C("gaussian_nll_full", lambda P, x, y, v: F(P).gaussian_nll_loss(x, y, v, full=True),
      [N(3, 4), N(3, 4), U((3, 4), 0.1, 2)], same_dtype=False),
    C("sigmoid_ce_with_logits", lambda P, x, y: F(P).sigmoid_cross_entropy_with_logits(x, y),
      [N(3, 4), U((3, 4), 0, 1)]),
    C("square_error_cost", lambda P, x, y: F(P).square_error_cost(x, y), [N(3, 4), N(3, 4)]),
    C("log_loss", lambda P, x, y: F(P).log_loss(x, y), [U((5, 1), 0.05, 0.95),
                                                       U((5, 1), 0, 1)]),
    C("dice_loss", lambda P, x, y: F(P).dice_loss(F(P).softmax(x), y),
      [N(2, 3, 4), I((2, 3, 1), 0, 4)]),
    C("ctc_blank_label_repeats", lambda P, lp, y, il, ll: _ctc(P, lp, y, il, ll, "none"),
      [N(6, 2, 4), A(np.array([[2, 2, 3], [1, 3, 3]])), A(np.array([6, 6])),
       A(np.array([3, 2]))]),
]


@pytest.mark.parametrize("fn,inputs,grad,rtol,atol,same_dtype", ACT + NORM + LOSS)
def test_functional_matches_jax(fn, inputs, grad, rtol, atol, same_dtype):
    seed = _case_seed(fn)
    rng = np.random.RandomState(seed)
    arrays = [_make(s, rng) for s in inputs]
    rng = np.random.RandomState(seed + 1)
    cts = [rng.standard_normal(2048).astype(np.float32) for _ in range(8)]
    jout, _ = _run(paddle, fn, arrays, False, False, None)
    tout, _ = _run(T, fn, arrays, False, False, None)
    assert len(jout) == len(tout)
    for j, t in zip(jout, tout):
        assert _dtype(t) == _dtype(j) or not same_dtype
        np.testing.assert_allclose(_np(t), _np(j), rtol=rtol, atol=atol)
    if grad:
        shaped = [c[:_np(o).size] for c, o in zip(cts, [o for o in jout if _is_float(o)])]
        _, jgrads = _run(paddle, fn, arrays, True, False, shaped)
        _, tgrads = _run(T, fn, arrays, True, False, shaped)
        assert len(jgrads) == len(tgrads)
        for jg, tg in zip(jgrads, tgrads):
            # an input the output does not depend on: no gradient in one
            # package, zeros in the other
            if jg is None or tg is None:
                assert not np.any(tg if jg is None else jg)
                continue
            np.testing.assert_allclose(tg, jg, rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", ["relu_", "softmax_"])
def test_inplace_activations_write_x(name):
    arr = np.random.RandomState(3).randn(3, 4).astype(np.float32)
    got = []
    for P in (paddle, T):
        x = P.to_tensor(arr, place="cpu")
        out = getattr(F(P), name)(x)
        got.append(_np(x))
        assert out is x
    np.testing.assert_allclose(got[1], got[0], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("op,category", [
    ("relu", None), ("gelu", None), ("softmax", "black"), ("log_softmax", "black"),
    ("layer_norm", "black"), ("batch_norm_train", "black"), ("group_norm_op", "black"),
    ("lrn_op", None), ("cross_entropy", "black"), ("bce_loss", "black"),
    ("bce_with_logits", "black"), ("kl_div", "black"), ("ctc_loss_op", "black"),
    ("mse_loss", None), ("dice_loss_op", None)])
def test_ops_carry_the_jax_name_and_amp_category(op, category):
    from paddle_tpu.ops import _apply as jap
    from paddle_tpu_torch.ops import _apply as tap

    T.nn.functional  # noqa: B018  (registers the ops)
    assert tap.get_registry()[op].amp_category == category
    assert jap.get_registry()[op].amp_category == category
