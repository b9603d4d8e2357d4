"""The port's functional batch and its layers (paddle_tpu_torch/nn/functional/
extras.py, nn/layer/extras.py, ``RNNTLoss``) against the JAX package's.

Cases as in tests/test_torch_nn_common.py (outputs, dtypes, gradients;
float32 rtol 1e-5 / atol 1e-6): ``grid_sample`` in each mode and padding
mode with ``align_corners`` both ways and a grid reaching past the image,
``rnnt_loss`` over ragged lengths in every reduction (float64, as in JAX),
``hsigmoid_loss`` with the default paths and custom tables (per class and
per sample), ``sparse_attention`` on a random CSR layout,
``flashmask_attention`` in its causal and non-causal forms and GQA,
``max_unpool*`` from ``max_pool*``'s masks, the in-place activations.

The random ones cannot be compared draw for draw: ``rrelu`` in training
keeps its slopes inside the bounds, ``fractional_max_pool*`` without
``random_u`` covers its input, ``class_center_sample`` always samples every
positive class, ``feature_alpha_dropout`` drops whole channels, and each
repeats under the port's ``seed``.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as T
from test_torch_nn_common import C, F, L, check_functional, check_layer
from test_torch_ops import A, I, N, U, _np, _on_cpu  # noqa: F401

RTOL, ATOL = 1e-5, 1e-6


def _t(P, a):
    return P.to_tensor(a, place="cpu")


def _grid_cases():
    out = []
    for mode in ("bilinear", "nearest"):
        for pad in ("zeros", "border", "reflection"):
            for ac in (True, False):
                out.append(C(f"grid_sample_{mode}_{pad}_{'ac' if ac else 'hp'}",
                             lambda P, x, g, m=mode, p=pad, a=ac: F(P).grid_sample(
                                 x, g, mode=m, padding_mode=p, align_corners=a),
                             [N(2, 3, 5, 6), U((2, 4, 3, 2), -1.3, 1.3)]))
    return out


def _sri_causal():
    r = np.random.RandomState(3)
    start = r.randint(4, 9, (1, 1, 8, 1))
    end = np.minimum(start + r.randint(0, 3, start.shape), 8)
    return A(np.concatenate([start, end], -1).astype(np.int64))


def _sri_noncausal(k):
    r = np.random.RandomState(4)
    lt = r.randint(3, 9, (2, 2, 8, 1))
    ut = r.randint(0, 3, (2, 2, 8, 1))
    cols = [lt, np.minimum(lt + 2, 8), ut, ut + 1] if k == 4 else [lt, ut]
    return A(np.concatenate(cols, -1).astype(np.int64))


def _csr():
    """A random (B=1, H=2, S=6) CSR layout, the diagonal always in."""
    r = np.random.RandomState(5)
    offs = np.zeros((1, 2, 7), np.int64)
    cols = []
    for h in range(2):
        row_cols = []
        for i in range(6):
            c = sorted(set(r.choice(6, r.randint(1, 4), replace=False)) | {i})
            row_cols += c
            offs[0, h, i + 1] = offs[0, h, i] + len(c)
        cols.append(row_cols)
    width = max(len(c) for c in cols)
    return offs, np.array([c + [0] * (width - len(c)) for c in cols], np.int64)[None]


_OFFS, _COLS = _csr()
_RNNT_LABELS = A(np.array([[1, 2, 3], [4, 1, 0], [2, 0, 0]]))
_RNNT_ILEN, _RNNT_LLEN = A(np.array([5, 4, 2])), A(np.array([3, 2, 1]))

FUNCTIONAL = [
    C("log_sigmoid", lambda P, x: F(P).log_sigmoid(x), [N(3, 4)]),
    C("rrelu_eval", lambda P, x: F(P).rrelu(x, 0.1, 0.3), [N(3, 4)]),
    C("pairwise_distance", lambda P, a, b: F(P).pairwise_distance(a, b), [N(4, 5), N(4, 5)]),
    C("pairwise_distance_p1_keepdim", lambda P, a, b: F(P).pairwise_distance(
        a, b, p=1.0, keepdim=True), [N(4, 5), N(4, 5)]),
    C("pairwise_distance_inf", lambda P, a, b: F(P).pairwise_distance(a, b, p=float("inf")),
      [N(4, 5), N(4, 5)]),
    C("npair_loss", lambda P, a, b, y: F(P).npair_loss(a, b, y),
      [N(6, 4), N(6, 4), A(np.array([0, 1, 0, 2, 1, 3]))]),
    C("sigmoid_focal_loss", lambda P, x, y: F(P).sigmoid_focal_loss(x, y),
      [N(4, 3), U((4, 3), 0, 1)]),
    C("sigmoid_focal_loss_mean_norm", lambda P, x, y, n: F(P).sigmoid_focal_loss(
        x, y, normalizer=n, alpha=0.4, gamma=1.5, reduction="mean"),
      [N(4, 3), U((4, 3), 0, 1), U((1,), 1, 3)]),
    C("sigmoid_focal_loss_none", lambda P, x, y: F(P).sigmoid_focal_loss(x, y, reduction="none"),
      [N(4, 3), U((4, 3), 0, 1)]),
    C("multi_margin_loss", lambda P, x, y: F(P).multi_margin_loss(x, y),
      [N(5, 4), A(np.array([0, 3, 1, 2, 3]))]),
    C("multi_margin_loss_p2_weight", lambda P, x, y, w: F(P).multi_margin_loss(
        x, y, p=2, margin=0.5, weight=w, reduction="sum"),
      [N(5, 4), A(np.array([0, 3, 1, 2, 3])), U((4,), 0.5, 2)]),
    C("multi_margin_loss_none", lambda P, x, y: F(P).multi_margin_loss(x, y, reduction="none"),
      [N(5, 4), A(np.array([0, 3, 1, 2, 3]))]),
    C("triplet_margin_with_distance_loss", lambda P, a, b, c:
      F(P).triplet_margin_with_distance_loss(a, b, c), [N(5, 4), N(5, 4), N(5, 4)]),
    C("triplet_margin_with_distance_loss_swap_custom", lambda P, a, b, c:
      F(P).triplet_margin_with_distance_loss(
          a, b, c, distance_function=lambda u, v: P.sum(P.abs(P.subtract(u, v)), axis=-1),
          margin=2.0, swap=True, reduction="none"), [N(5, 4), N(5, 4), N(5, 4)]),
    C("margin_cross_entropy", lambda P, x, y: F(P).margin_cross_entropy(x, y),
      [U((6, 5), -0.9, 0.9), A(np.array([0, 4, 2, 2, 1, 3]))]),
    C("margin_cross_entropy_softmax", lambda P, x, y: F(P).margin_cross_entropy(
        x, y, margin1=0.9, margin2=0.2, margin3=0.1, scale=16.0, return_softmax=True,
        reduction="none"), [U((6, 5), -0.9, 0.9), A(np.array([0, 4, 2, 2, 1, 3]))]),
    C("affine_grid", lambda P, th: F(P).affine_grid(th, [2, 3, 4, 5]), [N(2, 2, 3)]),
    C("affine_grid_half_pixel", lambda P, th: F(P).affine_grid(th, [2, 3, 5, 4],
                                                               align_corners=False),
      [N(2, 2, 3)]),
    *_grid_cases(),
    C("temporal_shift", lambda P, x: F(P).temporal_shift(x, 3), [N(6, 8, 2, 3)]),
    C("temporal_shift_nhwc", lambda P, x: F(P).temporal_shift(x, 2, 0.2, "NHWC"),
      [N(4, 2, 3, 10)]),
    C("zeropad2d", lambda P, x: F(P).zeropad2d(x, [1, 2, 0, 1]), [N(2, 3, 4, 5)]),
    C("gather_tree", lambda P, i, p: F(P).gather_tree(i, p),
      [I((5, 2, 3), 0, 9), I((5, 2, 3), 0, 3)], grad=False),
    C("lp_pool1d", lambda P, x: F(P).lp_pool1d(x, 2, 3, 2), [U((2, 3, 9), 0.5, 2)]),
    C("lp_pool2d", lambda P, x: F(P).lp_pool2d(x, 3, 2, padding=1), [U((2, 3, 6, 5), 0.5, 2)]),
    C("lp_pool2d_nhwc", lambda P, x: F(P).lp_pool2d(x, 2, [2, 3], data_format="NHWC"),
      [U((2, 6, 6, 3), 0.5, 2)]),
    C("max_unpool2d", lambda P, x: F(P).max_unpool2d(*F(P).max_pool2d(x, 2, return_mask=True),
                                                     2), [N(2, 3, 6, 4)]),
    C("max_unpool2d_output_size", lambda P, x: F(P).max_unpool2d(
        *F(P).max_pool2d(x, 2, return_mask=True), 2, output_size=[7, 5]), [N(2, 3, 7, 5)]),
    C("max_unpool1d", lambda P, x, i: F(P).max_unpool1d(x, i, 2),
      [N(2, 3, 4), A(2 * np.arange(4)[None, None] + np.random.RandomState(0).randint(
          0, 2, (2, 3, 4)))]),
    C("max_unpool3d", lambda P, x: F(P).max_unpool3d(*F(P).max_pool3d(x, 2, return_mask=True),
                                                     2), [N(1, 2, 4, 4, 6)]),
    C("flashmask_attention_none", lambda P, q, k, v: F(P).flashmask_attention(q, k, v,
                                                                              causal=True),
      [N(2, 8, 2, 4), N(2, 8, 2, 4), N(2, 8, 2, 4)]),
    C("flashmask_attention_causal_gqa", lambda P, q, k, v, s: F(P).flashmask_attention(
        q, k, v, s, causal=True), [N(1, 8, 2, 4), N(1, 8, 1, 4), N(1, 8, 1, 4), _sri_causal()]),
    C("flashmask_attention_noncausal_2", lambda P, q, k, v, s: F(P).flashmask_attention(
        q, k, v, s), [N(2, 8, 2, 4), N(2, 8, 2, 4), N(2, 8, 2, 4), _sri_noncausal(2)]),
    C("flashmask_attention_noncausal_4", lambda P, q, k, v, s: F(P).flashmask_attention(
        q, k, v, s), [N(2, 8, 2, 4), N(2, 8, 2, 4), N(2, 8, 2, 4), _sri_noncausal(4)]),
    C("hsigmoid_loss_default", lambda P, x, y, w, b: F(P).hsigmoid_loss(x, y, 6, w, b),
      [N(5, 4), A(np.array([0, 5, 2, 3, 1])), N(5, 4), N(5)]),
    C("hsigmoid_loss_no_bias", lambda P, x, y, w: F(P).hsigmoid_loss(x, y, 7, w),
      [N(5, 4), A(np.array([0, 6, 2, 3, 1])), N(6, 4)]),
    C("hsigmoid_loss_custom_per_class", lambda P, x, y, w, t, c: F(P).hsigmoid_loss(
        x, y, 4, w, path_table=t, path_code=c),
      [N(5, 4), A(np.array([0, 3, 2, 3, 1])), N(5, 4),
       A(np.array([[0, 1, -1], [0, 2, 4], [3, -1, -1], [0, 1, 2]])),
       A(np.array([[1, 0, -1], [0, 1, 1], [1, -1, -1], [0, 0, 1]]))]),
    C("hsigmoid_loss_custom_per_sample", lambda P, x, y, w, t, c: F(P).hsigmoid_loss(
        x, y, 4, w, path_table=t, path_code=c),
      [N(3, 4), A(np.array([0, 3, 2])), N(5, 4),
       A(np.array([[0, 1, -1], [0, 2, 4], [3, -1, -1]])),
       A(np.array([[1, 0, -1], [0, 1, 1], [1, -1, -1]]))]),
    C("rnnt_loss_mean", lambda P, x, y, il, ll: F(P).rnnt_loss(x, y, il, ll),
      [N(3, 5, 4, 6), _RNNT_LABELS, _RNNT_ILEN, _RNNT_LLEN]),
    C("rnnt_loss_sum_blank", lambda P, x, y, il, ll: F(P).rnnt_loss(x, y, il, ll, blank=5,
                                                                   reduction="sum"),
      [N(3, 5, 4, 6), _RNNT_LABELS, _RNNT_ILEN, _RNNT_LLEN]),
    C("rnnt_loss_none", lambda P, x, y, il, ll: F(P).rnnt_loss(x, y, il, ll, reduction="none"),
      [N(3, 5, 4, 6), _RNNT_LABELS, _RNNT_ILEN, _RNNT_LLEN]),
    C("fractional_max_pool2d", lambda P, x: F(P).fractional_max_pool2d(x, [3, 4], random_u=0.3),
      [N(2, 3, 7, 9)]),
    C("fractional_max_pool2d_mask", lambda P, x: F(P).fractional_max_pool2d(
        x, 3, random_u=0.7, return_mask=True), [N(2, 3, 8, 8)]),
    C("fractional_max_pool3d_mask", lambda P, x: F(P).fractional_max_pool3d(
        x, [2, 3, 2], random_u=0.45, return_mask=True), [N(1, 2, 5, 7, 4)]),
    C("feature_alpha_dropout_eval", lambda P, x: F(P).feature_alpha_dropout(x, 0.5, False),
      [N(2, 3, 4)]),
    C("bilinear", lambda P, a, b, w, c: F(P).bilinear(a, b, w, c),
      [N(4, 3), N(4, 5), N(2, 3, 5), N(1, 2)]),
    C("sparse_attention", lambda P, q, k, v: F(P).sparse_attention(q, k, v, A(_OFFS)[1],
                                                                   A(_COLS)[1]),
      [N(1, 2, 6, 4), N(1, 2, 6, 4), N(1, 2, 6, 4)]),
    C("adaptive_log_softmax_with_loss", lambda P, x, y, h, p0, o0, p1, o1:
      F(P).adaptive_log_softmax_with_loss(x, y, h, [(p0, o0), (p1, o1)], [4, 7]),
      [N(6, 8), A(np.array([0, 3, 5, 9, 7, 1])), N(8, 6), N(8, 2), N(2, 3), N(8, 1),
       N(1, 3)]),
]


@pytest.mark.parametrize("fn,inputs,grad,rtol,atol,same_dtype,grad_atol", FUNCTIONAL)
def test_functional_matches_jax(fn, inputs, grad, rtol, atol, same_dtype, grad_atol):
    check_functional(fn, inputs, grad, rtol, atol, same_dtype, grad_atol)


@pytest.mark.parametrize("name,args", [("elu_", (0.7,)), ("tanh_", ()), ("leaky_relu_", (0.2,)),
                                       ("hardtanh_", (-0.5, 0.5)),
                                       ("thresholded_relu_", (0.3, 0.1))])
def test_inplace_activations_write_x(name, args):
    arr = np.random.RandomState(3).randn(3, 4).astype(np.float32)
    got = []
    for P in (paddle, T):
        x = P.to_tensor(arr, place="cpu")
        assert getattr(F(P), name)(x, *args) is x
        got.append(_np(x))
    np.testing.assert_allclose(got[1], got[0], rtol=RTOL, atol=ATOL)


def test_rnnt_loss_is_float64_as_in_jax():
    rng = np.random.RandomState(0)
    args = [rng.randn(2, 3, 3, 4).astype(np.float32), np.array([[1, 2], [3, 1]]),
            np.array([3, 2]), np.array([2, 1])]
    outs = [P.nn.functional.rnnt_loss(*[_t(P, a) for a in args], reduction="none")
            for P in (paddle, T)]
    assert outs[1].dtype == torch.float64 and np.dtype(outs[0].dtype) == np.float64


LAYERS = [
    L("LogSigmoid", lambda P: P.nn.LogSigmoid(), [N(3, 4)]),
    L("RReLU_eval", lambda P: P.nn.RReLU(0.1, 0.2), [N(3, 4)], train=False),
    L("LPPool1D", lambda P: P.nn.LPPool1D(2, 3, 2), [U((2, 3, 9), 0.5, 2)]),
    L("LPPool2D", lambda P: P.nn.LPPool2D(3, 2), [U((2, 3, 6, 4), 0.5, 2)]),
    L("MaxUnPool1D", lambda P: P.nn.MaxUnPool1D(2),
      [N(2, 3, 4), A(2 * np.arange(4)[None, None].repeat(3, 1).repeat(2, 0))]),
    L("MaxUnPool2D", lambda P: P.nn.MaxUnPool2D(2, output_size=[5, 5]),
      [N(1, 2, 2, 2), A(np.array([[[[0, 3], [11, 18]], [[6, 4], [15, 24]]]]))]),
    L("MaxUnPool3D", lambda P: P.nn.MaxUnPool3D(2),
      [N(1, 1, 1, 2, 2), A(np.array([[[[[1, 2], [13, 15]]]]]))]),
    L("MultiMarginLoss", lambda P: P.nn.MultiMarginLoss(p=2, margin=0.7),
      [N(5, 4), A(np.array([0, 3, 1, 2, 3]))]),
    L("TripletMarginWithDistanceLoss", lambda P: P.nn.TripletMarginWithDistanceLoss(
        margin=0.5, swap=True), [N(5, 4), N(5, 4), N(5, 4)]),
    L("FeatureAlphaDropout_eval", lambda P: P.nn.FeatureAlphaDropout(0.5), [N(2, 3, 4)],
      train=False),
    L("ZeroPad1D", lambda P: P.nn.ZeroPad1D([1, 2]), [N(2, 3, 5)]),
    L("ZeroPad1D_int", lambda P: P.nn.ZeroPad1D(2), [N(2, 3, 5)]),
    L("ZeroPad3D", lambda P: P.nn.ZeroPad3D(1), [N(1, 2, 3, 3, 3)]),
    L("HSigmoidLoss", lambda P: P.nn.HSigmoidLoss(4, 6), [N(5, 4), A(np.array([0, 5, 2, 3, 1]))]),
    L("AdaptiveLogSoftmaxWithLoss", lambda P: P.nn.AdaptiveLogSoftmaxWithLoss(
        8, 12, [4, 9], div_value=2.0, head_bias=True),
      [N(6, 8), A(np.array([0, 3, 5, 11, 9, 1]))]),
    L("FractionalMaxPool2D", lambda P: P.nn.FractionalMaxPool2D(3, random_u=0.5),
      [N(2, 3, 7, 7)]),
    L("FractionalMaxPool3D", lambda P: P.nn.FractionalMaxPool3D(2, random_u=0.2,
                                                                return_mask=True),
      [N(1, 2, 5, 5, 5)]),
    L("RNNTLoss", lambda P: P.nn.RNNTLoss(reduction="sum"),
      [N(3, 5, 4, 6), A(np.array([[1, 2, 3], [4, 1, 0], [2, 0, 0]])), A(np.array([5, 4, 2])),
       A(np.array([3, 2, 1]))]),
]


@pytest.mark.parametrize("make,inputs,steps,train", LAYERS)
def test_layer_matches_jax(make, inputs, steps, train):
    check_layer(make, inputs, steps, train)


def test_adaptive_log_softmax_predict_and_log_prob_equal_jax():
    x = np.random.RandomState(2).randn(5, 8).astype(np.float32)
    got = []
    paddle.seed(3)
    jl = paddle.nn.AdaptiveLogSoftmaxWithLoss(8, 12, [4, 9])
    tl = T.nn.AdaptiveLogSoftmaxWithLoss(8, 12, [4, 9])
    tl.set_state_dict({k: _np(v) for k, v in jl.state_dict().items()})
    for P, layer in ((paddle, jl), (T, tl)):
        got.append((_np(layer.log_prob(_t(P, x))), _np(layer.predict(_t(P, x)))))
    np.testing.assert_allclose(got[1][0], got[0][0], rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got[1][1], got[0][1])


@pytest.mark.parametrize("op,category", [
    ("log_sigmoid", None), ("rrelu_eval", None), ("rrelu_train", None),
    ("pairwise_distance", None), ("grid_sample", None), ("affine_grid", None),
    ("hsigmoid_loss", None), ("rnnt_loss", None), ("max_unpool2d_inner", None),
    ("gather_tree", None), ("bilinear", None), ("margin_cross_entropy", None)])
def test_ops_carry_the_jax_name_and_amp_category(op, category):
    from paddle_tpu.ops import _apply as jap
    from paddle_tpu_torch.ops import _apply as tap

    assert tap.get_registry()[op].amp_category == category
    assert jap.get_registry()[op].amp_category == category


# -- randomness ----------------------------------------------------------------
def test_rrelu_training_slopes_lie_in_the_bounds_and_repeat_under_seed():
    x = -torch.rand(64, 64) - 0.1
    outs = []
    for seed in (5, 5, 6):
        T.seed(seed)
        outs.append(T.nn.functional.rrelu(x, 0.1, 0.3, training=True))
    slopes = outs[0] / x
    assert float(slopes.min()) >= 0.1 - 1e-6 and float(slopes.max()) <= 0.3 + 1e-6
    assert float(slopes.std()) > 0.03   # one slope an element, not one for all
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])
    pos = torch.rand(8, 8)
    assert torch.equal(T.nn.functional.rrelu(pos, training=True), pos)
    layer = T.nn.RReLU(0.1, 0.3)
    assert not torch.equal(layer(x), x * 0.2)
    layer.eval()
    assert torch.allclose(layer(x), x * 0.2)


def test_fractional_max_pool_without_random_u_covers_and_repeats():
    x = torch.arange(2 * 3 * 11 * 9, dtype=torch.float32).reshape(2, 3, 11, 9)
    runs = []
    for seed in (7, 7):
        T.seed(seed)
        runs.append(T.nn.functional.fractional_max_pool2d(x, [4, 5], return_mask=True))
    (out, mask), (out2, mask2) = runs
    assert torch.equal(out, out2) and torch.equal(mask, mask2)
    # a monotone input: each window's max is its last element, and the last
    # window reaches the input's end
    assert out.shape == (2, 3, 4, 5) and float(out[..., -1, -1].min()) == float(
        x[..., -1, -1].min())
    assert torch.equal(torch.gather(x.flatten(2), 2, mask.flatten(2)), out.flatten(2))
    T.seed(7)
    out3 = T.nn.functional.fractional_max_pool3d(torch.randn(1, 2, 6, 6, 6), 3)
    assert out3.shape == (1, 2, 3, 3, 3)


def test_class_center_sample_keeps_every_positive():
    label = np.array([3, 7, 3, 19, 0])
    for P in (paddle, T):
        remapped, sampled = P.nn.functional.class_center_sample(_t(P, label), 20, 8)
        remapped, sampled = _np(remapped), _np(sampled)
        assert len(sampled) == 8 and len(set(sampled.tolist())) == 8
        assert set(label.tolist()) <= set(sampled.tolist())
        np.testing.assert_array_equal(sampled[remapped], label)
    draws = []
    for seed in (1, 1, 2):
        T.seed(seed)
        draws.append(_np(T.nn.functional.class_center_sample(_t(T, label), 20, 8)[1]))
    np.testing.assert_array_equal(draws[0], draws[1])
    assert not np.array_equal(draws[0], draws[2])
    # as many positives as samples: nothing random, equal to JAX
    full = [tuple(_np(t) for t in P.nn.functional.class_center_sample(_t(P, label), 20, 4))
            for P in (paddle, T)]
    for a, b in zip(*full):
        np.testing.assert_array_equal(b, a)


def test_feature_alpha_dropout_drops_whole_channels():
    x = torch.randn(50, 400, 3, 3)
    T.seed(9)
    out = T.nn.functional.feature_alpha_dropout(x, 0.3)
    T.seed(9)
    again = T.nn.functional.feature_alpha_dropout(x, 0.3)
    assert torch.equal(out, again)
    flat = out.flatten(2)
    dropped = (flat == flat[..., :1]).all(-1)   # a dropped map is one constant
    kept = 1 - float(dropped.float().mean())
    assert abs(kept - 0.7) <= 4 * np.sqrt(0.7 * 0.3 / 20000)
    assert torch.equal(T.nn.functional.feature_alpha_dropout(x, 1.0), torch.zeros_like(x))


def test_feature_alpha_dropout_layer_in_training_raises_as_the_jax_layer_is_wrong():
    x = np.ones((2, 3, 4), np.float32)
    paddle.seed(0)
    wrong = paddle.nn.FeatureAlphaDropout(0.5)(paddle.to_tensor(x))
    assert np.iscomplexobj(_np(wrong)) or not np.isfinite(_np(wrong)).all()
    layer = T.nn.FeatureAlphaDropout(0.5)
    with pytest.raises(NotImplementedError, match="Queue C"):
        layer(torch.from_numpy(x))
    assert torch.equal(T.nn.FeatureAlphaDropout(0.0)(torch.from_numpy(x)), torch.from_numpy(x))
    layer.eval()
    assert torch.equal(layer(torch.from_numpy(x)), torch.from_numpy(x))
