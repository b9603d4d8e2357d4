"""The port's common functionals and layers (paddle_tpu_torch/nn/functional/
common.py, nn/layer/common.py) against the JAX package's.

Each functional case is written once and called with each package as ``P``
on the same numpy inputs (from a seed per case): the outputs and their
dtypes, and the gradients of ``sum(out * ct)`` for the same random ``ct``
with respect to every floating input. Each layer case builds the layer in
both packages, carries the JAX ``state_dict`` into the port's, and compares
the outputs, the input gradients and every parameter's gradient by key.
float32 rtol 1e-5 / atol 1e-6, as tests/test_torch_nn_functional.py.

``interpolate`` runs every mode at up- and down-scales, integer and
non-integer ``scale_factor``, ``align_corners`` both ways, in 3-, 4- and
5-D and channel-last: the JAX package's nearest is half-pixel and its
linear modes antialias when they downsample, where torch's plain modes miss
by 0.3-4.3 (``test_torch_plain_modes_miss_where_the_port_matches``).

The dropout family draws from the port's generator, not JAX's stream, so it
is held to what does not depend on the draw: eval and ``p = 0`` are the
identity (``downscale_in_infer`` scales by ``1 - p``) exactly as in JAX,
``p = 1`` gives zeros, the kept share lies within 4 sigma of ``1 - p`` over
2e5 elements, kept values are exactly ``x / (1 - p)``, ``axis`` masks
broadcast over the dims it does not list, alpha dropout keeps the mean and
variance of a standard normal within 0.02 and 0.03, and a seeded draw
repeats.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as T
from test_torch_nn_layers import _call, carry
from test_torch_ops import A, I, N, U, _case_seed, _dtype, _is_float, _make, _np, _run  # noqa: F401
from test_torch_ops import _on_cpu  # noqa: F401

RTOL, ATOL = 1e-5, 1e-6


def C(name, fn, inputs=(), grad=True, rtol=RTOL, atol=ATOL, same_dtype=True, grad_atol=None):
    """A functional case; ``grad_atol`` (default ``atol``) bounds the
    gradients of the long reductions (a convolution's weight gradient sums
    over the batch and the image)."""
    return pytest.param(fn, inputs, grad, rtol, atol, same_dtype, grad_atol, id=name)


def L(name, make, inputs, steps=1, train=True):
    return pytest.param(make, inputs, steps, train, id=name)


def F(P):
    return P.nn.functional


def check_functional(fn, inputs, grad=True, rtol=RTOL, atol=ATOL, same_dtype=True,
                     grad_atol=None):
    """``fn(P, *tensors)`` in both packages: outputs, dtypes and gradients."""
    seed = _case_seed(fn)
    rng = np.random.RandomState(seed)
    arrays = [_make(s, rng) for s in inputs]
    rng = np.random.RandomState(seed + 1)
    cts = [rng.standard_normal(1 << 15).astype(np.float32) for _ in range(8)]
    jout, _ = _run(paddle, fn, arrays, False, False, None)
    tout, _ = _run(T, fn, arrays, False, False, None)
    assert len(jout) == len(tout)
    for j, t in zip(jout, tout):
        assert _dtype(t) == _dtype(j) or not same_dtype
        assert _np(t).shape == _np(j).shape
        np.testing.assert_allclose(_np(t), _np(j), rtol=rtol, atol=atol)
    if not grad:
        return
    shaped = [c[:_np(o).size] for c, o in zip(cts, [o for o in jout if _is_float(o)])]
    _, jgrads = _run(paddle, fn, arrays, True, False, shaped)
    _, tgrads = _run(T, fn, arrays, True, False, shaped)
    assert len(jgrads) == len(tgrads)
    for jg, tg in zip(jgrads, tgrads):
        if jg is None or tg is None:
            # an input the output does not depend on: no gradient in one
            # package, zeros in the other
            assert not np.any(tg if jg is None else jg)
            continue
        np.testing.assert_allclose(tg, jg, rtol=rtol, atol=grad_atol or atol)


def check_layer(make, inputs, steps=1, train=True, rtol=RTOL, atol=ATOL, grad_atol=None):
    """``make(P)`` in both packages with the JAX state carried over:
    outputs, input gradients, parameter gradients by key (``grad_atol``,
    default ``atol``) and the state."""
    rng = np.random.RandomState(7)
    arrays = [_make(s, rng) for s in inputs]
    cts = [rng.standard_normal(1 << 15).astype(np.float32) for _ in range(4)]
    paddle.seed(1)
    jl = make(paddle)
    tl = make(T)
    carry(jl, tl)
    if not train:
        jl.eval()
        tl.eval()
    (jo, jg, jpg, jsd), (to, tg, tpg, tsd) = [_call(P, layer, arrays, cts, steps)
                                              for P, layer in ((paddle, jl), (T, tl))]
    assert len(to) == len(jo)
    for a, b in zip(to, jo):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)
    gatol = grad_atol or atol
    for a, b in zip(tg, jg):
        if a is None or b is None:
            assert not np.any(b if a is None else a)
            continue
        np.testing.assert_allclose(a, b, rtol=rtol, atol=gatol)
    assert set(tpg) == set(jpg)
    for k in jpg:
        if jpg[k] is None or tpg[k] is None:
            assert not np.any(jpg[k] if tpg[k] is None else tpg[k]), k
            continue
        np.testing.assert_allclose(tpg[k], jpg[k], rtol=rtol, atol=gatol, err_msg=k)
    assert list(tsd) == list(jsd)
    for k in jsd:
        np.testing.assert_allclose(tsd[k], jsd[k], rtol=rtol, atol=atol, err_msg=k)


def _interp(**kw):
    return lambda P, x: F(P).interpolate(x, **kw)


INTERP = [
    # nearest: half-pixel, align_corners ignored
    C("nearest_8_to_4", _interp(size=[4, 4]), [N(2, 3, 8, 8)]),
    C("nearest_8_to_5", _interp(size=[5, 5]), [N(2, 3, 8, 8)]),
    C("nearest_8_to_11", _interp(size=[11, 11]), [N(2, 3, 8, 8)]),
    C("nearest_scale_2", _interp(scale_factor=2), [N(1, 2, 5, 6)]),
    C("nearest_scale_1_5", _interp(scale_factor=1.5), [N(1, 2, 5, 6)]),
    C("nearest_align_corners", _interp(size=[7, 3], align_corners=True), [N(1, 2, 5, 6)]),
    C("nearest_1d", _interp(size=[9]), [N(2, 3, 7)]),
    C("nearest_3d", _interp(size=[3, 7, 4]), [N(1, 2, 5, 5, 6)]),
    C("nearest_nhwc", _interp(size=[5, 11], data_format="NHWC"), [N(2, 8, 8, 3)]),
    # linear: jax.image.resize's triangle filter (antialiased downsampling)
    C("bilinear_8_to_4", _interp(size=[4, 4], mode="bilinear"), [N(2, 3, 8, 8)]),
    C("bilinear_8_to_5", _interp(size=[5, 5], mode="bilinear"), [N(2, 3, 8, 8)]),
    C("bilinear_8_to_11", _interp(size=[11, 11], mode="bilinear"), [N(2, 3, 8, 8)]),
    C("bilinear_8_to_3x13", _interp(size=[3, 13], mode="bilinear"), [N(1, 2, 8, 8)]),
    C("bilinear_scale_2", _interp(scale_factor=2, mode="bilinear"), [N(1, 2, 5, 6)]),
    C("bilinear_scale_0_5", _interp(scale_factor=0.5, mode="bilinear"), [N(1, 2, 8, 10)]),
    C("bilinear_scale_1_5", _interp(scale_factor=1.5, mode="bilinear"), [N(1, 2, 5, 6)]),
    C("bilinear_scale_0_6", _interp(scale_factor=[0.6, 1.3], mode="bilinear"),
      [N(1, 2, 10, 7)]),
    C("bilinear_align_up", _interp(size=[11, 9], mode="bilinear", align_corners=True),
      [N(2, 3, 8, 8)]),
    C("bilinear_align_down", _interp(size=[4, 5], mode="bilinear", align_corners=True),
      [N(2, 3, 8, 8)]),
    C("bilinear_nhwc", _interp(size=[5, 11], mode="bilinear", data_format="NHWC"),
      [N(2, 8, 8, 3)]),
    C("linear_1d_down", _interp(size=[5], mode="linear"), [N(2, 3, 16)]),
    C("linear_1d_up", _interp(size=[40], mode="linear"), [N(2, 3, 16)]),
    C("linear_1d_align", _interp(size=[7], mode="linear", align_corners=True), [N(2, 3, 16)]),
    C("linear_1d_nwc", _interp(size=[6], mode="linear", data_format="NWC"), [N(2, 16, 3)]),
    C("trilinear_down", _interp(size=[3, 4, 2], mode="trilinear"), [N(1, 2, 6, 6, 6)]),
    C("trilinear_mixed", _interp(size=[3, 9, 6], mode="trilinear"), [N(1, 2, 6, 6, 6)]),
    C("trilinear_align", _interp(size=[4, 9, 5], mode="trilinear", align_corners=True),
      [N(1, 2, 6, 6, 6)]),
    C("trilinear_scale_1_5", _interp(scale_factor=1.5, mode="trilinear"), [N(1, 2, 4, 4, 4)]),
    # bicubic: Keys a = -0.75, clamped taps
    C("bicubic_down", _interp(size=[4, 5], mode="bicubic"), [N(2, 3, 8, 8)]),
    C("bicubic_up", _interp(size=[11, 13], mode="bicubic"), [N(2, 3, 8, 8)]),
    C("bicubic_align", _interp(size=[11, 5], mode="bicubic", align_corners=True),
      [N(2, 3, 8, 8)]),
    C("bicubic_scale_1_5", _interp(scale_factor=1.5, mode="bicubic"), [N(1, 2, 5, 6)]),
    C("bicubic_nhwc", _interp(size=[5, 11], mode="bicubic", data_format="NHWC"),
      [N(2, 8, 8, 3)]),
    # area: adaptive average pooling
    C("area_divides", _interp(size=[4, 2], mode="area"), [N(2, 3, 8, 8)]),
    C("area_ragged", _interp(size=[3, 5], mode="area"), [N(2, 3, 8, 8)]),
    C("area_scale", _interp(scale_factor=1.5, mode="area"), [N(1, 2, 5, 5)]),
    C("area_3d", _interp(size=[2, 3, 4], mode="area"), [N(1, 2, 6, 6, 7)]),
    C("upsample", lambda P, x: F(P).upsample(x, scale_factor=2, mode="bilinear"),
      [N(1, 2, 4, 5)]),
]

COMMON = [
    C("one_hot", lambda P, x: F(P).one_hot(x, 6), [I((3, 4), 0, 6)], grad=False),
    # an index outside [0, 6) gives a zero row, as jax.nn.one_hot's
    C("one_hot_out_of_range", lambda P, x: F(P).one_hot(x, 6), [I((3, 4), -2, 9)], grad=False),
    C("cosine_similarity", lambda P, a, b: F(P).cosine_similarity(a, b), [N(4, 5), N(4, 5)]),
    C("cosine_similarity_axis", lambda P, a, b: F(P).cosine_similarity(a, b, axis=-1, eps=1e-3),
      [N(2, 3, 5), N(2, 3, 5)]),
    C("normalize", lambda P, x: F(P).normalize(x), [N(3, 4, 2)]),
    C("normalize_p1", lambda P, x: F(P).normalize(x, p=1, axis=-1), [N(3, 4)]),
    C("normalize_p3", lambda P, x: F(P).normalize(x, p=3, axis=0), [N(3, 4)]),
    C("pixel_shuffle", lambda P, x: F(P).pixel_shuffle(x, 2), [N(2, 8, 3, 4)]),
    C("pixel_shuffle_nhwc", lambda P, x: F(P).pixel_shuffle(x, 2, "NHWC"), [N(2, 3, 4, 8)]),
    C("pixel_unshuffle", lambda P, x: F(P).pixel_unshuffle(x, 2), [N(2, 3, 4, 6)]),
    C("pixel_unshuffle_nhwc", lambda P, x: F(P).pixel_unshuffle(x, 2, "NHWC"),
      [N(2, 4, 6, 3)]),
    C("channel_shuffle", lambda P, x: F(P).channel_shuffle(x, 3), [N(2, 6, 3, 2)]),
    C("channel_shuffle_nhwc", lambda P, x: F(P).channel_shuffle(x, 2, "NHWC"),
      [N(2, 3, 2, 6)]),
    C("unfold", lambda P, x: F(P).unfold(x, 3), [N(2, 3, 6, 7)]),
    C("unfold_args", lambda P, x: F(P).unfold(x, [2, 3], strides=[2, 1], paddings=1,
                                               dilations=[1, 2]), [N(2, 3, 6, 7)]),
    C("unfold_4_paddings", lambda P, x: F(P).unfold(x, 2, paddings=[1, 2, 1, 2]),
      [N(1, 2, 5, 5)]),
    C("fold", lambda P, x: F(P).fold(x, [5, 6], 3), [N(2, 2 * 9, 12)]),
    C("fold_args", lambda P, x: F(P).fold(x, [6, 7], [2, 3], strides=2, paddings=1,
                                           dilations=[2, 1]), [N(1, 3 * 6, 12)]),
    C("label_smooth", lambda P, x: F(P).label_smooth(x), [U((3, 5), 0, 1)]),
    C("label_smooth_prior", lambda P, x, p: F(P).label_smooth(x, p, epsilon=0.2),
      [U((3, 5), 0, 1), U((1, 5), 0, 1)]),
    C("sequence_mask", lambda P, x: F(P).sequence_mask(x), [A(np.array([1, 4, 2]))],
      grad=False),
    C("sequence_mask_maxlen", lambda P, x: F(P).sequence_mask(x, 6, "float32"),
      [A(np.array([[1, 4], [0, 5]]))], grad=False),
    C("pad_constant", lambda P, x: F(P).pad(x, [1, 2, 0, 1], value=0.5), [N(2, 3, 4, 5)]),
    C("pad_reflect", lambda P, x: F(P).pad(x, [1, 2], mode="reflect"), [N(2, 3, 5)]),
    C("pad_replicate_nhwc", lambda P, x: F(P).pad(x, [1, 0, 2, 1], mode="replicate",
                                                  data_format="NHWC"), [N(2, 4, 5, 3)]),
    C("pad_circular_3d", lambda P, x: F(P).pad(x, [1, 1, 0, 2, 1, 0], mode="circular",
                                               data_format="NCDHW"), [N(1, 2, 3, 4, 5)]),
    C("dropout_eval", lambda P, x: F(P).dropout(x, 0.3, training=False), [N(3, 4)]),
    C("dropout_downscale_eval", lambda P, x: F(P).dropout(x, 0.3, training=False,
                                                          mode="downscale_in_infer"),
      [N(3, 4)]),
    C("dropout_p0", lambda P, x: F(P).dropout(x, 0.0), [N(3, 4)]),
    C("dropout_p1", lambda P, x: F(P).dropout(x, 1.0), [N(3, 4)], grad=False),
    C("dropout2d_eval", lambda P, x: F(P).dropout2d(x, 0.4, training=False), [N(2, 3, 4, 4)]),
    C("dropout3d_eval", lambda P, x: F(P).dropout3d(x, 0.4, training=False),
      [N(1, 2, 3, 3, 3)]),
    C("alpha_dropout_eval", lambda P, x: F(P).alpha_dropout(x, 0.4, training=False), [N(3, 4)]),
    C("alpha_dropout_p0", lambda P, x: F(P).alpha_dropout(x, 0.0), [N(3, 4)]),
    C("linear", lambda P, x, w, b: F(P).linear(x, w, b), [N(2, 3, 4), N(4, 5), N(5)]),
]


@pytest.mark.parametrize("fn,inputs,grad,rtol,atol,same_dtype,grad_atol", INTERP + COMMON)
def test_functional_matches_jax(fn, inputs, grad, rtol, atol, same_dtype, grad_atol):
    check_functional(fn, inputs, grad, rtol, atol, same_dtype, grad_atol)


def test_torch_plain_modes_miss_where_the_port_matches():
    """The 8x8 resizes: torch's ``nearest`` and plain ``bilinear`` differ from
    the JAX package by more than 0.1 at every size but the bilinear 11x11
    (half-pixel upsampling, which torch shares); the port does not."""
    x = np.random.RandomState(0).randn(1, 2, 8, 8).astype(np.float32)
    for size in (4, 5, 11):
        for mode, plain_mode in (("nearest", "nearest"), ("bilinear", "bilinear")):
            want = _np(F(paddle).interpolate(paddle.to_tensor(x), size=[size, size], mode=mode))
            got = _np(F(T).interpolate(T.to_tensor(x, place="cpu"), size=[size, size],
                                       mode=mode))
            plain = torch.nn.functional.interpolate(torch.from_numpy(x), size=(size, size),
                                                    mode=plain_mode).numpy()
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
            if not (mode == "bilinear" and size == 11):
                assert np.abs(plain - want).max() > 0.1, (mode, size)


LAYERS = [
    L("Identity", lambda P: P.nn.Identity(), [N(2, 3)]),
    L("Flatten", lambda P: P.nn.Flatten(), [N(2, 3, 4, 5)]),
    L("Flatten_axes", lambda P: P.nn.Flatten(0, 2), [N(2, 3, 4, 5)]),
    L("Unflatten", lambda P: P.nn.Unflatten(1, [3, 4]), [N(2, 12, 5)]),
    L("Upsample", lambda P: P.nn.Upsample(size=[5, 7], mode="bilinear"), [N(2, 3, 8, 8)]),
    L("Upsample_nearest", lambda P: P.nn.Upsample(scale_factor=2), [N(2, 3, 3, 4)]),
    L("UpsamplingBilinear2D", lambda P: P.nn.UpsamplingBilinear2D(size=[7, 9]),
      [N(2, 3, 4, 5)]),
    L("UpsamplingNearest2D", lambda P: P.nn.UpsamplingNearest2D(scale_factor=3),
      [N(2, 3, 4, 5)]),
    L("PixelShuffle", lambda P: P.nn.PixelShuffle(3), [N(2, 18, 2, 3)]),
    L("PixelUnshuffle", lambda P: P.nn.PixelUnshuffle(2, "NHWC"), [N(2, 4, 6, 3)]),
    L("ChannelShuffle", lambda P: P.nn.ChannelShuffle(2), [N(2, 6, 3, 3)]),
    L("Bilinear", lambda P: P.nn.Bilinear(4, 5, 3), [N(6, 4), N(6, 5)]),
    L("Bilinear_no_bias", lambda P: P.nn.Bilinear(4, 5, 3, bias_attr=False), [N(6, 4), N(6, 5)]),
    L("CosineSimilarity", lambda P: P.nn.CosineSimilarity(axis=-1), [N(3, 5), N(3, 5)]),
    L("PairwiseDistance", lambda P: P.nn.PairwiseDistance(), [N(4, 5), N(4, 5)]),
    L("PairwiseDistance_p1", lambda P: P.nn.PairwiseDistance(1.0, keepdim=True),
      [N(4, 5), N(4, 5)]),
    L("Fold", lambda P: P.nn.Fold([4, 5], 2), [N(2, 3 * 4, 12)]),
    L("Unfold", lambda P: P.nn.Unfold(2, strides=2), [N(2, 3, 4, 6)]),
    L("Pad1D", lambda P: P.nn.Pad1D([1, 2], mode="reflect"), [N(2, 3, 5)]),
    L("Pad2D", lambda P: P.nn.Pad2D([1, 0, 2, 1], value=1.5), [N(2, 3, 4, 5)]),
    L("Pad3D", lambda P: P.nn.Pad3D(1, mode="replicate"), [N(1, 2, 3, 3, 3)]),
    L("ZeroPad2D", lambda P: P.nn.ZeroPad2D([1, 2, 0, 1]), [N(2, 3, 4, 5)]),
    L("Embedding_", lambda P: P.nn.layer.common.Embedding_(10, 4, padding_idx=0),
      [A(np.array([[1, 0, 3], [9, 2, 0]]))]),
    L("Dropout_eval", lambda P: P.nn.Dropout(0.5), [N(3, 4)], train=False),
    L("Dropout_downscale_eval", lambda P: P.nn.Dropout(0.5, mode="downscale_in_infer"),
      [N(3, 4)], train=False),
    L("Dropout2D_eval", lambda P: P.nn.Dropout2D(0.5), [N(2, 3, 4, 4)], train=False),
    L("Dropout3D_eval", lambda P: P.nn.Dropout3D(0.5), [N(2, 3, 2, 2, 2)], train=False),
    L("AlphaDropout_eval", lambda P: P.nn.AlphaDropout(0.5), [N(3, 4)], train=False),
    L("Dropout_p0", lambda P: P.nn.Dropout(0.0), [N(3, 4)]),
]


@pytest.mark.parametrize("make,inputs,steps,train", LAYERS)
def test_layer_matches_jax(make, inputs, steps, train):
    check_layer(make, inputs, steps, train)


@pytest.mark.parametrize("op,category", [
    ("dropout_op", None), ("dropout_axis", None), ("alpha_dropout_op", None),
    ("one_hot", None), ("cosine_similarity", "black"), ("normalize_op", None),
    ("interpolate_op", None), ("interp_area", None), ("pixel_shuffle_op", None),
    ("unfold_op", None), ("fold_op", None), ("label_smooth_op", None),
    ("sequence_mask", None)])
def test_ops_carry_the_jax_name_and_amp_category(op, category):
    from paddle_tpu.ops import _apply as jap
    from paddle_tpu_torch.ops import _apply as tap

    assert tap.get_registry()[op].amp_category == category
    assert jap.get_registry()[op].amp_category == category


# -- randomness ----------------------------------------------------------------
P_DROP = 0.3
N_DRAWS = 200_000


def _draw(fn, shape=(N_DRAWS,), seed=3):
    T.seed(seed)
    x = torch.from_numpy(np.random.RandomState(0).uniform(1, 2, shape).astype(np.float32))
    return x, fn(x)


def _within_4_sigma(kept, n, keep):
    return abs(kept / n - keep) <= 4 * np.sqrt(keep * (1 - keep) / n)


@pytest.mark.parametrize("mode", ["upscale_in_train", "downscale_in_infer"])
def test_dropout_keeps_its_share_and_scales_the_kept_exactly(mode):
    x, out = _draw(lambda t: T.nn.functional.dropout(t, P_DROP, mode=mode))
    kept = out != 0
    assert _within_4_sigma(int(kept.sum()), N_DRAWS, 1 - P_DROP)
    want = x / (1 - P_DROP) if mode == "upscale_in_train" else x
    assert torch.equal(out[kept], want[kept])


@pytest.mark.parametrize("fn,shape,shared", [
    (lambda t: T.nn.functional.dropout(t, P_DROP, axis=1), (4, 50_000), (0,)),
    (lambda t: T.nn.functional.dropout(t, P_DROP, axis=[0, 2]), (200, 5, 200), (1,)),
    (lambda t: T.nn.functional.dropout2d(t, P_DROP), (200, 1000, 1, 1), ()),
    (lambda t: T.nn.functional.dropout2d(t, P_DROP, data_format="NHWC"), (200, 3, 2, 1000),
     (1, 2)),
    (lambda t: T.nn.functional.dropout3d(t, P_DROP), (400, 500, 1, 2, 1), (2, 3, 4)),
], ids=["axis_1", "axis_0_2", "dropout2d", "dropout2d_nhwc", "dropout3d"])
def test_dropout_axis_masks_broadcast_as_in_jax(fn, shape, shared):
    """One draw for each index of the listed dims, shared along the others."""
    x, out = _draw(fn, shape)
    kept = out != 0
    for d in shared:
        assert torch.equal(kept, kept.narrow(d, 0, 1).expand_as(kept)), d
    free = kept
    for d in shared:
        free = free.narrow(d, 0, 1)
    assert _within_4_sigma(int(free.sum()), free.numel(), 1 - P_DROP)
    assert torch.equal(out[kept], (x / (1 - P_DROP))[kept])


def test_alpha_dropout_keeps_mean_and_variance():
    T.seed(4)
    x = torch.from_numpy(np.random.RandomState(1).standard_normal(N_DRAWS).astype(np.float32))
    out = T.nn.functional.alpha_dropout(x, 0.2)
    assert abs(float(out.mean())) < 0.02 and abs(float(out.var()) - 1.0) < 0.03
    dropped = int(torch.unique(out, return_counts=True)[1].max())  # all at one value
    assert _within_4_sigma(N_DRAWS - dropped, N_DRAWS, 0.8)


@pytest.mark.parametrize("fn", [
    lambda t: T.nn.functional.dropout(t, 0.5),
    lambda t: T.nn.functional.dropout(t, 0.5, axis=0),
    lambda t: T.nn.functional.alpha_dropout(t, 0.5),
    lambda t: T.nn.Dropout2D(0.5)(t),
], ids=["dropout", "dropout_axis", "alpha_dropout", "Dropout2D"])
def test_dropout_draws_repeat_under_seed(fn):
    _, a = _draw(fn, (8, 16, 4, 4))
    _, b = _draw(fn, (8, 16, 4, 4))
    _, c = _draw(fn, (8, 16, 4, 4), seed=4)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_dropout_layers_follow_train_and_eval():
    x = torch.ones(64, 64)
    for layer in (T.nn.Dropout(0.5), T.nn.Dropout2D(0.5), T.nn.AlphaDropout(0.5)):
        inp = x if not isinstance(layer, T.nn.Dropout2D) else x[None, :, :, None]
        assert not torch.equal(layer(inp), inp)
        layer.eval()
        assert torch.equal(layer(inp), inp)


def test_dropout_p1_gives_zeros_and_gradient_flows():
    x = torch.randn(4, 5, requires_grad=True)
    out = T.nn.functional.dropout(x, 1.0)
    assert torch.equal(out, torch.zeros(4, 5))
    T.seed(0)
    out = T.nn.functional.dropout(x, 0.5)
    out.sum().backward()
    assert torch.equal(x.grad, (out != 0).float() * 2.0)
