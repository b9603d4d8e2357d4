"""The port's conv and pooling functionals and layers
(paddle_tpu_torch/nn/functional/{conv,pooling}.py, nn/layer/{conv,pooling}.py)
against the JAX package's, and a small conv net built of them.

Functionals and layers as in tests/test_torch_nn_common.py (outputs, dtypes,
input gradients, parameter gradients by key; float32 rtol 1e-5 / atol 1e-6):
every padding form of ``_norm_padding`` (XLA's ``SAME`` at stride 2 with an
odd total among them), groups, dilation, the channel-last layouts, the
transposes with ``output_padding`` (also past the stride), ``max_pool`` with
``ceil_mode``, padding and ``return_mask`` on a tied input, ``exclusive``,
and adaptive bins that do not divide the input.

The JAX quirks, each a case: ``avg_pool2d(ceil_mode=True)`` keeps the floor
shape; ``max_pool2d``'s ceil rule keeps a last window torch drops;
``output_size`` and ``padding_mode`` are ignored; ``conv3d_transpose`` with
``groups=2`` raises in the port, where JAX returns 3 channels for 6.

The net (``Conv2D`` -> ``BatchNorm2D`` -> ``ReLU`` -> ``MaxPool2D`` -> a
bottleneck block -> ``AdaptiveAvgPool2D`` -> ``Flatten`` -> ``Linear``) at
2x3x32x32: the loss, every gradient, and three ``Momentum`` steps with the
running statistics after them, equal in both packages (parameters at
1e-5 / 1e-5, as tests/test_torch_nn_core.py's AdamW steps); ``to_static``
against eager and a ``jit.save``/``load`` round trip in eval.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as T
from test_torch_nn_common import C, F, L, check_functional, check_layer
from test_torch_nn_layers import _sd, carry
from test_torch_ops import A, N, _np, _on_cpu  # noqa: F401

RTOL, ATOL = 1e-5, 1e-6
# gradients of a convolution sum over the batch and the image: 1e-5 absolute
# (tests/test_ops_numeric_tail.py holds conv gradients to 2e-2 / 2e-3)
CONV_GRAD_ATOL = 1e-5


def CV(name, fn, inputs):
    return C(name, fn, inputs, grad_atol=CONV_GRAD_ATOL)


def _conv(name, **kw):
    return lambda P, x, w: getattr(F(P), name)(x, w, **kw)


def _convb(name, **kw):
    return lambda P, x, w, b: getattr(F(P), name)(x, w, b, **kw)


CONV = [
    CV("conv2d", _convb("conv2d"), [N(2, 3, 7, 7), N(4, 3, 3, 3), N(4)]),
    CV("conv2d_pad_int", _conv("conv2d", padding=1, stride=2), [N(2, 3, 7, 7), N(4, 3, 3, 3)]),
    CV("conv2d_pad_per_dim", _conv("conv2d", padding=[1, 2]), [N(2, 3, 6, 7), N(4, 3, 3, 3)]),
    CV("conv2d_pad_pairs_flat", _conv("conv2d", padding=[1, 0, 2, 1]),
      [N(2, 3, 6, 7), N(4, 3, 3, 3)]),
    CV("conv2d_pad_pairs", _conv("conv2d", padding=[[2, 1], [0, 1]]),
      [N(2, 3, 6, 7), N(4, 3, 3, 3)]),
    CV("conv1d_pad_pairs_full", _conv("conv1d", padding=[[0, 0], [0, 0], [2, 1]]),
      [N(2, 3, 7), N(4, 3, 3)]),
    CV("conv2d_same_stride2_odd", _conv("conv2d", padding="SAME", stride=2),
      [N(2, 3, 8, 7), N(4, 3, 4, 4)]),
    CV("conv2d_same", _conv("conv2d", padding="same"), [N(2, 3, 6, 7), N(4, 3, 3, 2)]),
    CV("conv2d_valid", _conv("conv2d", padding="VALID", stride=[2, 1]),
      [N(2, 3, 7, 7), N(4, 3, 3, 3)]),
    CV("conv2d_groups_dilation", _convb("conv2d", groups=2, dilation=2, padding=2),
      [N(2, 4, 8, 8), N(6, 2, 3, 3), N(6)]),
    CV("conv2d_depthwise", _conv("conv2d", groups=4, padding=1), [N(2, 4, 6, 6), N(8, 1, 3, 3)]),
    CV("conv2d_nhwc", _convb("conv2d", data_format="NHWC", padding="SAME", stride=2),
      [N(2, 7, 7, 3), N(4, 3, 3, 3), N(4)]),
    CV("conv1d", _convb("conv1d", padding=1, stride=2), [N(2, 3, 9), N(4, 3, 3), N(4)]),
    CV("conv1d_nlc_same", _conv("conv1d", data_format="NLC", padding="SAME", dilation=2),
      [N(2, 9, 3), N(4, 3, 3)]),
    CV("conv3d", _convb("conv3d", padding=1), [N(1, 2, 5, 5, 5), N(3, 2, 3, 3, 3), N(3)]),
    CV("conv3d_ndhwc_stride", _conv("conv3d", data_format="NDHWC", stride=2, padding="SAME"),
      [N(1, 5, 6, 5, 2), N(3, 2, 2, 3, 2)]),
    CV("conv2d_transpose", _convb("conv2d_transpose", stride=2, padding=1, output_padding=1),
      [N(2, 3, 4, 4), N(3, 2, 3, 3), N(2)]),
    CV("conv2d_transpose_plain", _conv("conv2d_transpose"), [N(2, 3, 4, 5), N(3, 4, 3, 3)]),
    CV("conv2d_transpose_same", _conv("conv2d_transpose", padding="SAME", dilation=[1, 2],
                                      output_padding=1), [N(2, 3, 4, 5), N(3, 4, 4, 3)]),
    CV("conv1d_transpose_valid", _conv("conv1d_transpose", padding="VALID"),
       [N(2, 3, 5), N(3, 4, 3)]),
    CV("conv2d_transpose_groups", _conv("conv2d_transpose", groups=2, stride=2, dilation=2),
      [N(2, 4, 3, 3), N(4, 3, 3, 3)]),
    CV("conv2d_transpose_asym", _conv("conv2d_transpose", stride=2, padding=[1, 0, 2, 1]),
      [N(1, 3, 4, 4), N(3, 2, 3, 3)]),
    CV("conv2d_transpose_opad_past_stride", _conv("conv2d_transpose", stride=2,
                                                 output_padding=[2, 1], padding=1),
      [N(1, 3, 4, 4), N(3, 2, 3, 3)]),
    CV("conv2d_transpose_nhwc", _convb("conv2d_transpose", stride=2, padding=1,
                                      output_padding=1, data_format="NHWC"),
      [N(2, 4, 4, 3), N(3, 2, 3, 3), N(2)]),
    CV("conv2d_transpose_output_size_ignored",
      _conv("conv2d_transpose", stride=2, output_size=[99, 99]), [N(1, 3, 4, 4), N(3, 2, 3, 3)]),
    CV("conv1d_transpose", _convb("conv1d_transpose", stride=3, padding=1, output_padding=2),
      [N(2, 3, 5), N(3, 4, 4), N(4)]),
    CV("conv1d_transpose_nlc_groups", _conv("conv1d_transpose", groups=3, data_format="NLC"),
      [N(2, 5, 6), N(6, 2, 3)]),
    CV("conv3d_transpose", _convb("conv3d_transpose", stride=2, padding=1, output_padding=1),
      [N(1, 2, 3, 3, 3), N(2, 3, 3, 3, 3), N(3)]),
    CV("conv3d_transpose_ndhwc", _conv("conv3d_transpose", dilation=2, data_format="NDHWC"),
      [N(1, 3, 3, 3, 2), N(2, 3, 2, 2, 2)]),
]


def _pool(name, *a, **kw):
    return lambda P, x: getattr(F(P), name)(x, *a, **kw)


# a 1x2x4x4 plane of ties in channel 0, random in channel 1
_TIED = A(np.stack([np.ones((4, 4)), np.arange(16).reshape(4, 4) % 3])[None]
          .astype(np.float32))

POOL = [
    C("max_pool2d", _pool("max_pool2d", 2), [N(2, 3, 6, 6)]),
    C("max_pool2d_resnet", _pool("max_pool2d", 3, 2, 1), [N(2, 3, 9, 9)]),
    C("max_pool2d_ceil", _pool("max_pool2d", 2, 2, ceil_mode=True), [N(1, 4, 5, 5)]),
    C("max_pool2d_ceil_keeps_torch_dropped", _pool("max_pool2d", 2, 3, 1, ceil_mode=True),
      [N(1, 4, 5, 5)]),
    C("max_pool2d_pad_pairs", _pool("max_pool2d", [3, 2], [2, 1], [[1, 0], [0, 1]]),
      [N(2, 3, 7, 6)]),
    C("max_pool2d_same", _pool("max_pool2d", 3, 2, "SAME"), [N(2, 3, 8, 7)]),
    C("max_pool2d_nhwc", _pool("max_pool2d", 2, 2, 1, data_format="NHWC"), [N(2, 5, 5, 3)]),
    C("max_pool2d_mask", _pool("max_pool2d", 2, 2, return_mask=True), [N(2, 3, 6, 6)]),
    C("max_pool2d_mask_padded", _pool("max_pool2d", 3, 2, 1, return_mask=True),
      [N(2, 3, 7, 7)]),
    C("max_pool2d_mask_tied", _pool("max_pool2d", 2, 1, return_mask=True), [_TIED]),
    C("max_pool2d_mask_tied_padded", _pool("max_pool2d", 3, 2, 1, return_mask=True), [_TIED]),
    C("max_pool2d_mask_nhwc", _pool("max_pool2d", 2, 2, return_mask=True, data_format="NHWC"),
      [N(2, 6, 4, 3)]),
    C("max_pool1d", _pool("max_pool1d", 3, 2, 1), [N(2, 3, 9)]),
    C("max_pool1d_ignores_mask_and_ceil", _pool("max_pool1d", 2, return_mask=True,
                                                ceil_mode=True), [N(2, 3, 9)]),
    C("max_pool3d", _pool("max_pool3d", 2, 2, 1), [N(1, 2, 5, 5, 5)]),
    C("max_pool3d_mask", _pool("max_pool3d", 2, return_mask=True), [N(1, 2, 4, 6, 4)]),
    C("max_pool3d_mask_ndhwc", _pool("max_pool3d", 3, 2, 1, return_mask=True,
                                     data_format="NDHWC"), [N(1, 5, 5, 5, 2)]),
    C("avg_pool2d", _pool("avg_pool2d", 2), [N(2, 3, 6, 6)]),
    C("avg_pool2d_exclusive_pad", _pool("avg_pool2d", 3, 2, 1), [N(2, 3, 7, 7)]),
    C("avg_pool2d_inclusive_pad", _pool("avg_pool2d", 3, 2, 1, exclusive=False),
      [N(2, 3, 7, 7)]),
    C("avg_pool2d_ceil_ignored", _pool("avg_pool2d", 2, 2, ceil_mode=True), [N(1, 4, 5, 5)]),
    C("avg_pool2d_same", _pool("avg_pool2d", 3, 2, "SAME"), [N(2, 3, 8, 7)]),
    C("avg_pool2d_asym_nhwc", _pool("avg_pool2d", 2, 1, [1, 0, 0, 1], data_format="NHWC"),
      [N(2, 4, 5, 3)]),
    C("avg_pool1d", _pool("avg_pool1d", 3, 2, 1), [N(2, 3, 9)]),
    C("avg_pool3d", _pool("avg_pool3d", 2, 2, 1, exclusive=False), [N(1, 2, 5, 5, 5)]),
    C("adaptive_avg_pool2d", _pool("adaptive_avg_pool2d", 3), [N(2, 3, 9, 6)]),
    C("adaptive_avg_pool2d_ragged", _pool("adaptive_avg_pool2d", [3, 4]), [N(2, 3, 7, 10)]),
    C("adaptive_avg_pool2d_nhwc", _pool("adaptive_avg_pool2d", [2, 3], "NHWC"),
      [N(2, 5, 7, 3)]),
    C("adaptive_avg_pool1d", _pool("adaptive_avg_pool1d", 4), [N(2, 3, 11)]),
    C("adaptive_avg_pool3d", _pool("adaptive_avg_pool3d", [2, 3, 2]), [N(1, 2, 5, 7, 4)]),
    C("adaptive_max_pool2d", _pool("adaptive_max_pool2d", [3, 4]), [N(2, 3, 7, 10)]),
    C("adaptive_max_pool1d", _pool("adaptive_max_pool1d", 3), [N(2, 3, 8)]),
    C("adaptive_max_pool3d", _pool("adaptive_max_pool3d", 2), [N(1, 2, 5, 4, 6)]),
]


@pytest.mark.parametrize("fn,inputs,grad,rtol,atol,same_dtype,grad_atol", CONV + POOL)
def test_functional_matches_jax(fn, inputs, grad, rtol, atol, same_dtype, grad_atol):
    check_functional(fn, inputs, grad, rtol, atol, same_dtype, grad_atol)


LAYERS = [
    L("Conv1D", lambda P: P.nn.Conv1D(3, 4, 3, padding=1), [N(2, 3, 8)]),
    L("Conv2D", lambda P: P.nn.Conv2D(3, 4, 3, stride=2, padding="SAME"), [N(2, 3, 7, 7)]),
    L("Conv2D_groups_nhwc", lambda P: P.nn.Conv2D(4, 6, [3, 2], groups=2, data_format="NHWC",
                                                  bias_attr=False), [N(2, 6, 5, 4)]),
    L("Conv2D_padding_mode_ignored", lambda P: P.nn.Conv2D(3, 4, 3, padding=1,
                                                           padding_mode="reflect"),
      [N(2, 3, 5, 5)]),
    L("Conv3D", lambda P: P.nn.Conv3D(2, 3, 2, dilation=2), [N(1, 2, 5, 5, 5)]),
    L("Conv1DTranspose", lambda P: P.nn.Conv1DTranspose(3, 4, 3, stride=2, output_padding=1),
      [N(2, 3, 5)]),
    L("Conv2DTranspose", lambda P: P.nn.Conv2DTranspose(3, 4, 3, stride=2, padding=1,
                                                        output_padding=1, groups=1),
      [N(2, 3, 4, 4)]),
    L("Conv2DTranspose_groups", lambda P: P.nn.Conv2DTranspose(4, 6, 2, stride=2, groups=2),
      [N(2, 4, 3, 3)]),
    L("Conv3DTranspose", lambda P: P.nn.Conv3DTranspose(2, 3, 2, stride=2), [N(1, 2, 3, 3, 3)]),
    L("MaxPool1D", lambda P: P.nn.MaxPool1D(2), [N(2, 3, 8)]),
    L("MaxPool2D", lambda P: P.nn.MaxPool2D(3, 2, 1), [N(2, 3, 7, 7)]),
    L("MaxPool2D_mask", lambda P: P.nn.MaxPool2D(2, return_mask=True), [N(2, 3, 6, 6)]),
    L("MaxPool3D", lambda P: P.nn.MaxPool3D(2), [N(1, 2, 4, 4, 4)]),
    L("AvgPool1D", lambda P: P.nn.AvgPool1D(3, 2, 1), [N(2, 3, 8)]),
    L("AvgPool2D", lambda P: P.nn.AvgPool2D(3, 2, 1, exclusive=False), [N(2, 3, 7, 7)]),
    L("AvgPool3D", lambda P: P.nn.AvgPool3D(2), [N(1, 2, 4, 4, 4)]),
    L("AdaptiveAvgPool1D", lambda P: P.nn.AdaptiveAvgPool1D(3), [N(2, 3, 8)]),
    L("AdaptiveAvgPool2D", lambda P: P.nn.AdaptiveAvgPool2D(1), [N(2, 3, 7, 7)]),
    L("AdaptiveAvgPool3D", lambda P: P.nn.AdaptiveAvgPool3D([2, 1, 3]), [N(1, 2, 4, 4, 5)]),
    L("AdaptiveMaxPool1D", lambda P: P.nn.AdaptiveMaxPool1D(3), [N(2, 3, 8)]),
    L("AdaptiveMaxPool2D", lambda P: P.nn.AdaptiveMaxPool2D([2, 3]), [N(2, 3, 7, 7)]),
    L("AdaptiveMaxPool3D", lambda P: P.nn.AdaptiveMaxPool3D(2), [N(1, 2, 4, 5, 4)]),
]


@pytest.mark.parametrize("make,inputs,steps,train", LAYERS)
def test_layer_matches_jax(make, inputs, steps, train):
    check_layer(make, inputs, steps, train)


def test_conv_weights_take_the_jax_shapes_and_fans():
    for P in (paddle, T):
        assert list(P.nn.Conv2D(4, 6, 3, groups=2).weight.shape) == [6, 2, 3, 3]
        assert list(P.nn.Conv2DTranspose(4, 6, 3, groups=2).weight.shape) == [4, 3, 3, 3]
        assert list(P.nn.Conv1D(4, 6, 5).weight.shape) == [6, 4, 5]
    # XavierUniform over fans shape[0] * 9 and shape[1] * 9
    T.seed(0)
    w = _np(T.nn.Conv2D(64, 128, 3).weight)
    limit = np.sqrt(6.0 / ((128 + 64) * 9))
    assert np.abs(w).max() <= limit and np.abs(w).max() > 0.95 * limit


@pytest.mark.parametrize("ceil", [False, True])
def test_avg_pool2d_ceil_mode_keeps_the_floor_shape(ceil):
    x = np.random.RandomState(0).randn(1, 4, 5, 5).astype(np.float32)
    shapes = [list(P.nn.functional.avg_pool2d(P.to_tensor(x, place="cpu"), 2, 2,
                                              ceil_mode=ceil).shape) for P in (paddle, T)]
    assert shapes[0] == shapes[1] == [1, 4, 2, 2]


def test_max_pool2d_ceil_rule_keeps_a_window_torch_drops():
    """kernel 2, stride 3, padding 1 on 5: the JAX rule pads the high side by
    stride - 1 and keeps a third window, which starts in the padding, where
    torch's ceil rule drops it."""
    x = np.random.RandomState(0).randn(1, 4, 5, 5).astype(np.float32)
    got = [_np(P.nn.functional.max_pool2d(P.to_tensor(x, place="cpu"), 2, 3, 1,
                                          ceil_mode=True)) for P in (paddle, T)]
    assert got[0].shape == got[1].shape == (1, 4, 3, 3)
    np.testing.assert_array_equal(got[1], got[0])
    plain = torch.nn.functional.max_pool2d(torch.from_numpy(x), 2, 3, 1, ceil_mode=True)
    assert tuple(plain.shape) == (1, 4, 2, 2)


def test_max_pool2d_mask_of_ties_is_the_first_in_row_major_order():
    x = np.ones((1, 1, 4, 4), np.float32)
    _, mask = T.nn.functional.max_pool2d(T.to_tensor(x, place="cpu"), 2, 2, return_mask=True)
    assert mask.dtype == torch.int64
    np.testing.assert_array_equal(_np(mask)[0, 0], [[0, 2], [8, 10]])


def test_conv3d_transpose_groups_raises_where_jax_is_wrong():
    rng = np.random.RandomState(0)
    x = rng.randn(1, 4, 3, 3, 3).astype(np.float32)
    w = rng.randn(4, 3, 2, 2, 2).astype(np.float32)
    wrong = paddle.nn.functional.conv3d_transpose(paddle.to_tensor(x), paddle.to_tensor(w),
                                                  groups=2)
    assert list(wrong.shape) == [1, 3, 4, 4, 4]   # the right result has 6 channels
    with pytest.raises(NotImplementedError, match="Queue C"):
        T.nn.functional.conv3d_transpose(T.to_tensor(x, place="cpu"),
                                         T.to_tensor(w, place="cpu"), groups=2)
    right = torch.nn.functional.conv_transpose3d(torch.from_numpy(x), torch.from_numpy(w),
                                                 groups=2)
    assert tuple(right.shape) == (1, 6, 4, 4, 4)


def test_transposed_conv_string_padding_past_stride_1_raises_as_in_jax():
    x, w = np.zeros((1, 2, 3, 3), np.float32), np.zeros((2, 3, 3, 3), np.float32)
    for P in (paddle, T):
        with pytest.raises(ValueError, match="String padding"):
            P.nn.functional.conv2d_transpose(P.to_tensor(x, place="cpu"),
                                             P.to_tensor(w, place="cpu"), stride=2,
                                             padding="SAME")


@pytest.mark.parametrize("op,category", [
    ("conv1d", "white"), ("conv2d", "white"), ("conv3d", "white"),
    ("conv2d_transpose", "white"), ("conv3d_transpose_inner", "white"), ("max_pool", None),
    ("avg_pool", None), ("adaptive_avg_pool", None), ("adaptive_max_pool", None)])
def test_ops_carry_the_jax_name_and_amp_category(op, category):
    from paddle_tpu.ops import _apply as jap
    from paddle_tpu_torch.ops import _apply as tap

    assert tap.get_registry()[op].amp_category == category
    assert jap.get_registry()[op].amp_category == category


def test_conv2d_runs_in_bf16_under_auto_cast():
    x = T.to_tensor(np.ones((1, 3, 5, 5), np.float32), place="cpu")
    conv = T.nn.Conv2D(3, 4, 3)
    with T.amp.auto_cast(dtype="bfloat16"):
        out = conv(x)
    assert out.dtype == torch.bfloat16


# -- the slice's conv net --------------------------------------------------------
def _conv_net(P):
    nn = P.nn

    class Bottleneck(nn.Layer):
        def __init__(self, c, mid):
            super().__init__()
            self.conv1 = nn.Conv2D(c, mid, 1, bias_attr=False)
            self.bn1 = nn.BatchNorm2D(mid)
            self.conv2 = nn.Conv2D(mid, mid, 3, padding=1, bias_attr=False)
            self.bn2 = nn.BatchNorm2D(mid)
            self.conv3 = nn.Conv2D(mid, c, 1, bias_attr=False)
            self.bn3 = nn.BatchNorm2D(c)
            self.relu = nn.ReLU()

        def forward(self, x):
            h = self.relu(self.bn1(self.conv1(x)))
            h = self.relu(self.bn2(self.conv2(h)))
            return self.relu(P.add(x, self.bn3(self.conv3(h))))

    class Net(nn.Layer):
        def __init__(self):
            super().__init__()
            self.stem = nn.Conv2D(3, 16, 3, stride=2, padding=1)
            self.bn = nn.BatchNorm2D(16)
            self.relu = nn.ReLU()
            self.pool = nn.MaxPool2D(3, 2, 1)
            self.block = Bottleneck(16, 8)
            self.gap = nn.AdaptiveAvgPool2D(1)
            self.flat = nn.Flatten()
            self.fc = nn.Linear(16, 10)
            self.loss = nn.CrossEntropyLoss()

        def forward(self, x):
            h = self.pool(self.relu(self.bn(self.stem(x))))
            return self.fc(self.flat(self.gap(self.block(h))))

    return Net()


def _conv_pair():
    paddle.seed(11)
    j, t = _conv_net(paddle), _conv_net(T)
    carry(j, t)
    return j, t


def _batch(step):
    r = np.random.RandomState(100 + step)
    return r.randn(2, 3, 32, 32).astype(np.float32), r.randint(0, 10, (2,)).astype(np.int64)


def _conv_loss(P, net, step):
    x, y = _batch(step)
    return net.loss(net(P.to_tensor(x, place="cpu")), P.to_tensor(y, place="cpu"))


def test_conv_net_loss_and_every_gradient_equal_jax():
    j, t = _conv_pair()
    losses = []
    for P, net in ((paddle, j), (T, t)):
        loss = _conv_loss(P, net, 0)
        loss.backward()
        losses.append(float(_np(loss)))
    np.testing.assert_allclose(losses[1], losses[0], rtol=RTOL, atol=ATOL)
    jg = {n: _np(p.grad) for n, p in j.named_parameters()}
    tg = {n: _np(p.grad) for n, p in t.named_parameters()}
    assert list(tg) == list(jg)
    for k in jg:
        np.testing.assert_allclose(tg[k], jg[k], rtol=RTOL, atol=ATOL, err_msg=k)


def test_conv_net_three_momentum_steps_and_running_stats_equal_jax():
    j, t = _conv_pair()
    curves = []
    for P, net in ((paddle, j), (T, t)):
        opt = P.optimizer.Momentum(learning_rate=0.05, momentum=0.9,
                                   parameters=net.parameters())
        curve = []
        for step in range(3):
            loss = _conv_loss(P, net, step)
            loss.backward()
            opt.step()
            opt.clear_grad()
            curve.append(float(_np(loss)))
        curves.append(curve)
    np.testing.assert_allclose(curves[1], curves[0], rtol=1e-5, atol=1e-5)
    jsd, tsd = _sd(j), _sd(t)
    assert list(tsd) == list(jsd) and any(k.endswith("_mean") for k in jsd)
    for k, v in jsd.items():
        np.testing.assert_allclose(tsd[k], v, rtol=1e-5, atol=1e-5, err_msg=k)


def test_conv_net_to_static_equals_eager():
    _, t = _conv_pair()
    t.eval()
    x = T.to_tensor(_batch(1)[0], place="cpu")
    eager = _np(t(x))
    static = T.jit.to_static(t, backend="aot_eager")
    np.testing.assert_allclose(_np(static(x)), eager, rtol=RTOL, atol=ATOL)


def test_conv_net_jit_save_load_round_trip(tmp_path):
    from paddle_tpu_torch.jit import InputSpec

    _, t = _conv_pair()
    t.eval()
    x = _batch(2)[0]
    want = _np(t(T.to_tensor(x, place="cpu")))
    path = str(tmp_path / "conv_net")
    T.jit.save(t, path, input_spec=[InputSpec([2, 3, 32, 32], "float32")])
    loaded = T.jit.load(path, device="cpu")
    np.testing.assert_allclose(_np(loaded(x)), want, rtol=RTOL, atol=ATOL)
