"""The port's transformer layers (paddle_tpu_torch/nn/layer/transformer.py)
against the JAX package's, and the slice as a whole.

Layer cases as in tests/test_torch_nn_common.py (the JAX ``state_dict``
carried into the port's with no transpose; outputs at float32 rtol 1e-5 /
atol 1e-6, input gradients and every parameter gradient by key at 1e-5 /
1e-5):
``MultiHeadAttention`` with ``kdim``/``vdim``, additive and boolean masks
and ``need_weights``, the encoder and decoder layers pre- and post-norm,
the stacks with a final norm, ``Transformer``. Attention runs the math path
here (a CPU query), as the JAX package's does on the CPU. Each stacked layer
is built afresh from the prototype's ``_config``, as in JAX.

The slice: a ``Transformer`` (d_model 32, 4 heads, 2+2 layers, FFN 64)
with a causal target mask runs in both packages with the same weights in
eval mode: the output, the loss, every gradient by ``state_dict`` key
(gradients at 1e-5 absolute), then three AdamW steps (losses and parameters
at 1e-5 / 1e-5, as tests/test_torch_nn_core.py; the key projections'
biases, whose gradient is 0 but for rounding, only within AdamW's step
bound); incremental decoding through ``gen_cache``
over 6 steps equals the full forward's positions (and the JAX package's
steps); ``to_static`` equals eager.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as T
from test_torch_nn_common import L, check_layer
from test_torch_nn_layers import _sd, carry
from test_torch_ops import A, N, _np, _on_cpu  # noqa: F401

RTOL, ATOL = 1e-5, 1e-6
# the gradients of a projection's weight sum over the batch, the sequence and
# the heads, in another order in each package: 1e-5 absolute on values of
# order 1-5 (tests/op_test.py holds gradients to 5e-3 / 5e-4)
GRAD_ATOL = 1e-5


def _causal(n):
    return A(np.where(np.tril(np.ones((n, n), bool)), 0.0, -np.inf).astype(np.float32))


_PAD_BOOL = A(np.array([True] * 5 + [False]).reshape(1, 1, 1, 6).repeat(2, 0))


class _Cached:
    """A ``MultiHeadAttention`` driven through a ``Cache``: two calls, the
    second seeing the first's keys and values; returns both outputs."""

    def __init__(self, mha):
        self.mha = mha

    def __call__(self, a, b):
        cache = self.mha.gen_cache(a)
        out1, cache = self.mha(a, a, a, None, cache)
        out2, cache = self.mha(b, b, b, None, cache)
        return out1, out2, cache.k


def _wrap(P, make):
    """A ``Layer`` around ``make(P)`` whose forward is ``fn(inner, *xs)``."""
    def build(fn):
        class Wrapped(P.nn.Layer):
            def __init__(self):
                super().__init__()
                self.inner = make(P)

            def forward(self, *xs):
                return fn(self.inner, *xs)
        return Wrapped()
    return build


def _mha(P, **kw):
    return P.nn.MultiHeadAttention(16, 4, **kw)


LAYERS = [
    L("MultiHeadAttention", lambda P: _mha(P), [N(2, 5, 16)]),
    L("MultiHeadAttention_cross_kdim", lambda P: _wrap(P, lambda P: _mha(P, kdim=8, vdim=12))(
        lambda m, q, k, v: m(q, k, v)), [N(2, 5, 16), N(2, 7, 8), N(2, 7, 12)]),
    L("MultiHeadAttention_float_mask", lambda P: _wrap(P, _mha)(
        lambda m, x, mask: m(x, attn_mask=mask)), [N(2, 6, 16), _causal(6)]),
    L("MultiHeadAttention_bool_mask", lambda P: _wrap(P, _mha)(
        lambda m, x, mask: m(x, x, x, mask)), [N(2, 6, 16), _PAD_BOOL]),
    L("MultiHeadAttention_need_weights", lambda P: _wrap(P, lambda P: _mha(
        P, need_weights=True))(lambda m, x: m(x)[0]), [N(2, 5, 16)]),
    L("MultiHeadAttention_cache", lambda P: _wrap(P, _mha)(
        lambda m, a, b: _Cached(m)(a, b)), [N(2, 3, 16), N(2, 1, 16)]),
    L("MultiHeadAttention_static_cache", lambda P: _wrap(P, _mha)(
        lambda m, q, mem: m(q, mem, mem, None, m.gen_cache(mem, type=m.StaticCache))),
      [N(2, 4, 16), N(2, 7, 16)]),
    L("TransformerEncoderLayer", lambda P: P.nn.TransformerEncoderLayer(16, 4, 32, dropout=0.0),
      [N(2, 6, 16)]),
    L("TransformerEncoderLayer_pre_gelu", lambda P: P.nn.TransformerEncoderLayer(
        16, 2, 24, dropout=0.0, activation="gelu", normalize_before=True,
        layer_norm_eps=1e-12), [N(2, 6, 16), _causal(6)]),
    L("TransformerEncoderLayer_eval", lambda P: P.nn.TransformerEncoderLayer(16, 4, 32),
      [N(2, 6, 16)], train=False),
    L("TransformerEncoder_norm", lambda P: P.nn.TransformerEncoder(
        P.nn.TransformerEncoderLayer(16, 4, 32, dropout=0.0, normalize_before=True), 3,
        P.nn.LayerNorm(16)), [N(2, 5, 16)]),
    L("TransformerDecoderLayer", lambda P: P.nn.TransformerDecoderLayer(16, 4, 32, dropout=0.0),
      [N(2, 5, 16), N(2, 7, 16), _causal(5)]),
    L("TransformerDecoderLayer_pre", lambda P: P.nn.TransformerDecoderLayer(
        16, 4, 32, dropout=0.0, normalize_before=True, activation="gelu"),
      [N(2, 5, 16), N(2, 7, 16)]),
    L("TransformerDecoder", lambda P: P.nn.TransformerDecoder(
        P.nn.TransformerDecoderLayer(16, 4, 32, dropout=0.0), 2),
      [N(2, 5, 16), N(2, 7, 16), _causal(5)]),
    L("Transformer", lambda P: P.nn.Transformer(16, 4, 2, 2, 32, dropout=0.0),
      [N(2, 7, 16), N(2, 5, 16), _causal(7), _causal(5)]),
    L("Transformer_pre_norm_eval", lambda P: P.nn.Transformer(
        16, 2, 1, 2, 24, normalize_before=True), [N(2, 7, 16), N(2, 5, 16)], train=False),
]


@pytest.mark.parametrize("make,inputs,steps,train", LAYERS)
def test_layer_matches_jax(make, inputs, steps, train):
    check_layer(make, inputs, steps, train, grad_atol=GRAD_ATOL)


def test_generate_square_subsequent_mask_equals_jax():
    want = _np(paddle.nn.Transformer.generate_square_subsequent_mask(5))
    got = T.nn.Transformer.generate_square_subsequent_mask(5)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(_np(got), want)


@pytest.mark.parametrize("stack", ["encoder", "decoder"])
def test_stacked_layers_are_initialised_apart_from_the_prototype(stack):
    """Each layer after the first is built from the prototype's ``_config``:
    its own initial weights, none a copy, as in JAX."""
    for P in (paddle, T):
        P.seed(3)
        if stack == "encoder":
            proto = P.nn.TransformerEncoderLayer(16, 4, 32)
            net = P.nn.TransformerEncoder(proto, 3)
        else:
            proto = P.nn.TransformerDecoderLayer(16, 4, 32)
            net = P.nn.TransformerDecoder(proto, 3)
        assert net.layers[0] is proto
        ws = [_np(layer.linear1.weight) for layer in net.layers]
        assert all(w.shape == (16, 32) for w in ws)
        assert not np.allclose(ws[0], ws[1]) and not np.allclose(ws[1], ws[2])
        assert net.layers[2]._config == proto._config


# -- the slice as a whole ----------------------------------------------------------
D, H, FFN, SRC, TGT = 32, 4, 64, 7, 6


def _pair():
    paddle.seed(21)
    j = paddle.nn.Transformer(D, H, 2, 2, FFN)
    t = T.nn.Transformer(D, H, 2, 2, FFN)
    carry(j, t)
    j.eval()
    t.eval()
    return j, t


def _data(seed=0):
    r = np.random.RandomState(seed)
    return (r.randn(2, SRC, D).astype(np.float32), r.randn(2, TGT, D).astype(np.float32),
            r.randn(2, TGT, D).astype(np.float32))


def _loss(P, net, src, tgt, y):
    mask = P.nn.Transformer.generate_square_subsequent_mask(TGT)
    out = net(P.to_tensor(src, place="cpu"), P.to_tensor(tgt, place="cpu"), tgt_mask=mask)
    return out, P.nn.functional.mse_loss(out, P.to_tensor(y, place="cpu"))


def test_transformer_output_loss_and_every_gradient_equal_jax():
    j, t = _pair()
    got = []
    for P, net in ((paddle, j), (T, t)):
        out, loss = _loss(P, net, *_data())
        loss.backward()
        got.append((_np(out), float(_np(loss)), {k: _np(p.grad) for k, p
                                                 in net.named_parameters()}))
    (jo, jl, jg), (to, tl, tg) = got
    np.testing.assert_allclose(to, jo, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tl, jl, rtol=RTOL, atol=ATOL)
    assert list(tg) == list(jg) and len(jg) == len(_sd(j))
    for k in jg:
        np.testing.assert_allclose(tg[k], jg[k], rtol=RTOL, atol=GRAD_ATOL, err_msg=k)


def test_transformer_three_adamw_steps_equal_jax():
    j, t = _pair()
    curves = []
    for P, net in ((paddle, j), (T, t)):
        opt = P.optimizer.AdamW(learning_rate=1e-2, parameters=net.parameters(),
                                weight_decay=0.01)
        curve = []
        for step in range(3):
            _, loss = _loss(P, net, *_data(step))
            loss.backward()
            opt.step()
            opt.clear_grad()
            curve.append(float(_np(loss)))
        curves.append(curve)
    np.testing.assert_allclose(curves[1], curves[0], rtol=1e-5, atol=1e-5)
    start = _sd(_pair()[0])
    for k, v in _sd(j).items():
        if k.endswith("k_proj.bias"):
            # a key bias shifts every logit of a row alike, which the softmax
            # ignores: its gradient is 0 up to float32 noise, which AdamW's
            # normalised step turns into steps of up to lr in either package
            for sd in (_sd(t), _sd(j)):
                assert np.abs(sd[k] - start[k]).max() <= 3 * 1e-2 * 1.01, k
            continue
        np.testing.assert_allclose(_sd(t)[k], v, rtol=1e-5, atol=1e-5, err_msg=k)


def _decode_steps(P, net, src, tgt):
    memory = net.encoder(P.to_tensor(src, place="cpu"))
    cache = net.decoder.gen_cache(memory)
    steps = []
    for i in range(TGT):
        out, cache = net.decoder(P.to_tensor(tgt[:, i:i + 1], place="cpu"), memory, None, None,
                                 cache)
        steps.append(_np(out))
    return np.concatenate(steps, axis=1), cache


def test_incremental_decoding_equals_the_full_forward():
    j, t = _pair()
    src, tgt, _ = _data(4)
    with torch.no_grad():
        full, _ = _loss(T, t, src, tgt, tgt)
        steps, cache = _decode_steps(T, t, src, tgt)
    jsteps, _ = _decode_steps(paddle, j, src, tgt)
    np.testing.assert_allclose(steps, _np(full), rtol=RTOL, atol=1e-5)
    np.testing.assert_allclose(steps, jsteps, rtol=RTOL, atol=ATOL)
    inc, static = cache[0]
    assert tuple(inc.k.shape) == (2, TGT, H, D // H) and tuple(static.k.shape) == (2, SRC, H,
                                                                                    D // H)


def test_transformer_to_static_equals_eager():
    _, t = _pair()
    src, tgt, _ = _data(5)
    mask = T.nn.Transformer.generate_square_subsequent_mask(TGT)
    args = (T.to_tensor(src, place="cpu"), T.to_tensor(tgt, place="cpu"))
    with torch.no_grad():
        eager = _np(t(*args, tgt_mask=mask))
        static = T.jit.to_static(t, backend="aot_eager")
        np.testing.assert_allclose(_np(static(*args, tgt_mask=mask)), eager, rtol=RTOL,
                                   atol=ATOL)
