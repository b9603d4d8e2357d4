"""The port's recurrent layers, beam-search decoding and nn.utils
(paddle_tpu_torch/nn/layer/rnn.py, nn/decode.py, nn/utils/) against the JAX
package's.

Layers as in tests/test_torch_nn_common.py's ``check_layer``: the JAX
``state_dict`` carried into the port's with no transpose, then the outputs
(the sequence output and the final states, flattened), the input gradients
and every parameter gradient by key, at float32 rtol 1e-5 / atol 1e-6
(gradients 1e-5 absolute: they sum over the batch and the time steps in
another order). ``SimpleRNN``/``LSTM``/``GRU`` at 1 and 2 layers, both
directions, ``time_major`` both ways, initial states given or not; the cells
with and without states; ``RNN`` forward and reversed, ``BiRNN``; each mode
again at float64 (1e-12). The JAX quirks the port keeps: ``dropout=0.5``
gives the ``dropout=0`` output, ``sequence_length`` changes nothing,
``proj_size`` is dropped.

Decoding: ``dynamic_decode`` over ``BeamSearchDecoder`` with a ``GRUCell``
and with an ``LSTMCell`` (tuple states), beam sizes 1, 3 and 4, vocabularies
of 7, 3 and 2 (below the beam size the beams that start at -1e9 tie in the
top-k, and at 2 tied candidates are kept side by side), ``return_length`` and
``output_time_major`` both ways, at float64 and float32: every step's ids
and parents and the final ids, lengths and finished flags equal the JAX
package's bit for bit, and the scores have its dtype and agree within
1e-13 relative at float64 (1e-6 at float32): the cell's products and the
softmax round in the last bit differently in XLA and in torch, so the scores
cannot be bit-equal, but no id depends on that bit; tests/test_nn.py's
TestBeamSearchDecode cases on the port.

``nn.utils``: ``weight_norm`` at ``dim`` 0, 1 and None on ``Linear`` and
``Conv2D`` (parameter names, shapes and order, forward, the gradients of
``_g`` and ``_v``), ``remove_weight_norm``; ``spectral_norm`` over three
forwards with ``u`` carried, in eval too; the parameter-vector round trip;
tests/test_nn_utils.py's cases on the port.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as T
from paddle_tpu.nn import utils as JU
from test_torch_nn_common import L, check_layer
from test_torch_nn_layers import _sd, carry
from test_torch_ops import N, _np, _on_cpu  # noqa: F401

GRAD_ATOL = 1e-5


def _flat_out(out):
    if isinstance(out, (tuple, list)):
        return [o for x in out for o in _flat_out(x)]
    return [out]


def _flat_layer(P, make, call=None):
    """A ``Layer`` around ``make(P)`` returning its outputs flattened;
    ``call(inner, *xs)`` (default ``inner(*xs)``) drives it."""
    class Flat(P.nn.Layer):
        def __init__(self):
            super().__init__()
            self.inner = make(P)

        def forward(self, *xs):
            out = call(self.inner, *xs) if call else self.inner(*xs)
            return tuple(_flat_out(out))
    return Flat()


_CLS = {"SimpleRNN": "SimpleRNN", "LSTM": "LSTM", "GRU": "GRU"}


def _rnn_case(mode, layers, direction, time_major, states):
    name = f"{mode}_l{layers}_{direction}_{'tm' if time_major else 'bm'}" + (
        "_states" if states else "")
    ndir = 2 if direction == "bidirect" else 1
    B, Tn, I, H = 3, 5, 4, 6
    x = N(Tn, B, I) if time_major else N(B, Tn, I)
    inputs = [x]
    call = None
    if states:
        inputs += [N(layers * ndir, B, H)] * (2 if mode == "LSTM" else 1)
        if mode == "LSTM":
            def call(m, x, h, c):
                return m(x, (h, c))
        else:
            def call(m, x, h):
                return m(x, h)
    make = (lambda P: _flat_layer(P, lambda P: getattr(P.nn, _CLS[mode])(
        I, H, num_layers=layers, direction=direction, time_major=time_major), call))
    return L(name, make, inputs)


RNN_LAYERS = [_rnn_case(m, nl, d, tm, st)
              for m in ("SimpleRNN", "LSTM", "GRU")
              for nl, d, tm, st in ((1, "forward", False, False), (2, "bidirect", False, False),
                                    (1, "bidirectional", True, False),
                                    (2, "forward", True, True), (2, "bidirect", False, True))]

CELL_LAYERS = [
    L("SimpleRNNCell_tanh", lambda P: _flat_layer(P, lambda P: P.nn.SimpleRNNCell(4, 6)),
      [N(3, 4), N(3, 6)]),
    L("SimpleRNNCell_relu_no_state", lambda P: _flat_layer(
        P, lambda P: P.nn.SimpleRNNCell(4, 6, activation="relu")), [N(3, 4)]),
    L("LSTMCell", lambda P: _flat_layer(P, lambda P: P.nn.LSTMCell(4, 6),
                                        lambda m, x, h, c: m(x, (h, c))),
      [N(3, 4), N(3, 6), N(3, 6)]),
    L("LSTMCell_no_state", lambda P: _flat_layer(P, lambda P: P.nn.LSTMCell(4, 6)), [N(3, 4)]),
    L("GRUCell", lambda P: _flat_layer(P, lambda P: P.nn.GRUCell(4, 6)), [N(3, 4), N(3, 6)]),
    L("GRUCell_no_state", lambda P: _flat_layer(P, lambda P: P.nn.GRUCell(4, 6)), [N(3, 4)]),
    L("RNN_GRUCell", lambda P: _flat_layer(P, lambda P: P.nn.RNN(P.nn.GRUCell(4, 6))),
      [N(3, 5, 4)]),
    L("RNN_LSTMCell_reverse_time_major", lambda P: _flat_layer(
        P, lambda P: P.nn.RNN(P.nn.LSTMCell(4, 6), is_reverse=True, time_major=True)),
      [N(5, 3, 4)]),
    L("RNN_SimpleRNNCell_states", lambda P: _flat_layer(
        P, lambda P: P.nn.RNN(P.nn.SimpleRNNCell(4, 6))), [N(3, 5, 4), N(3, 6)]),
    L("BiRNN", lambda P: _flat_layer(
        P, lambda P: P.nn.BiRNN(P.nn.GRUCell(4, 6), P.nn.GRUCell(4, 6))), [N(3, 5, 4)]),
    L("BiRNN_LSTMCell_states", lambda P: _flat_layer(
        P, lambda P: P.nn.BiRNN(P.nn.LSTMCell(4, 6), P.nn.LSTMCell(4, 6)),
        lambda m, x, h, c: m(x, ((h, c), (c, h)))), [N(3, 5, 4), N(3, 6), N(3, 6)]),
]


@pytest.mark.parametrize("make,inputs,steps,train", RNN_LAYERS + CELL_LAYERS)
def test_recurrent_layer_matches_jax(make, inputs, steps, train):
    check_layer(make, inputs, steps, train, grad_atol=GRAD_ATOL)


@pytest.mark.parametrize("mode", ["SimpleRNN", "LSTM", "GRU"])
def test_float64_matches_jax(mode):
    """2 bidirectional layers with given states at float64: outputs, states
    and every gradient within 1e-12."""
    paddle.seed(3)
    jl = getattr(paddle.nn, mode)(4, 6, num_layers=2, direction="bidirect").to(dtype="float64")
    tl = getattr(T.nn, mode)(4, 6, num_layers=2, direction="bidirect").to(dtype="float64")
    carry(jl, tl)
    r = np.random.RandomState(4)
    x = r.standard_normal((3, 5, 4))
    h = r.standard_normal((4, 3, 6))
    c = r.standard_normal((4, 3, 6))
    ct = r.standard_normal(256)
    got = []
    for P, layer in ((paddle, jl), (T, tl)):
        xs = [P.to_tensor(a, place="cpu", stop_gradient=False) for a in (x, h, c)]
        out = layer(xs[0], (xs[1], xs[2]) if mode == "LSTM" else xs[1])
        outs = _flat_out(out)
        loss = None
        for o in outs:
            term = P.sum(P.multiply(o, P.to_tensor(ct[:_np(o).size].reshape(_np(o).shape),
                                                   place="cpu")))
            loss = term if loss is None else P.add(loss, term)
        loss.backward()
        got.append(([_np(o) for o in outs], [_np(v.grad) for v in xs if v.grad is not None],
                    {n: _np(p.grad) for n, p in layer.named_parameters()}))
    (jo, jg, jp), (to, tg, tp) = got
    assert all(o.dtype == np.float64 for o in to)
    for a, b in zip(to + tg, jo + jg):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)
    assert list(tp) == list(jp)
    for k in jp:
        np.testing.assert_allclose(tp[k], jp[k], rtol=1e-12, atol=1e-12, err_msg=k)


def test_dropout_is_stored_and_not_applied():
    """``dropout=0.5`` in training mode gives the ``dropout=0`` output, as
    the JAX layer never applies it."""
    r = np.random.RandomState(6)
    x = r.standard_normal((3, 5, 4)).astype(np.float32)
    paddle.seed(0)
    ref = paddle.nn.GRU(4, 6, num_layers=2, dropout=0.0)
    for P, base in ((paddle, ref), (T, None)):
        drop = P.nn.GRU(4, 6, num_layers=2, dropout=0.5)
        plain = P.nn.GRU(4, 6, num_layers=2, dropout=0.0)
        state = _sd(ref)
        for layer in (drop, plain):
            layer.set_state_dict(state)
            layer.train()
        assert drop.dropout == 0.5
        a, _ = drop(P.to_tensor(x, place="cpu"))
        b, _ = plain(P.to_tensor(x, place="cpu"))
        np.testing.assert_array_equal(_np(a), _np(b))
    np.testing.assert_allclose(_np(b), _np(ref(paddle.to_tensor(x))[0]), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("P", [paddle, T], ids=["jax", "port"])
def test_sequence_length_changes_nothing(P):
    r = np.random.RandomState(7)
    x = P.to_tensor(r.standard_normal((3, 5, 4)).astype(np.float32), place="cpu")
    lens = P.to_tensor(np.array([5, 2, 1], np.int64), place="cpu")
    P.seed(1)
    lstm = P.nn.LSTM(4, 6, direction="bidirect")
    y0, (h0, c0) = lstm(x)
    y1, (h1, c1) = lstm(x, sequence_length=lens)
    for a, b in ((y0, y1), (h0, h1), (c0, c1)):
        np.testing.assert_array_equal(_np(a), _np(b))
    P.seed(1)
    cell = P.nn.GRUCell(4, 6)
    for wrapper in (P.nn.RNN(cell), P.nn.BiRNN(cell, cell)):
        np.testing.assert_array_equal(_np(wrapper(x)[0]), _np(wrapper(x, None, lens)[0]))


def test_proj_size_is_dropped():
    """``LSTM(proj_size=...)`` builds the parameters of an LSTM without it
    and computes the same function, in both packages."""
    names = {}
    for P in (paddle, T):
        with_proj = P.nn.LSTM(4, 6, proj_size=3)
        without = P.nn.LSTM(4, 6)
        shapes = [(n, tuple(p.shape)) for n, p in with_proj.named_parameters()]
        assert shapes == [(n, tuple(p.shape)) for n, p in without.named_parameters()]
        names[P.__name__] = shapes
    assert names["paddle_tpu"] == names["paddle_tpu_torch"]
    check_layer(lambda P: _flat_layer(P, lambda P: P.nn.LSTM(4, 6, proj_size=3)),
                [N(3, 5, 4)], grad_atol=GRAD_ATOL)


def test_default_states_take_the_promoted_dtype():
    """float64 inputs through float32 weights: float64 states and outputs."""
    lstm = T.nn.LSTM(4, 6)
    jl = paddle.nn.LSTM(4, 6)
    x = np.random.RandomState(8).standard_normal((2, 3, 4))
    ty, (th, tc) = lstm(torch.tensor(x))
    jy, (jh, jc) = jl(paddle.to_tensor(x))
    assert ty.dtype == th.dtype == tc.dtype == torch.float64
    assert _np(jy).dtype == _np(jh).dtype == np.float64


def test_lstm_gru_shapes():
    """tests/test_nn.py test_lstm_gru on the port."""
    lstm = T.nn.LSTM(8, 16, num_layers=2, direction="bidirect")
    x = torch.randn(3, 5, 8)
    y, (h, c) = lstm(x)
    assert tuple(y.shape) == (3, 5, 32)
    assert tuple(h.shape) == (4, 3, 16) and tuple(c.shape) == (4, 3, 16)
    y.sum().backward()
    assert all(p.grad is not None for p in lstm.parameters())
    y2, h2 = T.nn.GRU(8, 16)(x)
    assert tuple(y2.shape) == (3, 5, 16) and tuple(h2.shape) == (1, 3, 16)


def test_get_initial_states():
    for P in (paddle, T):
        cell = P.nn.GRUCell(4, 6)
        ref = P.to_tensor(np.zeros((3, 4), np.float64), place="cpu")
        s = cell.get_initial_states(ref, init_value=1.5)
        assert _np(s).shape == (3, 6) and _np(s).dtype == np.float64
        assert (_np(s) == 1.5).all()
        s32 = cell.get_initial_states(ref, dtype="float32")
        assert _np(s32).dtype == np.float32


# -- beam-search decoding ------------------------------------------------------
def _decoder_parts(P, cell_kind, V, H, dtype):
    P.seed(0)
    cell = (P.nn.GRUCell if cell_kind == "gru" else P.nn.LSTMCell)(H, H)
    emb = P.nn.Embedding(V, H)
    proj = P.nn.Linear(H, V)
    return [m.to(dtype=dtype) for m in (cell, emb, proj)]


def _carried_parts(cell_kind, V, H, dtype):
    jparts = _decoder_parts(paddle, cell_kind, V, H, dtype)
    tparts = _decoder_parts(T, cell_kind, V, H, dtype)
    for j, t in zip(jparts, tparts):
        carry(j, t)
    return jparts, tparts


def _decode(P, parts, cell_kind, K, H, B, dtype, steps, **kw):
    """dynamic_decode, and the same decoder stepped by hand: every step's
    (scores, ids, parents) and the decode's results as numpy."""
    cell, emb, proj = parts
    init = np.random.RandomState(9).standard_normal((B, H)).astype(dtype)
    h = P.to_tensor(init, place="cpu")
    inits = (h, P.to_tensor(init[::-1].copy(), place="cpu")) if cell_kind == "lstm" else h
    dec = P.nn.BeamSearchDecoder(cell, start_token=0, end_token=1, beam_size=K,
                                 embedding_fn=emb, output_fn=proj)
    out = P.nn.dynamic_decode(dec, inits=inits, max_step_num=steps, **kw)
    inputs, states, _ = dec.initialize(inits)
    per_step = []
    for t in range(steps):
        o, states, inputs, fin = dec.step(t, inputs, states)
        per_step.append([_np(v) for v in (o.scores, o.predicted_ids, o.parent_ids)])
        if bool(np.all(_np(fin))):
            break
    final = out[1]
    res = dict(preds=_np(out[0]), log_probs=_np(final.log_probs), lengths=_np(final.lengths),
               finished=_np(final.finished))
    if kw.get("return_length"):
        res["returned_lengths"] = _np(out[2])
    return res, per_step


DECODE_CASES = [
    pytest.param("gru", 3, 7, "float64", {}, id="gru_k3_v7_f64"),
    pytest.param("gru", 1, 7, "float64", dict(return_length=True), id="gru_k1_v7_f64"),
    pytest.param("gru", 4, 3, "float64", dict(return_length=True), id="gru_k4_v3_ties_f64"),
    pytest.param("gru", 4, 2, "float64", {}, id="gru_k4_v2_tied_scores_f64"),
    pytest.param("lstm", 3, 7, "float64", dict(output_time_major=True), id="lstm_k3_v7_f64"),
    pytest.param("lstm", 4, 3, "float64", dict(return_length=True, output_time_major=True),
                 id="lstm_k4_v3_ties_f64"),
    pytest.param("gru", 4, 7, "float32", dict(return_length=True), id="gru_k4_v7_f32"),
]


# the scores: the last bits of the cell's products differ (module docstring)
SCORE_RTOL = {"float64": 1e-13, "float32": 1e-6}


@pytest.mark.parametrize("cell_kind,K,V,dtype,kw", DECODE_CASES)
def test_beam_search_matches_jax(cell_kind, K, V, dtype, kw):
    H, B, steps = 8, 2, 6
    jparts, tparts = _carried_parts(cell_kind, V, H, dtype)
    jres, jsteps = _decode(paddle, jparts, cell_kind, K, H, B, dtype, steps, **kw)
    tres, tsteps = _decode(T, tparts, cell_kind, K, H, B, dtype, steps, **kw)
    assert len(tsteps) == len(jsteps)
    rtol = SCORE_RTOL[dtype]
    for t, (js, ts) in enumerate(zip(jsteps, tsteps)):
        for name, a, b in zip(("scores", "ids", "parents"), ts, js):
            assert a.dtype == b.dtype, (t, name, a.dtype, b.dtype)
            if name == "scores":
                np.testing.assert_allclose(a, b, rtol=rtol, atol=0, err_msg=f"step {t}")
            else:
                np.testing.assert_array_equal(a, b, err_msg=f"step {t} {name}")
    assert tres.keys() == jres.keys()
    for k in jres:
        assert tres[k].dtype == jres[k].dtype, k
        if k == "log_probs":
            np.testing.assert_allclose(tres[k], jres[k], rtol=rtol, atol=0)
        else:
            np.testing.assert_array_equal(tres[k], jres[k], err_msg=k)
    if V < K:
        # beams 1..K-1 start at -1e9 with beam 0's state, so their
        # candidates tie; at V = 2 two tied candidates are both kept
        assert jres["finished"].any()
        if V == 2:
            assert any(len(np.unique(row)) < row.size for js in jsteps for row in js[0])


def test_tile_beam_merge_with_batch():
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    a = paddle.nn.BeamSearchDecoder.tile_beam_merge_with_batch(paddle.to_tensor(x), 3)
    b = T.nn.BeamSearchDecoder.tile_beam_merge_with_batch(torch.tensor(x), 3)
    np.testing.assert_array_equal(_np(b), _np(a))


class TestBeamSearchDecode:
    """tests/test_nn.py TestBeamSearchDecode on the port."""

    def _parts(self, V=7, H=16):
        T.seed(0)
        return T.nn.GRUCell(H, H), T.nn.Embedding(V, H), T.nn.Linear(H, V)

    def test_shapes_and_score_order(self):
        cell, emb, proj = self._parts()
        dec = T.nn.BeamSearchDecoder(cell, start_token=0, end_token=1, beam_size=3,
                                     embedding_fn=emb, output_fn=proj)
        preds, states, lengths = T.nn.dynamic_decode(dec, inits=torch.zeros(2, 16),
                                                     max_step_num=5, return_length=True)
        assert tuple(preds.shape) == (2, 5, 3)
        lp = _np(states.log_probs)
        assert (np.diff(lp, axis=1) <= 1e-5).all()

    def test_greedy_beam1_matches_manual_argmax(self):
        cell, emb, proj = self._parts()
        dec = T.nn.BeamSearchDecoder(cell, start_token=0, end_token=1, beam_size=1,
                                     embedding_fn=emb, output_fn=proj)
        preds, _ = T.nn.dynamic_decode(dec, inits=torch.zeros(1, 16), max_step_num=4)
        h = torch.zeros(1, 16)
        tok = torch.tensor([0])
        manual = []
        for _ in range(4):
            out, h = cell(emb(tok), h)
            tok = proj(out).argmax(-1)
            manual.append(int(tok[0]))
            if manual[-1] == 1:
                break
        np.testing.assert_array_equal(_np(preds)[0, :len(manual), 0], manual)

    def test_end_token_stops_and_lengths(self):
        cell, emb, _ = self._parts(V=5)

        class EndBias(T.nn.Layer):
            def __init__(self):
                super().__init__()
                self.lin = T.nn.Linear(16, 5)
                self.step = [0]

            def forward(self, x):
                out = self.lin(x)
                self.step[0] += 1
                if self.step[0] >= 2:  # force the end token from step 2 on
                    bias = torch.zeros(5)
                    bias[1] = 100.0
                    out = out + bias
                return out

        dec = T.nn.BeamSearchDecoder(cell, start_token=0, end_token=1, beam_size=2,
                                     embedding_fn=emb, output_fn=EndBias())
        preds, states, lengths = T.nn.dynamic_decode(dec, inits=torch.zeros(1, 16),
                                                     max_step_num=10, return_length=True)
        assert preds.shape[1] < 10
        assert int(states.lengths.max()) == 2
        np.testing.assert_array_equal(_np(preds)[0, 1, :], 1)


# -- nn.utils ------------------------------------------------------------------
def _norm_layer(P, kind):
    P.seed(0)
    return P.nn.Linear(4, 3) if kind == "linear" else P.nn.Conv2D(2, 3, 3)


def _norm_input(kind):
    r = np.random.RandomState(10)
    shape = (2, 4) if kind == "linear" else (2, 2, 5, 5)
    return r.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("kind", ["linear", "conv"])
@pytest.mark.parametrize("dim", [0, 1, None])
def test_weight_norm_matches_jax(kind, dim):
    jl, tl = _norm_layer(paddle, kind), _norm_layer(T, kind)
    carry(jl, tl)
    JU.weight_norm(jl, dim=dim)
    T.nn.utils.weight_norm(tl, dim=dim)
    jsd, tsd = _sd(jl), _sd(tl)
    assert list(tsd) == list(jsd)
    assert [(k, v.shape) for k, v in tsd.items()] == [(k, v.shape) for k, v in jsd.items()]
    for k in jsd:
        np.testing.assert_allclose(tsd[k], jsd[k], rtol=1e-6, atol=1e-7, err_msg=k)
    x = _norm_input(kind)
    ct = np.random.RandomState(11).standard_normal(64).astype(np.float32)
    grads = []
    for P, layer in ((paddle, jl), (T, tl)):
        out = layer(P.to_tensor(x, place="cpu"))
        P.sum(P.multiply(out, P.to_tensor(ct[:_np(out).size].reshape(_np(out).shape),
                                          place="cpu"))).backward()
        np.testing.assert_allclose(_np(layer.weight), _np(jl.weight), rtol=1e-6, atol=1e-7)
        grads.append((_np(out), {n: _np(p.grad) for n, p in layer.named_parameters()}))
    (jo, jg), (to, tg) = grads
    np.testing.assert_allclose(to, jo, rtol=1e-5, atol=1e-6)
    assert list(tg) == list(jg) and f"weight_g" in tg and "weight" not in tg
    for k in jg:
        np.testing.assert_allclose(tg[k], jg[k], rtol=1e-5, atol=1e-5, err_msg=k)
    JU.remove_weight_norm(jl)
    T.nn.utils.remove_weight_norm(tl)
    assert list(_sd(tl)) == list(_sd(jl))
    np.testing.assert_allclose(_np(tl.weight), _np(jl.weight), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(_np(tl(torch.tensor(x))), _np(jl(paddle.to_tensor(x))),
                               rtol=1e-5, atol=1e-6)


def test_weight_g_keeps_the_reduced_dims():
    lin = T.nn.Linear(4, 3)
    T.nn.utils.weight_norm(lin, dim=0)
    assert tuple(lin.weight_g.shape) == (4, 1) and tuple(lin.weight_v.shape) == (4, 3)
    with pytest.raises(ValueError, match="weight_norm was not applied"):
        T.nn.utils.remove_weight_norm(lin, "bias")


@pytest.mark.parametrize("kind,dim", [("linear", 0), ("linear", 1), ("conv", 0), ("conv", 1)])
def test_spectral_norm_matches_jax(kind, dim):
    """Three forwards (u carried on the hook), the last in eval mode, then
    the gradients of ``weight_orig``."""
    jl, tl = _norm_layer(paddle, kind), _norm_layer(T, kind)
    carry(jl, tl)
    JU.spectral_norm(jl, n_power_iterations=2, dim=dim)
    T.nn.utils.spectral_norm(tl, n_power_iterations=2, dim=dim)
    assert list(_sd(tl)) == list(_sd(jl))
    x = _norm_input(kind)
    outs = []
    for P, layer in ((paddle, jl), (T, tl)):
        got = []
        for i in range(3):
            if i == 2:
                layer.eval()
            out = layer(P.to_tensor(x, place="cpu"))
            got.append(_np(out))
        P.sum(out).backward()
        got.append(_np(layer.weight))
        got += [_np(p.grad) for _, p in layer.named_parameters()]
        outs.append(got)
    for a, b in zip(outs[1], outs[0]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("norm", ["weight_norm", "spectral_norm"])
def test_reparameterized_layer_deep_copies(norm):
    """A copy computes what the layer computes, trains its own parameters,
    and copies again; the original keeps its derived weight."""
    import copy

    T.seed(0)
    lin = T.nn.Linear(4, 3)
    getattr(T.nn.utils, norm)(lin)
    x = torch.tensor(_norm_input("linear"))
    lin(x).sum().backward()
    twin = copy.deepcopy(lin)
    assert not twin.weight.requires_grad and torch.equal(twin.weight, lin.weight)
    np.testing.assert_array_equal(_np(copy.deepcopy(twin)(x)), _np(lin(x)))
    twin(x).sum().backward()
    assert all(p.grad is not None for p in twin.parameters())
    assert lin.weight.grad_fn is not None
    if norm == "weight_norm":
        T.nn.utils.remove_weight_norm(twin)
        assert "weight" in dict(twin.named_parameters())
        copy.deepcopy(twin)


def test_parameter_vector_round_trip():
    jl, tl = paddle.nn.Linear(3, 2), T.nn.Linear(3, 2)
    carry(jl, tl)
    jv = JU.parameters_to_vector(jl.parameters())
    tv = T.nn.utils.parameters_to_vector(tl.parameters())
    np.testing.assert_array_equal(_np(tv), _np(jv))
    assert not tv.requires_grad
    new = np.arange(8, dtype=np.float32)
    JU.vector_to_parameters(paddle.to_tensor(new), jl.parameters())
    T.nn.utils.vector_to_parameters(torch.tensor(new), tl.parameters())
    for k, v in _sd(jl).items():
        np.testing.assert_array_equal(_sd(tl)[k], v)
    with pytest.raises(ValueError, match="length"):
        T.nn.utils.vector_to_parameters(torch.ones(3), tl.parameters())


class TestNNUtils:
    """tests/test_nn_utils.py's cases on the port."""

    def test_training_moves_g_and_v(self):
        T.seed(1)
        lin = T.nn.Linear(3, 2)
        T.nn.utils.weight_norm(lin)
        opt = T.optimizer.SGD(learning_rate=0.1, parameters=lin.parameters())
        x = torch.ones(4, 3)
        g0 = _np(lin.weight_g).copy()
        for _ in range(3):
            (lin(x) ** 2).mean().backward()
            opt.step()
            opt.clear_grad()
        assert not np.array_equal(_np(lin.weight_g), g0)

    def test_unit_spectral_norm_and_grads(self):
        T.seed(0)
        lin = T.nn.Linear(6, 5)
        T.nn.utils.spectral_norm(lin, n_power_iterations=20)
        out = lin(torch.ones(1, 6))
        s = np.linalg.svd(_np(lin.weight), compute_uv=False)[0]
        assert abs(s - 1.0) < 1e-3
        out.sum().backward()
        assert lin.weight_orig.grad is not None

    def test_clippers_are_nn_clip(self):
        assert T.nn.utils.clip_grad_norm_ is T.nn.clip.clip_grad_norm_
        assert T.nn.utils.clip_grad_value_ is T.nn.clip.clip_grad_value_
