"""The port's quantization package (paddle_tpu_torch/quantization/) and
nn.quant against the JAX package's.

Weight-only: ``weight_quantize``'s int8 (per channel and group-wise) and
int4 tensors and scales equal the JAX package's bit for bit, from float32
and bfloat16 weights and numpy arrays, odd K for int4; ``weight_dequantize``
bit for bit, a group-wise scale raising ``NotImplementedError`` (the JAX
function raises ``TypeError`` there); ``weight_only_linear`` per channel,
int4 and group-wise, and ``WeightOnlyLinear`` (state keys, the shared bias)
within 1e-5 of JAX; ``quantize_for_inference``'s counts, ``min_features``,
the private ``_TorchLinear`` of the LLaMA and the skipped QAT wrappers;
tests/test_quantization.py's int8 LLaMA-block accuracy (rel < 0.05) on the
port's ``LlamaDecoderLayer``, and the same block quantized in both packages
from the same weights; a 2-layer LLaMA of the flagship's shape (GQA, tied
and not) quantized int8 and int4 in JAX and carried across by
``llama_from_numpy`` gives JAX's logits (1e-4) and, through both decode
engines, JAX's greedy tokens for 8 steps.

QAT/PTQ: the observers' scales equal JAX's; ``FakeQuanterWithAbsMax`` (EMA
and running max) and ``FakeQuanterChannelWiseAbsMax`` over three training
calls: outputs, straight-through gradients and running scales equal JAX's;
``QAT`` on tests/test_quantization.py's LeNet with the JAX weights: three
Adam steps give JAX's losses (1e-5) and scales, and ``convert`` freezes only
the per-tensor quanters; ``PTQ.calibrate``; a training quanter under
``jit.to_static`` equals eager (output and scale); ``quanter()``'s
registration and its refusal of a taken name; ``nn.quant``.
"""
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as T
from paddle_tpu import quantization as JQ
from paddle_tpu_torch import quantization as TQ
from test_torch_nn_layers import _sd, carry
from test_torch_ops import _np, _on_cpu  # noqa: F401

RTOL, ATOL = 1e-5, 1e-5


def _weight(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).standard_normal(shape) * scale).astype(np.float32)


def _same_bits(t, j):
    a, b = _np(t), _np(j)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype, a.shape, b.shape)
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


QUANT_CASES = [
    pytest.param("weight_only_int8", -1, (64, 32), id="int8"),
    pytest.param("weight_only_int8", 4, (16, 8), id="int8_group4"),
    pytest.param("weight_only_int8", 8, (64, 24), id="int8_group8"),
    pytest.param("weight_only_int4", -1, (10, 6), id="int4_even_k"),
    pytest.param("weight_only_int4", -1, (11, 6), id="int4_odd_k"),
]


@pytest.mark.parametrize("source", ["float32", "bfloat16", "numpy"])
@pytest.mark.parametrize("algo,group,shape", QUANT_CASES)
def test_weight_quantize_bit_for_bit(algo, group, shape, source):
    w = _weight(shape, 1, scale=3.0)
    w[0, 0] = 0.0
    if source == "numpy":
        jw, tw = w, w
    else:
        jw = paddle.to_tensor(w).astype(source)
        tw = torch.tensor(w).to(getattr(torch, source))
    jq, js = JQ.weight_quantize(jw, algo, group_size=group)
    tq, ts = TQ.weight_quantize(tw, algo, group_size=group)
    _same_bits(tq, jq)
    _same_bits(ts, js)


def test_weight_quantize_rounds_half_to_even():
    # a column whose absmax is 127 makes the scale exactly 1: 2.5 -> 2, 3.5 -> 4
    w = np.array([[127.0], [2.5], [3.5], [-2.5]], np.float32)
    q, s = TQ.weight_quantize(torch.tensor(w))
    assert float(s[0]) == 1.0 and q.flatten().tolist() == [127, 2, 4, -2]
    with pytest.raises(NotImplementedError, match="group_size"):
        TQ.weight_quantize(torch.tensor(w), "weight_only_int4", group_size=2)
    with pytest.raises(ValueError, match="not divisible"):
        TQ.weight_quantize(torch.ones(6, 2), group_size=4)
    with pytest.raises(ValueError, match="algo"):
        TQ.weight_quantize(torch.ones(6, 2), "fp8")


@pytest.mark.parametrize("algo,k", [("weight_only_int8", None), ("weight_only_int4", 11),
                                    ("weight_only_int4", None)])
def test_weight_dequantize_bit_for_bit(algo, k):
    w = _weight((11 if k else 10, 6), 2)
    jq, js = JQ.weight_quantize(paddle.to_tensor(w), algo)
    tq, ts = TQ.weight_quantize(torch.tensor(w), algo)
    _same_bits(TQ.weight_dequantize(tq, ts, algo, k=k), JQ.weight_dequantize(jq, js, algo, k=k))
    if algo == "weight_only_int8":
        _same_bits(TQ.weight_dequantize(tq, ts, algo, out_dtype="bfloat16"),
                   JQ.weight_dequantize(jq, js, algo, out_dtype="bfloat16"))


def test_groupwise_dequantize_raises_where_jax_raises():
    w = _weight((8, 4), 3)
    jq, js = JQ.weight_quantize(paddle.to_tensor(w), group_size=4)
    tq, ts = TQ.weight_quantize(torch.tensor(w), group_size=4)
    assert tuple(ts.shape) == (2, 4)
    with pytest.raises(TypeError):
        JQ.weight_dequantize(jq, js)
    with pytest.raises(NotImplementedError, match="Queue C"):
        TQ.weight_dequantize(tq, ts)


@pytest.mark.parametrize("algo,group,bias", [("int8", -1, True), ("int8", -1, False),
                                             ("int4", -1, True), ("int8", 4, True)])
def test_weight_only_linear_matches_jax(algo, group, bias):
    w = _weight((16, 8), 4)
    x = _weight((3, 5, 16), 5)
    b = _weight((8,), 6)
    full = "weight_only_" + algo
    jq, js = JQ.weight_quantize(paddle.to_tensor(w), full, group_size=group)
    tq, ts = TQ.weight_quantize(torch.tensor(w), full, group_size=group)
    jb, tb = (paddle.to_tensor(b), torch.tensor(b)) if bias else (None, None)
    jy = JQ.weight_only_linear(paddle.to_tensor(x), jq, jb, js, weight_dtype=algo,
                               group_size=group)
    ty = TQ.weight_only_linear(torch.tensor(x), tq, tb, ts, weight_dtype=algo)
    np.testing.assert_allclose(_np(ty), _np(jy), rtol=RTOL, atol=ATOL)
    # group_size is ignored: the scale's rank decides
    ty2 = TQ.weight_only_linear(torch.tensor(x), tq, tb, ts, weight_dtype=algo, group_size=99)
    np.testing.assert_array_equal(_np(ty2), _np(ty))
    with pytest.raises(ValueError, match="weight_scale"):
        TQ.weight_only_linear(torch.tensor(x), tq)


@pytest.mark.parametrize("algo", ["weight_only_int8", "weight_only_int4"])
def test_weight_only_linear_layer_matches_jax(algo):
    paddle.seed(0)
    jlin, tlin = paddle.nn.Linear(16, 8), T.nn.Linear(16, 8)
    carry(jlin, tlin)
    jw, tw = JQ.WeightOnlyLinear(jlin, algo), TQ.WeightOnlyLinear(tlin, algo)
    assert list(tw.state_dict()) == list(jw.state_dict()) == ["bias", "quant_weight",
                                                              "weight_scale"]
    assert tw.bias is tlin.bias
    assert not any(n.startswith("quant") for n, _ in tw.named_parameters())
    for k, v in _sd(jw).items():
        np.testing.assert_array_equal(_sd(tw)[k], v)
    x = _weight((4, 16), 7)
    np.testing.assert_allclose(_np(tw(torch.tensor(x))), _np(jw(paddle.to_tensor(x))),
                               rtol=RTOL, atol=ATOL)
    assert (tw.in_features, tw.out_features) == (16, 8)
    assert algo in repr(tw)


def test_weight_only_linear_matches_dequant_matmul():
    """tests/test_quantization.py's case on the port."""
    x = torch.tensor(_weight((4, 16), 2))
    lin = T.nn.Linear(16, 8)
    wol = TQ.WeightOnlyLinear(lin)
    want = x @ TQ.weight_dequantize(wol.quant_weight, wol.weight_scale) + lin.bias
    np.testing.assert_allclose(_np(wol(x)), _np(want), rtol=1e-5, atol=1e-5)


def test_torch_linear_is_quantized_in_the_jax_layout():
    from paddle_tpu_torch.nn.layer.common import _TorchLinear

    lin = _TorchLinear(16, 8, bias=False)
    wol = TQ.WeightOnlyLinear(lin)
    q, s = TQ.weight_quantize(lin.weight.t())
    assert tuple(wol.quant_weight.shape) == (16, 8) and wol.bias is None
    assert torch.equal(wol.quant_weight, q) and torch.equal(wol.weight_scale, s)
    x = torch.tensor(_weight((3, 16), 8))
    np.testing.assert_allclose(_np(wol(x)), _np(lin(x)), rtol=0.05, atol=0.05)


def test_quantize_for_inference_counts_and_min_features():
    for P, Q in ((paddle, JQ), (T, TQ)):
        model = P.nn.Sequential(P.nn.Linear(4, 4), P.nn.Linear(64, 4))
        assert Q.quantize_for_inference(model, min_features=16) == 1
        assert isinstance(model[1], Q.WeightOnlyLinear)
        assert isinstance(model[0], P.nn.Linear)
        nested = P.nn.Sequential(P.nn.Sequential(P.nn.Linear(8, 8), P.nn.ReLU()),
                                 P.nn.Linear(8, 2))
        assert Q.quantize_for_inference(nested, algo="weight_only_int4") == 2
        assert nested[0][0].algo == "weight_only_int4"


def test_quantize_for_inference_skips_qat_wrappers():
    for P, Q in ((paddle, JQ), (T, TQ)):
        model = Q.QAT().quantize(P.nn.Sequential(P.nn.Linear(8, 8), P.nn.Linear(8, 2)))
        assert Q.quantize_for_inference(model) == 0
        assert isinstance(model[0].inner, P.nn.Linear)


def _port_block(jblock, cfg_kw):
    """The port's LlamaDecoderLayer with the JAX block's weights (its
    projections transposed to torch's layout)."""
    from paddle_tpu_torch.models import LlamaConfig
    from paddle_tpu_torch.models.llama import LlamaDecoderLayer

    block = LlamaDecoderLayer(LlamaConfig(**cfg_kw), device="cpu")
    params = dict(block.named_parameters())
    with torch.no_grad():
        for k, v in _sd(jblock).items():
            params[k].copy_(torch.tensor(v.T if v.ndim == 2 else v))
    return block.eval()


def test_llama_block_weight_only_int8_accuracy():
    """tests/test_quantization.py's case on the port's block, and the block
    quantized in both packages from the same weights."""
    from paddle_tpu.models import LlamaConfig
    from paddle_tpu.models.llama import LlamaDecoderLayer

    cfg_kw = dict(vocab_size=64, hidden_size=64, intermediate_size=128, num_hidden_layers=1,
                  num_attention_heads=4, num_key_value_heads=4, max_position_embeddings=16)
    paddle.seed(0)
    jblock = LlamaDecoderLayer(LlamaConfig(**cfg_kw))
    jblock.eval()
    block = _port_block(jblock, cfg_kw)
    h = np.random.RandomState(0).standard_normal((2, 16, 64)).astype(np.float32) * 0.5
    ref = _np(block(torch.tensor(h)))
    np.testing.assert_allclose(ref, _np(jblock(paddle.to_tensor(h))), rtol=1e-5, atol=1e-5)
    assert TQ.quantize_for_inference(block, algo="weight_only_int8") == 7
    assert JQ.quantize_for_inference(jblock, algo="weight_only_int8") == 7
    got = _np(block(torch.tensor(h)))
    rel = np.abs(got - ref).max() / (np.abs(ref).max() + 1e-9)
    assert rel < 0.05, f"int8 block diverges: rel={rel}"
    np.testing.assert_allclose(got, _np(jblock(paddle.to_tensor(h))), rtol=1e-5, atol=1e-5)


def _quantized_pair(algo, tied, seed):
    """A 2-layer LLaMA of the flagship's shape (GQA heads) quantized in JAX,
    and the port's model from its state."""
    from paddle_tpu.models import LlamaConfig as JConfig, LlamaForCausalLM as JLlama
    from paddle_tpu_torch.models import LlamaConfig, llama_from_numpy

    kw = dict(vocab_size=64, hidden_size=64, intermediate_size=96, num_hidden_layers=2,
              num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=32,
              tie_word_embeddings=tied)
    paddle.seed(seed)
    jm = JLlama(JConfig(**kw))
    jm.eval()
    assert JQ.quantize_for_inference(jm, algo=algo) == 14
    state = _sd(jm)
    assert any(k.endswith(".quant_weight") for k in state)
    tm = llama_from_numpy(state, LlamaConfig(**kw), device="cpu")
    for name, mod in tm.named_modules():
        if name.endswith("_proj"):
            assert isinstance(mod, TQ.WeightOnlyLinear) and mod.algo == algo, name
            np.testing.assert_array_equal(_np(mod.quant_weight), state[name + ".quant_weight"])
    return jm, tm


@pytest.mark.parametrize("algo,tied", [("weight_only_int8", False), ("weight_only_int4", True)])
def test_jax_quantized_llama_carries_across(algo, tied):
    from paddle_tpu.models.llama_decode import LlamaDecodeEngine as JEngine
    from paddle_tpu_torch.models import LlamaDecodeEngine

    jm, tm = _quantized_pair(algo, tied, seed=3)
    ids = np.random.RandomState(4).randint(0, 64, (2, 7))
    np.testing.assert_allclose(_np(tm(torch.tensor(ids))), _np(jm(paddle.to_tensor(ids))),
                               rtol=1e-4, atol=1e-4)
    je, te = JEngine(jm, max_len=24), LlamaDecodeEngine(tm, max_len=24)
    ref = np.asarray(je.generate(ids.astype("int32"), max_new_tokens=8))
    out = te.generate(ids.astype("int32"), max_new_tokens=8).numpy()
    np.testing.assert_array_equal(out, ref)
    # the engine decodes with the dense weights it dequantized at build
    q = tm.llama.layers[0].self_attn.q_proj
    want = TQ.weight_dequantize(q.quant_weight, q.weight_scale, algo, k=q.in_features).t()
    assert torch.equal(te.layers[0]["wq"], want)


def test_llama_from_numpy_refuses_misshapen_buffers():
    from paddle_tpu_torch.models import LlamaConfig, llama_from_numpy

    jm, _ = _quantized_pair("weight_only_int8", False, seed=5)
    state = _sd(jm)
    key = "llama.layers.0.mlp.up_proj.quant_weight"
    state[key] = state[key][:5]
    with pytest.raises(ValueError, match="neither int8 nor int4"):
        llama_from_numpy(state, LlamaConfig(
            vocab_size=64, hidden_size=64, intermediate_size=96, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=32),
            device="cpu")


# -- observers -----------------------------------------------------------------
def _obs_batches():
    r = np.random.RandomState(0)
    a = r.standard_normal((16, 8)).astype(np.float32)
    b = (r.standard_normal((16, 8)) * 3.0).astype(np.float32)
    b[3, 2] = 40.0
    return a, b


@pytest.mark.parametrize("make", [
    lambda Q: Q.AbsmaxObserver(),
    lambda Q: Q.AbsmaxChannelWiseObserver(axis=1),
    lambda Q: Q.AbsmaxChannelWiseObserver(axis=0),
    lambda Q: Q.HistObserver(percent=0.99),
    lambda Q: Q.HistObserver(bins=64, percent=1.0),
    lambda Q: Q.GroupWiseWeightObserver(group_size=4),
    lambda Q: Q.GroupWiseWeightObserver(group_size=5),
], ids=["absmax", "channel_axis1", "channel_axis0", "hist", "hist_rebin", "group4",
        "group5_padded"])
def test_observer_scales_match_jax(make):
    jo, to = make(JQ), make(TQ)
    for batch in _obs_batches():   # the second batch widens the range
        jo.observe(paddle.to_tensor(batch))
        to.observe(torch.tensor(batch))
        j, t = jo.scale(), to.scale()
        if isinstance(j, np.ndarray):
            assert t.dtype == j.dtype
            np.testing.assert_array_equal(t, j)
        else:
            assert t == j
    if hasattr(jo, "cal_thresholds"):
        assert to.cal_thresholds() == jo.cal_thresholds()


def test_observers_take_bfloat16_exactly():
    w = _weight((8, 4), 9)
    jo, to = JQ.AbsmaxChannelWiseObserver(axis=1), TQ.AbsmaxChannelWiseObserver(axis=1)
    jo.observe(paddle.to_tensor(w).astype("bfloat16"))
    to.observe(torch.tensor(w).bfloat16())
    np.testing.assert_array_equal(to.scale(), jo.scale())


# -- quanters ------------------------------------------------------------------
@pytest.mark.parametrize("make", [
    lambda Q: Q.FakeQuanterWithAbsMax(),
    lambda Q: Q.FakeQuanterWithAbsMax(moving_rate=None),
    lambda Q: Q.FakeQuanterWithAbsMax(quant_bits=4, moving_rate=0.5),
    lambda Q: Q.FakeQuanterChannelWiseAbsMax(axis=1),
    lambda Q: Q.FakeQuanterChannelWiseAbsMax(axis=0, quant_bits=4),
], ids=["ema", "running_max", "int4_ema", "channel_axis1", "channel_axis0_int4"])
def test_quanter_three_training_calls_match_jax(make):
    """Outputs, straight-through gradients and running scales after each of
    three training calls, then an eval call."""
    r = np.random.RandomState(1)
    xs = [(r.standard_normal((6, 5)) * s).astype(np.float32) for s in (1.0, 3.0, 0.5)]
    ct = r.standard_normal((6, 5)).astype(np.float32)
    jq, tq = make(JQ), make(TQ)
    jq.train()
    tq.train()
    for x in xs:
        jx = paddle.to_tensor(x, stop_gradient=False)
        tx = torch.tensor(x, requires_grad=True)
        jy, ty = jq(jx), tq(tx)
        np.testing.assert_allclose(_np(ty), _np(jy), rtol=1e-6, atol=1e-6)
        paddle.sum(jy * paddle.to_tensor(ct)).backward()
        (ty * torch.tensor(ct)).sum().backward()
        np.testing.assert_array_equal(_np(tx.grad), ct)
        np.testing.assert_array_equal(_np(tx.grad), _np(jx.grad))
        np.testing.assert_array_equal(np.asarray(tq._scale), np.asarray(jq._scale))
    jq.eval()
    tq.eval()
    x = xs[0] * 2.0
    np.testing.assert_allclose(_np(tq(torch.tensor(x))), _np(jq(paddle.to_tensor(x))),
                               rtol=1e-6, atol=1e-6)


def test_uncalibrated_quanters_warn():
    for Q in (JQ, TQ):
        for q in (Q.FakeQuanterWithAbsMax(), Q.FakeQuanterChannelWiseAbsMax()):
            q.eval()
            with pytest.warns(UserWarning, match="no calibrated scale"):
                q(paddle.ones([2, 3]) if Q is JQ else torch.ones(2, 3))


def test_quant_dequant_matches_jax():
    x = _weight((4, 7), 11, scale=2.0)
    for bits in (8, 4):
        np.testing.assert_allclose(
            _np(TQ.quant_dequant(torch.tensor(x), torch.tensor(1.5), bits=bits)),
            _np(JQ.quant_dequant(paddle.to_tensor(x), paddle.to_tensor(np.float32(1.5)),
                                 bits=bits)), rtol=1e-6, atol=1e-6)


def test_training_quanter_under_to_static_equals_eager():
    """The host read breaks the graph; output and running scale as eager."""
    from paddle_tpu_torch import jit

    torch._dynamo.reset()
    r = np.random.RandomState(2)
    xs = [torch.tensor(r.standard_normal((4, 6)).astype(np.float32) * s) for s in (1, 2, 3)]
    eager, compiled_q = TQ.FakeQuanterWithAbsMax(), TQ.FakeQuanterWithAbsMax()
    eager.train()
    compiled_q.train()
    fn = jit.to_static(lambda x: compiled_q(x) * 2.0, backend="aot_eager", full_graph=False)
    for x in xs:
        np.testing.assert_array_equal(_np(fn(x)), _np(eager(x) * 2.0))
        assert compiled_q._scale == eager._scale
    torch._dynamo.reset()


# -- QAT / PTQ -----------------------------------------------------------------
def _lenet(P):
    return P.nn.Sequential(P.nn.Conv2D(1, 4, 3), P.nn.ReLU(), P.nn.Flatten(),
                           P.nn.Linear(4 * 6 * 6, 16), P.nn.ReLU(), P.nn.Linear(16, 4))


def _quanters(model, cls):
    return [m for m in model.sublayers(include_self=True) if isinstance(m, cls)]


def test_qat_lenet_three_steps_match_jax():
    """tests/test_quantization.py TestQATLeNet's net and data, the JAX
    weights carried over: three Adam steps, losses and every scale."""
    r = np.random.RandomState(0)
    x = r.standard_normal((64, 1, 8, 8)).astype(np.float32)
    y = r.randint(0, 4, (64,)).astype(np.int64)
    paddle.seed(0)
    jm, tm = JQ.QAT().quantize(_lenet(paddle)), TQ.QAT().quantize(_lenet(T))
    carry(jm, tm)
    assert list(_sd(tm)) == list(_sd(jm))
    losses = []
    for P, m in ((paddle, jm), (T, tm)):
        opt = P.optimizer.Adam(learning_rate=5e-3, parameters=m.parameters())
        ce = P.nn.CrossEntropyLoss()
        m.train()
        run = []
        for _ in range(3):
            loss = ce(m(P.to_tensor(x, place="cpu")), P.to_tensor(y, place="cpu"))
            loss.backward()
            opt.step()
            opt.clear_grad()
            run.append(float(_np(loss)))
        losses.append(run)
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-5, atol=1e-6)
    jqs, tqs = _quanters(jm, JQ.FakeQuanterWithAbsMax), _quanters(tm, TQ.FakeQuanterWithAbsMax)
    assert len(tqs) == len(jqs) == 6
    for a, b in zip(tqs, jqs):
        np.testing.assert_allclose(a._scale, b._scale, rtol=1e-5)
    for k, v in _sd(jm).items():
        np.testing.assert_allclose(_sd(tm)[k], v, rtol=1e-4, atol=1e-5, err_msg=k)
    TQ.QAT().convert(tm)
    assert not any(q.training for q in tqs)


def test_qat_convert_freezes_only_the_per_tensor_quanters():
    for P, Q in ((paddle, JQ), (T, TQ)):
        cfg = Q.QuantConfig(weight=lambda Q=Q: Q.FakeQuanterChannelWiseAbsMax(axis=1))
        model = Q.QAT(cfg).quantize(P.nn.Sequential(P.nn.Linear(4, 3)))
        model.train()
        model(P.to_tensor(np.ones((2, 4), np.float32), place="cpu"))
        Q.QAT().convert(model)
        wrapper = model[0]
        assert not wrapper.act_quanter.training
        assert wrapper.weight_quanter.training


def test_quanted_wrapper_leaves_the_parameter_untouched():
    T.seed(0)
    lin = T.nn.Linear(4, 3)
    w0 = lin.weight.detach().clone()
    model = TQ.QAT().quantize(T.nn.Sequential(lin))
    model.train()
    out = model(torch.tensor(_weight((2, 4), 12)))
    assert torch.equal(lin.weight, w0)
    out.sum().backward()
    assert lin.weight.grad is not None and lin.bias.grad is not None


def test_quant_config_type_overrides():
    for P, Q in ((paddle, JQ), (T, TQ)):
        cfg = Q.QuantConfig()
        cfg.add_type_config(P.nn.Linear, weight=lambda Q=Q: Q.FakeQuanterChannelWiseAbsMax())
        assert cfg.quantable_types() == (P.nn.Linear,)
        model = Q.QAT(cfg).quantize(P.nn.Sequential(P.nn.Linear(4, 3), P.nn.Conv2D(1, 1, 1)))
        assert isinstance(model[0].weight_quanter, Q.FakeQuanterChannelWiseAbsMax)
        assert isinstance(model[1], P.nn.Conv2D)
        with pytest.raises(ValueError, match="no quantable"):
            Q.QAT().quantize(P.nn.Sequential(P.nn.ReLU()))


def test_ptq_calibrate_matches_jax():
    r = np.random.RandomState(3)
    batches = [r.standard_normal((4, 8)).astype(np.float32) * s for s in (1.0, 4.0, 2.0)]
    paddle.seed(0)
    models = []
    for P, Q in ((paddle, JQ), (T, TQ)):
        models.append(Q.PTQ().quantize(P.nn.Sequential(P.nn.Linear(8, 4), P.nn.ReLU(),
                                                       P.nn.Linear(4, 2))))
    carry(*models)
    for (P, Q), m in zip(((paddle, JQ), (T, TQ)), models):
        Q.PTQ().calibrate(m, [P.to_tensor(b, place="cpu") for b in batches], steps=2)
    jqs = _quanters(models[0], JQ.FakeQuanterWithAbsMax)
    tqs = _quanters(models[1], TQ.FakeQuanterWithAbsMax)
    for a, b in zip(tqs, jqs):
        np.testing.assert_allclose(a._scale, b._scale, rtol=1e-6)
        assert not a.training
    # the running max keeps the larger of the two batches
    assert tqs[0]._scale == pytest.approx(float(np.abs(batches[1]).max()), rel=1e-6)


def test_quanter_registration_and_refusal():
    @TQ.quanter("TorchTestQuanterA")
    class _MyQuanter(TQ.BaseQuanter):
        def __init__(self, bits=8):
            super().__init__()
            self.bits = bits

        def forward(self, x):
            return x

    factory = TQ.TorchTestQuanterA(bits=4)
    assert isinstance(factory, TQ.QuanterFactory) and repr(factory) == "QuanterFactory(_MyQuanter)"
    q = factory()
    assert isinstance(q, _MyQuanter) and q.bits == 4 and factory.instance().bits == 4
    assert globals()["TorchTestQuanterA"] is TQ.TorchTestQuanterA
    cfg = TQ.QuantConfig(activation=factory, weight=factory)
    model = TQ.QAT(cfg).quantize(T.nn.Sequential(T.nn.Linear(2, 2)))
    assert isinstance(model[0].act_quanter, _MyQuanter)
    with pytest.raises(ValueError, match="already exports"):
        TQ.quanter("TorchTestQuanterA")(_MyQuanter)
    with pytest.raises(ValueError, match="already exports"):
        TQ.quanter("QAT")(_MyQuanter)
    base = TQ.BaseObserver()
    assert base.quant_axis() == -1 and base.bit_length() == 8
    for call in (base.scales, base.zero_points, base.cal_thresholds):
        with pytest.raises(NotImplementedError):
            call()


def test_nn_quant():
    w = _weight((16, 8), 13)
    x = _weight((3, 16), 14)
    tq, ts = T.nn.quant.weight_quantize(torch.tensor(w))
    jq, js = paddle.nn.quant.weight_quantize(paddle.to_tensor(w))
    np.testing.assert_allclose(
        _np(T.nn.quant.llm_int8_linear(torch.tensor(x), tq, weight_scale=ts, threshold=1.0)),
        _np(paddle.nn.quant.llm_int8_linear(paddle.to_tensor(x), jq, weight_scale=js)),
        rtol=RTOL, atol=ATOL)
    stub = T.nn.quant.Stub()
    assert isinstance(stub, T.nn.Layer) and stub(torch.tensor(x)) is not None
    assert torch.equal(stub(torch.tensor(x)), torch.tensor(x))
    assert sorted(T.nn.quant.__all__) == sorted(paddle.nn.quant.__all__)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        T.nn.quant.weight_dequantize(tq, ts)
