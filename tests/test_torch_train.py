"""Training with the PyTorch port against the JAX package: cross-entropy,
and AdamW steps on the tiny LLaMA from the same weights and batches.

The JAX side trains eagerly (``loss.backward()``, ``opt.step()``,
``opt.clear_grad()``) on its CPU math path; the port runs its plain versions
on the CPU. Inputs come from numpy seeds; weights go through numpy.
"""
import copy

import numpy as np
import pytest

import torch

import paddle_tpu as paddle
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.nn.functional import cross_entropy as jax_ce
from paddle_tpu.nn.functional import softmax_with_cross_entropy as jax_swce
from paddle_tpu_torch.models import LlamaConfig, llama_from_numpy, llama_to_numpy
from paddle_tpu_torch.nn.functional import cross_entropy, softmax_with_cross_entropy
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.optimizer import Adam, AdamW
from paddle_tpu_torch.optimizer import lr as tlr

_CFG = dict(vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=32)
_STEPS = 3


def _batch(seed, shape=(2, 8)):
    r = np.random.RandomState(seed)
    ids = r.randint(0, 64, shape).astype("int64")
    labels = r.randint(0, 64, shape).astype("int64")
    labels[r.rand(*shape) < 0.25] = -100
    return ids, labels


def _models(dtype="float32", seed=0):
    paddle.seed(seed)
    jm = JaxLlama(JaxConfig(**_CFG))
    if dtype != "float32":
        jm.to(dtype=dtype)
    jm.train()
    state = {k: np.asarray(v.numpy()).astype(np.float32) for k, v in jm.state_dict().items()}
    tm = llama_from_numpy(state, LlamaConfig(dtype=dtype, **_CFG), device="cpu")
    tm.train()
    return jm, tm


def _train(jm, tm, jopt, topt, batches):
    """Run both; return (JAX losses, port losses)."""
    jl, tl = [], []
    for ids, labels in batches:
        loss, _ = jm(paddle.to_tensor(ids), labels=paddle.to_tensor(labels))
        loss.backward()
        jopt.step()
        jopt.clear_grad()
        jl.append(float(np.asarray(loss.numpy(), np.float32)))
        loss, _ = tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
        loss.backward()
        topt.step()
        topt.clear_grad()
        tl.append(loss.item())
    return jl, tl


def _jax_params(jm):
    return {n: np.asarray(p.numpy()).astype(np.float32) for n, p in jm.named_parameters()}


class TestCrossEntropy:
    @pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
    def test_matches_jax(self, reduction):
        r = np.random.RandomState(0)
        logits = r.randn(3, 5, 11).astype(np.float32)
        labels = r.randint(0, 11, (3, 5)).astype("int64")
        labels[0, :2] = -100
        ref = np.asarray(jax_ce(paddle.to_tensor(logits), paddle.to_tensor(labels),
                                reduction=reduction).numpy())
        out = cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                            reduction=reduction).numpy()
        np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)

    def test_all_ignored_mean_is_zero(self):
        logits = torch.randn(2, 4, 7)
        labels = torch.full((2, 4), -100)
        assert cross_entropy(logits, labels).item() == 0.0

    def test_softmax_with_cross_entropy_keeps_a_unit_axis(self):
        r = np.random.RandomState(1)
        logits = r.randn(2, 6, 9).astype(np.float32)
        labels = r.randint(0, 9, (2, 6, 1)).astype("int64")
        labels[1, 2, 0] = -100
        ref = np.asarray(jax_swce(paddle.to_tensor(logits), paddle.to_tensor(labels)).numpy())
        out = softmax_with_cross_entropy(torch.from_numpy(logits),
                                         torch.from_numpy(labels)).numpy()
        assert out.shape == ref.shape == (2, 6, 1)
        np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


class TestAdamWMatchesJax:
    # fp32 on both sides; tolerance 1e-4 on the loss at every step and every
    # parameter after the last step
    def _run(self, jax_kw=lambda jm: {}, port_kw=lambda tm: {}, named=False):
        jm, tm = _models()
        jopt = paddle.optimizer.AdamW(learning_rate=1e-3, parameters=jm.parameters(),
                                      **jax_kw(jm))
        params = tm.named_parameters() if named else tm.parameters()
        topt = AdamW(learning_rate=1e-3, parameters=params, **port_kw(tm))
        jl, tl = _train(jm, tm, jopt, topt, [_batch(s) for s in range(_STEPS)])
        np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-4)
        ref, out = _jax_params(jm), llama_to_numpy(tm)
        for name, p in ref.items():
            np.testing.assert_allclose(out[name], p, rtol=1e-4, atol=1e-4, err_msg=name)

    def test_three_steps(self):
        self._run()

    def test_decay_excluding_the_norms(self):
        # weight_decay 0.5 moves a norm weight (1.0) by lr * wd = 5e-4 a step,
        # well above the tolerance, so decaying the norms would not pass
        def jax_kw(jm):
            # the JAX optimizer passes each parameter's generated name
            norms = {p.name for n, p in jm.named_parameters() if "norm" in n}
            return dict(weight_decay=0.5, apply_decay_param_fun=lambda n: n not in norms)

        self._run(jax_kw=jax_kw,
                  port_kw=lambda tm: dict(weight_decay=0.5,
                                          apply_decay_param_fun=lambda n: "norm" not in n),
                  named=True)

    def test_decay_by_generated_names(self):
        # the paddle idiom on both sides: model.parameters(), and a function
        # of each parameter's generated name (the norms' names excluded)
        def kw(model):
            norms = {p.name for n, p in model.named_parameters() if "norm" in n}
            return dict(weight_decay=0.5, apply_decay_param_fun=lambda n: n not in norms)

        self._run(jax_kw=kw, port_kw=kw)

    def test_decay_fun_needs_names(self):
        # a tensor without a name (a plain torch parameter) has nothing to
        # call the function with
        with pytest.raises(ValueError, match="without a name"):
            AdamW(parameters=[torch.nn.Parameter(torch.zeros(3))],
                  apply_decay_param_fun=lambda n: True)


class TestHeadDims96And256:
    """Three AdamW steps at Phi-3-mini's head dim (hidden 192, 2 heads: D =
    96) and Gemma-2B's (hidden 512, 2 heads, 1 KV head: D = 256), the second
    with the fused head as the Gemma-width step on the card runs it: losses
    at every step and every parameter after the last, fp32, 1e-4 (as
    TestAdamWMatchesJax)."""

    @pytest.mark.parametrize("hidden,kv,fused", [(192, 2, False), (512, 1, True)],
                             ids=["d96", "d256_fused_head"])
    def test_three_steps(self, hidden, kv, fused):
        cfg = dict(_CFG, hidden_size=hidden, num_attention_heads=2, num_key_value_heads=kv)
        paddle.seed(hidden)
        jm = JaxLlama(JaxConfig(fused_head_ce=fused, **cfg))
        jm.train()
        state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
        tm = llama_from_numpy(state, LlamaConfig(fused_head_ce=fused, **cfg), device="cpu")
        tm.train()
        assert tm.config.head_dim == hidden // 2
        jopt = paddle.optimizer.AdamW(learning_rate=1e-3, parameters=jm.parameters())
        topt = AdamW(learning_rate=1e-3, parameters=tm.parameters())
        jl, tl = _train(jm, tm, jopt, topt, [_batch(s + hidden) for s in range(_STEPS)])
        np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-4)
        out = llama_to_numpy(tm)
        for name, p in _jax_params(jm).items():
            np.testing.assert_allclose(out[name], p, rtol=1e-4, atol=1e-4, err_msg=name)


class TestParameterNames:
    def test_generated_names_survive_to_and_deepcopy(self):
        _, tm = _models()
        names = [p.name for p in tm.parameters()]
        assert all(n.startswith("param_") and n[6:].isdigit() for n in names)
        assert len(set(names)) == len(names)
        # one process-wide counter: a later model's names come after
        _, later = _models()
        assert min(int(p.name[6:]) for p in later.parameters()) > max(int(n[6:]) for n in names)
        tm.to(torch.float64)
        assert [p.name for p in tm.parameters()] == names
        assert {p.dtype for p in tm.parameters()} == {torch.float64}
        twin = copy.deepcopy(tm)
        assert [p.name for p in twin.parameters()] == names
        for a, b in zip(twin.parameters(), tm.parameters()):
            assert a.data_ptr() != b.data_ptr() and torch.equal(a, b)
            assert isinstance(a, torch.nn.Parameter) and a.requires_grad

    def test_names_change_no_tensor(self):
        # the state dict and the gradients are the same plain tensors as
        # before the names
        _, tm = _models()
        state = tm.state_dict()
        assert all(type(t) is torch.Tensor for t in state.values())
        loss, _ = tm(*(torch.from_numpy(a) for a in _batch(0)))
        loss.backward()
        assert all(type(p.grad) is torch.Tensor for p in tm.parameters())


class TestMultiPrecision:
    def test_bf16_masters(self):
        jm, tm = _models(dtype="bfloat16")
        assert {p.dtype for p in tm.parameters()} == {torch.bfloat16}
        jopt = paddle.optimizer.AdamW(learning_rate=1e-3, parameters=jm.parameters(),
                                      multi_precision=True)
        topt = AdamW(learning_rate=1e-3, parameters=tm.parameters(), multi_precision=True)
        jl, tl = _train(jm, tm, jopt, topt, [_batch(s) for s in range(_STEPS)])
        for p in tm.parameters():
            master = topt._master_weights[id(p)]
            assert master.dtype == torch.float32 and master.shape == p.shape
            assert torch.equal(p, master.to(torch.bfloat16))
            st = topt._accumulators[id(p)]
            assert st["moment1"].dtype == st["moment2"].dtype == torch.float32
        # the loss is bfloat16 on both sides (the logits' dtype): a bf16 step
        # is 2**-7 relative at most, and the two frameworks round the forward
        # at other places, so they may land two steps apart
        np.testing.assert_allclose(tl, jl, rtol=2 ** -6, atol=0)

    def test_fp32_parameters_have_no_master(self):
        _, tm = _models()
        opt = AdamW(parameters=tm.parameters(), multi_precision=True)
        loss, _ = tm(*(torch.from_numpy(a) for a in _batch(0)))
        loss.backward()
        opt.step()
        assert opt._master_weights == {}


class TestUnported:
    """The options that raised ``NotImplementedError`` before the optimizer
    surface was ported: each now trains the tiny LLaMA as the JAX package
    does (the names are kept from when they raised)."""

    @pytest.mark.parametrize("kw", [
        dict(learning_rate=lambda lr: lr.StepDecay(1e-3, step_size=2)),
        dict(grad_clip=lambda nn_: nn_.ClipGradByGlobalNorm(1.0)),
        dict(amsgrad=True),
    ])
    def test_optimizer_options_raise(self, kw):
        def built(mod, lr, nn_):
            return {k: v(lr if k == "learning_rate" else nn_) if callable(v) else v
                    for k, v in kw.items()}

        kw_jax = built(paddle.optimizer, paddle.optimizer.lr, paddle.nn)
        kw_port = built(None, tlr, tnn)
        jm, tm = _models()
        jopt = paddle.optimizer.AdamW(parameters=jm.parameters(), **kw_jax)
        topt = AdamW(parameters=tm.parameters(), **kw_port)
        jl, tl = _train(jm, tm, jopt, topt, [_batch(s) for s in range(_STEPS)])
        np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-4)

    def test_adam_coupled_decay_raises(self):
        jm, tm = _models()
        jopt = paddle.optimizer.Adam(learning_rate=1e-3, parameters=jm.parameters(),
                                     weight_decay=0.5)
        topt = Adam(learning_rate=1e-3, parameters=tm.parameters(), weight_decay=0.5)
        jl, tl = _train(jm, tm, jopt, topt, [_batch(s) for s in range(_STEPS)])
        np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-4)
        ref, out = _jax_params(jm), llama_to_numpy(tm)
        for name, p in ref.items():
            np.testing.assert_allclose(out[name], p, rtol=1e-4, atol=1e-4, err_msg=name)

    def test_soft_labels_raise(self):
        r = np.random.RandomState(3)
        logits = r.randn(2, 5).astype(np.float32)
        soft = r.dirichlet(np.ones(5), size=2).astype(np.float32)
        ref = np.asarray(jax_swce(paddle.to_tensor(logits), paddle.to_tensor(soft),
                                  soft_label=True).numpy())
        out = softmax_with_cross_entropy(torch.from_numpy(logits), torch.from_numpy(soft),
                                         soft_label=True).numpy()
        assert out.shape == ref.shape == (2,)
        np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


class TestCrossEntropyOptions:
    """The cross-entropy options against the JAX functions (as
    tests/test_nn.py:126 exercises them): soft labels, class weights, label
    smoothing (with hard and with soft labels), ``use_softmax=False``,
    ``softmax_with_cross_entropy`` and ``nll_loss``; fp32 at 1e-6, and the
    gradient of the logits at 1e-5."""

    def _inputs(self, seed, soft=False):
        r = np.random.RandomState(seed)
        logits = r.randn(3, 5, 7).astype(np.float32)
        if soft:
            label = r.dirichlet(np.ones(7), size=(3, 5)).astype(np.float32)
        else:
            label = r.randint(0, 7, (3, 5)).astype("int64")
            label[0, :2] = -100
        weight = r.rand(7).astype(np.float32) + 0.5
        return logits, label, weight

    def _both(self, fn_jax, fn_port, logits, label, **kw):
        jl = paddle.to_tensor(logits, stop_gradient=False)
        ref = fn_jax(jl, paddle.to_tensor(label),
                     **{k: paddle.to_tensor(v) if isinstance(v, np.ndarray) else v
                        for k, v in kw.items()})
        tl = torch.tensor(logits, requires_grad=True)
        out = fn_port(tl, torch.from_numpy(label),
                      **{k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
                         for k, v in kw.items()})
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref.numpy()), rtol=1e-6,
                                   atol=1e-6)
        ref.sum().backward()
        out.sum().backward()
        np.testing.assert_allclose(tl.grad.numpy(), np.asarray(jl.grad.numpy()), rtol=1e-5,
                                   atol=1e-6)

    @pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
    @pytest.mark.parametrize("opts", [
        dict(weight=True), dict(label_smoothing=0.1), dict(weight=True, label_smoothing=0.2),
        dict(soft_label=True), dict(soft_label=True, label_smoothing=0.1),
    ], ids=["weight", "smoothing", "weight_smoothing", "soft", "soft_smoothing"])
    def test_options_match_jax(self, opts, reduction):
        opts = dict(opts)
        logits, label, weight = self._inputs(5, soft=opts.get("soft_label", False))
        if opts.pop("weight", False):
            opts["weight"] = weight
        self._both(jax_ce, cross_entropy, logits, label, reduction=reduction, **opts)

    @pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
    @pytest.mark.parametrize("weighted", [False, True], ids=["plain", "weighted"])
    def test_probabilities_match_jax(self, weighted, reduction):
        r = np.random.RandomState(6)
        probs = r.dirichlet(np.ones(6), size=8).astype(np.float32)
        label = r.randint(0, 6, 8).astype("int64")
        label[2] = -100
        kw = dict(use_softmax=False, reduction=reduction)
        if weighted:
            kw["weight"] = r.rand(6).astype(np.float32) + 0.5
        self._both(jax_ce, cross_entropy, probs, label, **kw)

    def test_nll_loss_matches_jax(self):
        from paddle_tpu.nn.functional import nll_loss as jax_nll
        from paddle_tpu_torch.nn.functional import nll_loss

        r = np.random.RandomState(7)
        logp = np.log(r.dirichlet(np.ones(4), size=6)).astype(np.float32)
        label = r.randint(0, 4, 6).astype("int64")
        self._both(jax_nll, nll_loss, logp, label, weight=r.rand(4).astype(np.float32))

    def test_softmax_with_cross_entropy_soft_labels_match_jax(self):
        logits, soft, _ = self._inputs(8, soft=True)
        self._both(jax_swce, softmax_with_cross_entropy, logits, soft, soft_label=True)

    def test_smoothing_raises_the_loss(self):
        # tests/test_nn.py:126's check, on the port
        r = np.random.RandomState(9)
        logits = torch.from_numpy(r.rand(4, 5).astype(np.float32))
        label = torch.tensor([0, -100, 2, -100])
        p = torch.softmax(logits, -1)
        expect = -torch.log(p[[0, 2], [0, 2]]).mean()
        torch.testing.assert_close(cross_entropy(logits, label, ignore_index=-100), expect)
        assert cross_entropy(logits, torch.tensor([0, 1, 2, 3]), label_smoothing=0.1) > 0
