"""The port's MoE layer (paddle_tpu_torch/incubate/distributed) and the MoE
LLaMA against the JAX package's, on the CPU.

The routing (expert ids, kept mask and the slot of every kept token) is held
to the JAX ``_topk_dispatch`` bit for bit, under capacity pressure and with
tied logits. ``MoELayer`` outputs, the gate's aux loss and every gradient
(router included) are held to the JAX layer at float32 rtol 1e-5 / atol 1e-6
for each gate, with random routing off or in eval (the JAX test's own bar is
1e-4 / 1e-5). The MoE LLaMA's logits, loss with aux and every gradient by
JAX name go through ``llama_from_numpy``/``llama_to_numpy`` at
test_torch_llama.py's 1e-4. Random routing draws from torch's generator, so
it is held to its law (the second choice kept with probability min(1, 2w))
and to itself under recompute.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as T
from paddle_tpu.incubate.distributed.models import moe as jmoe
from paddle_tpu.incubate.distributed.models.moe.gate import _topk_dispatch as jax_dispatch
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch.incubate.distributed.models import moe as tmoe
from paddle_tpu_torch.incubate.distributed.models.moe.gate import _topk_dispatch
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM, llama_from_numpy, llama_to_numpy
from paddle_tpu_torch.models.llama import LlamaMoEMLP
from test_torch_ops import _np, _on_cpu  # noqa: F401

RTOL, ATOL = 1e-5, 1e-6
LLAMA_TOL = 1e-4


# -- routing ----------------------------------------------------------------
def _jax_routing(logits, top_k, capacity):
    dispatch, _, topi, kept = jax_dispatch(paddle.to_tensor(logits), None, top_k=top_k,
                                           capacity=capacity)
    dispatch, topi, kept = _np(dispatch), _np(topi), _np(kept).astype(bool)
    T_, K = topi.shape
    slot = np.full((T_, K), -1)
    for t in range(T_):
        for k in range(K):
            if kept[t, k]:
                slot[t, k] = int(np.argmax(dispatch[t, topi[t, k]]))
    return topi, kept, slot


def _port_routing(logits, top_k, capacity):
    slot, _, topi, kept = _topk_dispatch(torch.from_numpy(logits), top_k=top_k,
                                         capacity=capacity)
    kept = kept.numpy()
    return topi.numpy(), kept, np.where(kept, slot.numpy(), -1)


def _logits(kind, seed, T_=96, E=8):
    r = np.random.RandomState(seed)
    if kind == "random":
        return r.randn(T_, E).astype(np.float32)
    if kind == "tied":
        # a few distinct values a row: top-k ties broken by the lower index
        return r.randint(0, 3, (T_, E)).astype(np.float32)
    return np.zeros((T_, E), np.float32)  # every expert tied on every row


class TestRouting:
    @pytest.mark.parametrize("kind", ["random", "tied", "flat"])
    @pytest.mark.parametrize("top_k,capacity", [(2, 96), (2, 15), (2, 3), (1, 96), (1, 9),
                                                (3, 20)])
    def test_topi_kept_and_slots_bit_for_bit(self, kind, top_k, capacity):
        logits = _logits(kind, 7 * top_k + capacity)
        ref = _jax_routing(logits, top_k, capacity)
        got = _port_routing(logits, top_k, capacity)
        for name, a, b in zip(("topi", "kept", "slot"), got, ref):
            np.testing.assert_array_equal(a, b, err_msg=name)

    def test_capacity_pressure_drops_second_choices_first(self):
        logits = _logits("random", 3)
        _, kept, _ = _port_routing(logits, 2, 15)
        assert kept[:, 1].sum() < kept[:, 0].sum()
        assert not kept.all()

    def test_random_routing_keeps_second_choice_at_min_1_2w(self):
        # a fixed batch of logits, many draws: the second choice of token t
        # survives with probability min(1, 2 * w2[t])
        logits = torch.from_numpy(np.random.RandomState(0).randn(512, 8).astype(np.float32))
        w2 = torch.softmax(logits, -1).sort(-1, descending=True).values[:, 1]
        want = torch.clamp(2.0 * w2, max=1.0)
        torch.manual_seed(0)
        draws = 200
        kept = sum(_topk_dispatch(logits, top_k=2, capacity=1024, sample=True)[3][:, 1].float()
                   for _ in range(draws)) / draws
        se = torch.sqrt(want * (1 - want) / draws).mean()
        assert abs(float(kept.mean() - want.mean())) < 4 * float(se) / np.sqrt(512) + 1e-3
        # per token, within 5 standard errors
        tok_se = torch.sqrt(want * (1 - want) / draws) + 1e-3
        assert bool(((kept - want).abs() <= 5 * tok_se).all())


# -- MoELayer ---------------------------------------------------------------
class _JaxExpert(paddle.nn.Layer):
    def __init__(self, d_model, d_hidden):
        super().__init__()
        self.htoh4 = paddle.nn.Linear(d_model, d_hidden)
        self.h4toh = paddle.nn.Linear(d_hidden, d_model)

    def forward(self, x):
        return self.h4toh(paddle.nn.functional.relu(self.htoh4(x)))


class _PortExpert(T.nn.Layer):
    def __init__(self, d_model, d_hidden):
        super().__init__()
        self.htoh4 = T.nn.Linear(d_model, d_hidden)
        self.h4toh = T.nn.Linear(d_hidden, d_model)

    def forward(self, x):
        return self.h4toh(T.nn.functional.relu(self.htoh4(x)))


GATES = {
    "naive": lambda P, m, d, E: m.NaiveGate(d, E, topk=2),
    "naive_top1": lambda P, m, d, E: m.NaiveGate(d, E, topk=1),
    "gshard": lambda P, m, d, E: m.GShardGate(d, E, random_routing=False),
    "gshard_tight": lambda P, m, d, E: m.GShardGate(d, E, capacity=(0.5, 0.75),
                                                    random_routing=False),
    "switch_no_noise": lambda P, m, d, E: m.SwitchGate(d, E, switch_eps=0.0),
    "switch": lambda P, m, d, E: m.SwitchGate(d, E),
}


def _moe_pair(gate, d=8, hidden=16, E=4, seed=0, recompute_interval=0):
    paddle.seed(seed)
    jl = jmoe.MoELayer(d, paddle.nn.LayerList([_JaxExpert(d, hidden) for _ in range(E)]),
                       gate=GATES[gate](paddle, jmoe, d, E))
    tl = tmoe.MoELayer(d, T.nn.LayerList([_PortExpert(d, hidden) for _ in range(E)]),
                       gate=GATES[gate](T, tmoe, d, E), recompute_interval=recompute_interval)
    missing, unexpected = tl.set_state_dict({k: _np(v) for k, v in jl.state_dict().items()})
    assert missing == [] and unexpected == []
    return jl, tl


def _run(P, layer, x, ct, training):
    layer.train() if training else layer.eval()
    xt = P.to_tensor(x, place="cpu", stop_gradient=False) if P is T else \
        paddle.to_tensor(x, stop_gradient=False)
    out = layer(xt)
    loss = (out * P.to_tensor(ct)).sum()
    aux = layer.gate.get_loss()
    if aux is not None:
        loss = loss + aux
    loss.backward()
    grads = {n: _np(p.grad) for n, p in layer.named_parameters()}
    return _np(out), None if aux is None else float(_np(aux)), _np(xt.grad), grads


class TestMoELayer:
    @pytest.mark.parametrize("gate,training", [
        ("naive", True), ("naive", False), ("naive_top1", True), ("gshard", True),
        ("gshard", False), ("gshard_tight", True), ("switch_no_noise", True),
        ("switch", False)])
    def test_outputs_aux_and_every_gradient_match(self, gate, training):
        jl, tl = _moe_pair(gate)
        r = np.random.RandomState(1)
        x = r.randn(2, 24, 8).astype(np.float32)
        ct = r.randn(2, 24, 8).astype(np.float32)
        ref = _run(paddle, jl, x, ct, training)
        got = _run(T, tl, x, ct, training)
        np.testing.assert_allclose(got[0], ref[0], rtol=RTOL, atol=ATOL)
        assert (got[1] is None) == (ref[1] is None)
        if ref[1] is not None:
            np.testing.assert_allclose(got[1], ref[1], rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got[2], ref[2], rtol=RTOL, atol=ATOL)
        assert set(got[3]) == set(ref[3])
        for name, g in ref[3].items():
            np.testing.assert_allclose(got[3][name], g, rtol=RTOL, atol=ATOL, err_msg=name)

    def test_counts_sum_to_kept_slots(self):
        _, tl = _moe_pair("gshard_tight")
        tl.train()
        x = torch.randn(40, 8, generator=torch.Generator().manual_seed(0))
        tl(x)
        _, slot, topi, kept = tl.route(x)
        assert sum(tl.last_counts) == int(kept.sum())
        assert tl.last_counts == torch.bincount(topi[kept], minlength=4).tolist()

    def test_recompute_interval_gives_the_same_gradients(self):
        _, plain = _moe_pair("gshard")
        _, rc = _moe_pair("gshard", recompute_interval=1)
        r = np.random.RandomState(2)
        x, ct = r.randn(32, 8).astype(np.float32), r.randn(32, 8).astype(np.float32)
        a, b = _run(T, plain, x, ct, True), _run(T, rc, x, ct, True)
        np.testing.assert_array_equal(a[0], b[0])
        for n in a[3]:
            np.testing.assert_allclose(b[3][n], a[3][n], rtol=1e-6, atol=1e-7, err_msg=n)

    def test_gate_names_and_errors(self):
        d, E = 8, 4
        experts = [_PortExpert(d, 16) for _ in range(E)]
        assert isinstance(tmoe.MoELayer(d, experts, gate="switch").gate, tmoe.SwitchGate)
        assert tmoe.MoELayer(d, experts, gate="naive").top_k == 2
        with pytest.raises(ValueError, match="unknown gate"):
            tmoe.MoELayer(d, experts, gate={"type": "nope"})
        with pytest.raises(TypeError, match="LayerList"):
            tmoe.MoELayer(d, experts[0])
        with pytest.raises(ValueError, match="topk=2"):
            tmoe.GShardGate(d, E, topk=1)
        with pytest.raises(NotImplementedError, match="Queue A item 10"):
            tmoe.MoELayer(d, experts, mesh=object())

    @pytest.mark.parametrize("gate,T_,train,want", [
        ("naive", 100, True, 100), ("gshard", 100, True, 60), ("gshard", 100, False, 120),
        ("switch", 100, True, 30)])
    def test_capacity_for(self, gate, T_, train, want):
        g = GATES[gate](T, tmoe, 8, 4)
        jg = GATES[gate](paddle, jmoe, 8, 4)
        assert g.capacity_for(T_, train) == jg.capacity_for(T_, train) == want


class TestClipGradForMoE:
    @pytest.mark.parametrize("clip", [0.1, 100.0])
    def test_matches_jax(self, clip):
        r = np.random.RandomState(0)
        gs = [r.randn(4, 3).astype(np.float32), None, r.randn(5).astype(np.float32)]
        ref = jmoe.ClipGradForMOEByGlobalNorm(clip)(
            [(None, None if g is None else paddle.to_tensor(g)) for g in gs])
        got = tmoe.ClipGradForMOEByGlobalNorm(clip)(
            [(None, None if g is None else torch.from_numpy(g)) for g in gs])
        for (_, a), (_, b) in zip(got, ref):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_allclose(_np(a), _np(b), rtol=RTOL, atol=ATOL)

    def test_no_gradients_pass_through(self):
        pairs = [(None, None)]
        assert tmoe.ClipGradForMOEByGlobalNorm(1.0)(pairs) is pairs


# -- the MoE LLaMA ----------------------------------------------------------
_CFG = dict(vocab_size=64, hidden_size=32, intermediate_size=48, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=32,
            num_experts=4, moe_topk=2)


def _set_routing(model, gate_kind, P):
    """Random routing off (GShard) and no noise (Switch), so both packages
    route the same tokens in training."""
    for m in model.sublayers() if P is paddle else model.modules():
        if isinstance(m, (jmoe.GShardGate, tmoe.GShardGate)):
            m.random_routing = False
        if isinstance(m, (jmoe.SwitchGate, tmoe.SwitchGate)):
            m.switch_eps = 0.0


def _llama_pair(gate="gshard", recompute=False, every=1, fused=False, topk=2, seed=0):
    paddle.seed(seed)
    kw = dict(_CFG, moe_gate=gate, moe_every_k=every, moe_topk=topk, recompute=recompute,
              fused_head_ce=fused)
    jm = JaxLlama(JaxConfig(**kw))
    state = {k: _np(v) for k, v in jm.state_dict().items()}
    cfg = LlamaConfig(**kw)
    tm = llama_from_numpy(state, cfg, device="cpu")
    _set_routing(jm, gate, paddle)
    _set_routing(tm, gate, T)
    return jm, tm, state


def _ids(seed, shape=(2, 12)):
    return np.random.RandomState(seed).randint(0, 64, shape).astype("int64")


class TestMoELlama:
    def test_state_dict_names_and_order_round_trip(self):
        jm, tm, state = _llama_pair(every=2)
        got = llama_to_numpy(tm)
        assert list(got) == list(state)
        for k, v in state.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        assert isinstance(tm.llama.layers[0].mlp, LlamaMoEMLP)
        assert not isinstance(tm.llama.layers[1].mlp, LlamaMoEMLP)
        # the router in paddle's (in, out) layout, the experts transposed
        gate = tm.llama.layers[0].mlp.moe.gate.gate
        np.testing.assert_array_equal(
            gate.weight.detach().numpy(), state["llama.layers.0.mlp.moe.gate.gate.weight"])
        np.testing.assert_array_equal(
            tm.llama.layers[0].mlp.moe.experts[1].up_proj.weight.detach().numpy(),
            state["llama.layers.0.mlp.moe.experts.1.up_proj.weight"].T)

    @pytest.mark.parametrize("gate", ["naive", "gshard", "switch"])
    def test_eval_logits_match(self, gate):
        jm, tm, _ = _llama_pair(gate, topk=1 if gate == "switch" else 2)
        ids = _ids(1)
        jm.eval()
        ref = _np(jm(paddle.to_tensor(ids)))
        got = _np(tm(torch.from_numpy(ids)))
        np.testing.assert_allclose(got, ref, rtol=LLAMA_TOL, atol=LLAMA_TOL)

    @pytest.mark.parametrize("gate,recompute,every,fused,topk", [
        ("naive", False, 1, False, 2), ("gshard", False, 1, False, 2),
        ("gshard", True, 1, False, 2), ("gshard", False, 2, False, 2),
        ("gshard", True, 2, True, 2), ("switch", False, 1, False, 1),
        ("switch", True, 1, False, 1), ("naive", True, 1, True, 2)])
    def test_loss_with_aux_and_every_gradient_match(self, gate, recompute, every, fused, topk):
        jm, tm, _ = _llama_pair(gate, recompute, every, fused, topk)
        ids, labels = _ids(2), _ids(3)
        jm.train()
        ref_loss, _ = jm(paddle.to_tensor(ids), labels=paddle.to_tensor(labels))
        ref_loss.backward()
        ref = {n: _np(p.grad) for n, p in jm.named_parameters()}
        tm.train()
        loss, _ = tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
        loss.backward()
        got = llama_to_numpy(tm, grads=True)
        np.testing.assert_allclose(loss.item(), float(_np(ref_loss)), rtol=LLAMA_TOL)
        assert set(got) == set(ref)
        for name, g in ref.items():
            np.testing.assert_allclose(got[name], g, rtol=LLAMA_TOL, atol=LLAMA_TOL,
                                       err_msg=name)

    @pytest.mark.parametrize("gate", ["gshard", "switch"])
    def test_training_loss_is_ce_plus_aux(self, gate):
        _, tm, _ = _llama_pair(gate, topk=1 if gate == "switch" else 2)
        ids, labels = torch.from_numpy(_ids(4)), torch.from_numpy(_ids(5))
        tm.train()
        loss, logits = tm(ids, labels=labels)
        ce = tm.criterion(logits, labels)
        tm(ids)                       # a forward to read the gates' losses from
        aux = tm.moe_aux_loss()
        assert float(aux) > 0
        np.testing.assert_allclose(float(loss - ce), 0.01 * float(aux), rtol=1e-4)

    def test_eval_loss_excludes_aux(self):
        jm, tm, _ = _llama_pair("gshard")
        ids, labels = _ids(6), _ids(7)
        jm.eval()
        tm.eval()
        ref, _ = jm(paddle.to_tensor(ids), labels=paddle.to_tensor(labels))
        loss, logits = tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
        np.testing.assert_allclose(loss.item(), float(_np(ref)), rtol=LLAMA_TOL)
        torch.testing.assert_close(loss, tm.criterion(logits, torch.from_numpy(labels)))

    def test_greedy_generate_tokens_identical(self):
        jm, tm, _ = _llama_pair("naive")
        ids = _ids(8, (1, 5))
        jm.eval()
        ref = _np(jm.generate(paddle.to_tensor(ids), max_new_tokens=4))
        got = tm.generate(torch.from_numpy(ids), max_new_tokens=4).numpy()
        np.testing.assert_array_equal(got, ref)

    def test_recompute_with_random_routing_gives_the_same_gradients(self):
        # GShard's second-choice sampling on: at one seed, the recomputed
        # forward routes as the forward did
        grads = []
        for recompute in (False, True):
            cfg = LlamaConfig(recompute=recompute, moe_gate="gshard", **_CFG)
            tm = LlamaForCausalLM(cfg, device="cpu", seed=3)
            tm.train()
            torch.manual_seed(11)
            loss, _ = tm(torch.from_numpy(_ids(9)), labels=torch.from_numpy(_ids(10)))
            loss.backward()
            grads.append({n: p.grad.clone() for n, p in tm.named_parameters()})
        assert grads[0].keys() == grads[1].keys()
        for n in grads[0]:
            torch.testing.assert_close(grads[1][n], grads[0][n], rtol=1e-6, atol=1e-7)

    def test_every_gate_builds_and_trains(self):
        from paddle_tpu_torch.optimizer import AdamW

        for gate in ("naive", "gshard", "switch"):
            cfg = LlamaConfig(moe_gate=gate, recompute=True, **dict(_CFG, moe_topk=1 if gate
                                                                     == "switch" else 2))
            tm = LlamaForCausalLM(cfg, device="cpu", seed=1)
            tm.train()
            opt = AdamW(learning_rate=1e-2, parameters=tm.parameters())
            ids, labels = torch.from_numpy(_ids(11)), torch.from_numpy(_ids(11))
            losses = []
            for _ in range(4):
                loss, _ = tm(ids, labels=labels)
                loss.backward()
                opt.step()
                opt.clear_grad()
                losses.append(loss.item())
            assert np.isfinite(losses).all() and losses[-1] < losses[0], (gate, losses)

    def test_expert_parallel_mesh_raises(self):
        cfg = LlamaConfig(moe_mesh=object(), **_CFG)
        with pytest.raises(NotImplementedError, match="Queue A item 10"):
            LlamaForCausalLM(cfg, device="cpu")
