"""Selective recompute in the PyTorch port against the JAX package:
``recompute_granularity="full_attn"`` and ``"core_attn"`` (the JAX model's
``dots_with_no_batch_dims_saveable``) give the JAX model's loss and every
gradient, and keep a number of bytes for the backward between no recompute
and full recompute.

Recompute changes no value, so parity alone cannot tell the policies apart:
the bytes a forward leaves alive for its backward are counted by recording
every tensor the forward creates (a ``TorchDispatchMode``) and summing the
storages still alive once the outputs but the loss are dropped.
"""
import gc
import weakref

import numpy as np
import pytest

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

import paddle_tpu as paddle
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch.distributed.fleet.recompute import SAVED_OPS, recompute
from paddle_tpu_torch.models import LlamaConfig, llama_from_numpy, llama_to_numpy

_CFG = dict(vocab_size=64, intermediate_size=64, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=32,
            hidden_size=32)


def _batch(seed, shape=(2, 9)):
    r = np.random.RandomState(seed)
    ids = r.randint(0, 64, shape).astype("int64")
    labels = r.randint(0, 64, shape).astype("int64")
    labels[r.rand(*shape) < 0.25] = -100
    return ids, labels


def _state(seed=3):
    paddle.seed(seed)
    jm = JaxLlama(JaxConfig(**_CFG))
    return {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}


class _LiveBytes(TorchDispatchMode):
    """Records every tensor an op creates under it; ``live()`` is the bytes of
    the distinct storages among them that are still alive."""

    def __init__(self):
        super().__init__()
        self.refs, self.ops = [], set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.ops.add(func)
        self.refs += [weakref.ref(t) for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        return out

    def live(self):
        storages = {}
        for ref in self.refs:
            t = ref()
            if t is not None:
                st = t.untyped_storage()
                storages[st.data_ptr()] = st.nbytes()
        return sum(storages.values())


def _saved_bytes(state, **kw):
    model = llama_from_numpy(state, LlamaConfig(**_CFG, **kw), device="cpu")
    model.train()
    ids, labels = _batch(5, (2, 16))
    mode = _LiveBytes()
    with mode:
        loss, logits = model(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    del logits
    gc.collect()
    kept = mode.live()
    loss.backward()
    return kept, mode.ops


class TestParity:
    @pytest.mark.parametrize("gran", ["full_attn", "core_attn", "full"])
    def test_loss_and_every_gradient_match_jax(self, gran):
        state = _state()
        paddle.seed(3)
        jm = JaxLlama(JaxConfig(recompute=True, recompute_granularity=gran, **_CFG))
        jm.set_state_dict({k: paddle.to_tensor(v) for k, v in state.items()})
        tm = llama_from_numpy(state, LlamaConfig(recompute=True, recompute_granularity=gran,
                                                 **_CFG), device="cpu")
        ids, labels = _batch(1)
        jm.train()
        jl, _ = jm(paddle.to_tensor(ids), labels=paddle.to_tensor(labels))
        jl.backward()
        tm.train()
        tl, _ = tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
        tl.backward()
        np.testing.assert_allclose(tl.item(), float(jl.numpy()), rtol=1e-5, atol=1e-5)
        grads = llama_to_numpy(tm, grads=True)
        for name, p in jm.named_parameters():
            np.testing.assert_allclose(grads[name], np.asarray(p.grad.numpy()), rtol=2e-4,
                                       atol=2e-5, err_msg=name)

    @pytest.mark.parametrize("gran", ["full_attn", "full"])
    def test_recompute_reproduces_the_plain_gradients_exactly(self, gran):
        # the recompute's tensors are the forward's: the same ops on the same
        # inputs, so the gradients equal the no-recompute ones bit for bit
        state = _state()
        out = {}
        for key, kw in (("off", {}), ("on", dict(recompute=True, recompute_granularity=gran))):
            m = llama_from_numpy(state, LlamaConfig(**_CFG, **kw), device="cpu")
            m.train()
            ids, labels = _batch(2)
            loss, _ = m(torch.from_numpy(ids), labels=torch.from_numpy(labels))
            loss.backward()
            out[key] = (loss.item(), llama_to_numpy(m, grads=True))
        assert out["on"][0] == out["off"][0]
        for name, g in out["off"][1].items():
            np.testing.assert_array_equal(out["on"][1][name], g, err_msg=name)


class TestSavedBytes:
    def test_selective_keeps_less_than_none_and_more_than_full(self):
        state = _state()
        off, ops = _saved_bytes(state)
        full_attn, _ = _saved_bytes(state, recompute=True, recompute_granularity="full_attn")
        core_attn, _ = _saved_bytes(state, recompute=True, recompute_granularity="core_attn")
        full, _ = _saved_bytes(state, recompute=True)
        assert off > full_attn > full, (off, full_attn, full)
        assert core_attn == full_attn
        # the products the policy keeps are the ones the layers issue here
        assert torch.ops.aten.mm.default in ops

    def test_fused_head_keeps_less_than_the_standard_head(self):
        state = _state()
        std, _ = _saved_bytes(state, recompute=True, recompute_granularity="full_attn")
        fused, _ = _saved_bytes(state, recompute=True, recompute_granularity="full_attn",
                                fused_head_ce=True)
        assert fused < std, (fused, std)


class TestPolicies:
    def test_saved_op_sets(self):
        aten = torch.ops.aten
        unbatched = {aten.mm.default, aten.addmm.default, aten._addmm_activation.default}
        assert SAVED_OPS["dots_with_no_batch_dims_saveable"] == unbatched
        assert SAVED_OPS["dots_saveable"] == unbatched | {aten.bmm.default,
                                                          aten.baddbmm.default}

    @pytest.mark.parametrize("policy", [None, "full", "nothing_saveable", "dots_saveable",
                                        "dots_with_no_batch_dims_saveable"])
    def test_every_policy_gives_the_plain_gradient(self, policy):
        gen = torch.Generator().manual_seed(0)
        w = torch.randn(6, 6, generator=gen, requires_grad=True)
        x = torch.randn(2, 3, 6, generator=gen, requires_grad=True)

        def seg(x):
            return torch.tanh(torch.bmm(x @ w, (x @ w).transpose(1, 2))).sum(-1)

        ref = torch.autograd.grad(seg(x).sum(), (x, w))
        got = torch.autograd.grad(recompute(seg, x, checkpoint_policy=policy).sum(), (x, w))
        for a, b in zip(got, ref):
            torch.testing.assert_close(a, b, rtol=0, atol=0)

    def test_unknown_policy_raises(self):
        with pytest.raises(ValueError, match="unknown checkpoint_policy"):
            recompute(lambda x: x, torch.zeros(2, requires_grad=True), checkpoint_policy="dots")
