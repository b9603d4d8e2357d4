"""The fused LM-head cross-entropy of the PyTorch port against the JAX
package's: ``fused_linear_cross_entropy`` alone (per-token loss, dHidden and
dWeight, with S not a multiple of the chunk and with ignored labels), then
the LLaMA model with ``fused_head_ce`` against the JAX model with it, tied and
untied, and against the port's own standard head.

Inputs come from numpy seeds; the JAX side runs on the CPU, the port takes its
plain torch ops on CPU tensors. Tolerances are tests/test_models.py:62's:
loss 1e-5, every gradient rtol 2e-4 / atol 2e-5.
"""
import numpy as np
import pytest

import torch

import paddle_tpu as paddle
from paddle_tpu.incubate.nn.functional import fused_linear_cross_entropy as jax_fce
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch.incubate.nn.functional import fused_linear_cross_entropy
from paddle_tpu_torch.models import LlamaConfig, llama_from_numpy, llama_to_numpy

_CFG = dict(vocab_size=64, intermediate_size=64, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=32,
            hidden_size=32)


def _inputs(seed, B=2, S=13, H=16, V=40):
    r = np.random.RandomState(seed)
    hidden = r.randn(B, S, H).astype(np.float32)
    weight = (r.randn(H, V) * 0.3).astype(np.float32)
    labels = r.randint(0, V, (B, S)).astype("int64")
    labels[0, :3] = -100
    labels[1, S // 2] = -100
    g = r.randn(B, S).astype(np.float32)
    return hidden, weight, labels, g


class TestFunction:
    @pytest.mark.parametrize("S,chunk", [(13, 4), (13, 13), (12, 4), (5, 512)],
                             ids=["ragged", "one_chunk", "even", "chunk_past_s"])
    def test_loss_and_gradients_match_jax(self, S, chunk):
        hidden, weight, labels, g = _inputs(S + chunk, S=S)
        jh = paddle.to_tensor(hidden, stop_gradient=False)
        jw = paddle.to_tensor(weight, stop_gradient=False)
        ref = jax_fce(jh, jw, paddle.to_tensor(labels), chunk_size=chunk)
        (ref * paddle.to_tensor(g)).sum().backward()
        th = torch.tensor(hidden, requires_grad=True)
        tw = torch.tensor(weight, requires_grad=True)
        out = fused_linear_cross_entropy(th, tw, torch.from_numpy(labels), chunk_size=chunk)
        (out * torch.from_numpy(g)).sum().backward()
        assert out.shape == (2, S) and out.dtype == torch.float32
        np.testing.assert_allclose(out.detach().numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)
        assert (out.detach().numpy()[labels == -100] == 0).all()
        np.testing.assert_allclose(th.grad.numpy(), jh.grad.numpy(), rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(tw.grad.numpy(), jw.grad.numpy(), rtol=2e-4, atol=2e-5)

    def test_equals_the_materialized_loss(self):
        # the same per-token loss as log_softmax over the full logits
        hidden, weight, labels, _ = _inputs(3)
        h, w, lab = torch.from_numpy(hidden), torch.from_numpy(weight), torch.from_numpy(labels)
        ref = torch.nn.functional.cross_entropy((h @ w).transpose(1, 2), lab,
                                                ignore_index=-100, reduction="none")
        out = fused_linear_cross_entropy(h, w, lab, chunk_size=4)
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-6)

    def test_bf16_inputs_give_an_fp32_loss_and_input_dtype_gradients(self):
        hidden, weight, labels, _ = _inputs(4)
        h = torch.tensor(hidden, dtype=torch.bfloat16, requires_grad=True)
        w = torch.tensor(weight, dtype=torch.bfloat16, requires_grad=True)
        out = fused_linear_cross_entropy(h, w, torch.from_numpy(labels), chunk_size=4)
        out.sum().backward()
        assert out.dtype == torch.float32
        assert h.grad.dtype == w.grad.dtype == torch.bfloat16
        ref = fused_linear_cross_entropy(h.detach().float(), w.detach().float(),
                                         torch.from_numpy(labels), chunk_size=4)
        # bf16 products: the logits move by ~2**-8 of their size
        torch.testing.assert_close(out, ref, rtol=0, atol=5e-2)


def _pair(tied, fused=True, seed=7):
    paddle.seed(seed)
    jm = JaxLlama(JaxConfig(tie_word_embeddings=tied, fused_head_ce=fused, **_CFG))
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    cfg = LlamaConfig(tie_word_embeddings=tied, fused_head_ce=fused, **_CFG)
    return jm, llama_from_numpy(state, cfg, device="cpu"), state


def _batch(seed, shape=(2, 9)):
    r = np.random.RandomState(seed)
    ids = r.randint(0, 64, shape).astype("int64")
    labels = r.randint(0, 64, shape).astype("int64")
    labels[0, :4] = -100
    return ids, labels


class TestModel:
    @pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
    def test_fused_head_matches_the_jax_model(self, tied):
        jm, tm, _ = _pair(tied)
        ids, labels = _batch(1)
        jm.train()
        jl, jlogits = jm(paddle.to_tensor(ids), labels=paddle.to_tensor(labels))
        assert jlogits is None
        jl.backward()
        ref = {n: np.asarray(p.grad.numpy()) for n, p in jm.named_parameters()}
        tm.train()
        loss, logits = tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
        assert logits is None and loss.dtype == torch.float32
        loss.backward()
        np.testing.assert_allclose(loss.item(), float(jl.numpy()), rtol=1e-5, atol=1e-5)
        grads = llama_to_numpy(tm, grads=True)
        assert set(grads) == set(ref)
        for name, g in ref.items():
            np.testing.assert_allclose(grads[name], g, rtol=2e-4, atol=2e-5, err_msg=name)

    @pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
    def test_fused_head_matches_the_standard_head(self, tied):
        _, fused, state = _pair(tied)
        std = llama_from_numpy(state, LlamaConfig(tie_word_embeddings=tied, **_CFG),
                               device="cpu")
        ids, labels = _batch(2)
        out = {}
        for key, m in (("fused", fused), ("std", std)):
            m.train()
            loss, _ = m(torch.from_numpy(ids), labels=torch.from_numpy(labels)[..., None])
            loss.backward()
            out[key] = (loss.item(), llama_to_numpy(m, grads=True))
        np.testing.assert_allclose(out["fused"][0], out["std"][0], rtol=1e-5, atol=1e-6)
        for name, g in out["std"][1].items():
            np.testing.assert_allclose(out["fused"][1][name], g, rtol=2e-4, atol=2e-5,
                                       err_msg=name)

    def test_without_labels_gives_logits(self):
        _, tm, _ = _pair(False)
        ids, _ = _batch(3)
        assert tm(torch.from_numpy(ids)).shape == (2, 9, 64)
