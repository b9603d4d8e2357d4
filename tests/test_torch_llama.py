"""LLaMA of the PyTorch port against the JAX package's LLaMA.

The JAX model is built at a tiny width (as tests/test_inference_decode.py
does), its state_dict goes through numpy into ``llama_from_numpy``, and both
run the same numpy token ids on the CPU: the JAX side on its math attention
path, the port on its plain versions.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

import paddle_tpu as paddle
from paddle_tpu.incubate.nn.functional import (
    fused_rotary_position_embedding as jax_rope)
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import _rope_cos_sin as jax_rope_cos_sin
from paddle_tpu_torch.incubate.nn.functional import _rope_tables, fused_rotary_position_embedding
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM, llama_from_numpy,
                                     llama_to_numpy)
from paddle_tpu_torch.models.llama import apply_rotary_pos_emb
from paddle_tpu_torch.nn.functional import cross_entropy

_CFG = dict(vocab_size=64, intermediate_size=64, num_hidden_layers=2,
            num_attention_heads=4, max_position_embeddings=32)


def _pair(kv=2, hidden=32, tied=False, seed=0):
    """(JAX model, port model) holding the same weights."""
    paddle.seed(seed)
    jcfg = JaxConfig(hidden_size=hidden, num_key_value_heads=kv,
                     tie_word_embeddings=tied, **_CFG)
    jm = JaxLlama(jcfg)
    jm.eval()
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    cfg = LlamaConfig(hidden_size=hidden, num_key_value_heads=kv,
                      tie_word_embeddings=tied, **_CFG)
    return jm, llama_from_numpy(state, cfg, device="cpu"), state, cfg


def _ids(seed, shape):
    return np.random.RandomState(seed).randint(0, 64, shape).astype("int64")


def _labels(seed, shape):
    """Token labels with about a quarter of them ignored (-100)."""
    r = np.random.RandomState(seed)
    lab = r.randint(0, 64, shape).astype("int64")
    lab[r.rand(*shape) < 0.25] = -100
    return lab


def _jax_loss_and_grads(jm, ids, labels):
    jm.train()
    loss, _ = jm(paddle.to_tensor(ids), labels=paddle.to_tensor(labels))
    loss.backward()
    grads = {n: np.asarray(p.grad.numpy()) for n, p in jm.named_parameters()}
    return float(loss.numpy()), grads


def _port_loss_and_grads(tm, ids, labels):
    tm.train()
    loss, logits = tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    loss.backward()
    return loss.item(), llama_to_numpy(tm, grads=True), logits


class TestLossAndGradientParity:
    # loss and every gradient of the JAX model (math attention path) against
    # the port's (plain versions) at 1e-4, fp32
    @pytest.mark.parametrize("kv,hidden,tied", [
        (1, 32, False), (2, 32, False), (4, 64, False), (2, 64, True),
    ])
    def test_loss_and_every_gradient_match(self, kv, hidden, tied):
        jm, tm, _, _ = _pair(kv=kv, hidden=hidden, tied=tied)
        ids, labels = _ids(kv, (2, 7)), _labels(kv + 10, (2, 7))
        ref_loss, ref_grads = _jax_loss_and_grads(jm, ids, labels)
        loss, grads, logits = _port_loss_and_grads(tm, ids, labels)
        assert logits.shape == (2, 7, 64)
        np.testing.assert_allclose(loss, ref_loss, rtol=1e-4, atol=1e-4)
        assert set(grads) == set(ref_grads)
        for name, ref in ref_grads.items():
            assert grads[name] is not None, name
            np.testing.assert_allclose(grads[name], ref, rtol=1e-4, atol=1e-4,
                                       err_msg=name)

    def test_labels_with_trailing_unit_axis(self):
        jm, tm, _, _ = _pair(kv=2)
        ids, labels = _ids(3, (2, 5)), _labels(4, (2, 5))[..., None]
        ref_loss, _ = _jax_loss_and_grads(jm, ids, labels)
        loss, _, _ = _port_loss_and_grads(tm, ids, labels)
        np.testing.assert_allclose(loss, ref_loss, rtol=1e-4, atol=1e-4)

    def test_recompute_gives_the_same_loss_and_gradients(self):
        _, _, state, cfg = _pair(kv=2)
        rcfg = LlamaConfig(hidden_size=32, num_key_value_heads=2, recompute=True, **_CFG)
        plain = llama_from_numpy(state, cfg, device="cpu")
        remat = llama_from_numpy(state, rcfg, device="cpu")
        ids, labels = _ids(5, (2, 9)), _labels(6, (2, 9))
        loss0, grads0, _ = _port_loss_and_grads(plain, ids, labels)
        loss1, grads1, _ = _port_loss_and_grads(remat, ids, labels)
        np.testing.assert_allclose(loss1, loss0, rtol=1e-6, atol=1e-6)
        for name, g in grads0.items():
            np.testing.assert_allclose(grads1[name], g, rtol=1e-5, atol=1e-6, err_msg=name)


class TestForwardParity:
    @pytest.mark.parametrize("kv,hidden,tied", [
        (1, 32, False), (2, 32, False), (4, 64, False), (2, 64, True),
    ])
    def test_logits_match(self, kv, hidden, tied):
        jm, tm, _, _ = _pair(kv=kv, hidden=hidden, tied=tied)
        ids = _ids(kv, (2, 7))
        ref = jm(paddle.to_tensor(ids)).numpy()
        with torch.no_grad():
            out = tm(torch.from_numpy(ids)).numpy()
        np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)

    def test_tied_head_shares_the_embedding(self):
        _, tm, state, _ = _pair(tied=True)
        assert "lm_head.weight" not in state
        assert "lm_head.weight" not in dict(tm.named_parameters())
        assert tm.lm_head._embedding[0].weight is tm.llama.embed_tokens.weight

    def test_greedy_generate_tokens_identical(self):
        jm, tm, _, _ = _pair(kv=2)
        ids = _ids(1, (2, 5))
        ref = jm.generate(paddle.to_tensor(ids), max_new_tokens=4).numpy()
        out = tm.generate(torch.from_numpy(ids), max_new_tokens=4).numpy()
        np.testing.assert_array_equal(out, ref)


class TestRope:
    """The rotate-half cases of tests/test_models.py TestFusedRopeSemantics."""

    def _qkv(self):
        r = np.random.RandomState(0)
        return tuple(r.randn(2, 8, 4, 16).astype("float32") for _ in range(3))

    def _jax(self, *arrs, **kw):
        args = [None if a is None else paddle.to_tensor(a) for a in arrs]
        return [None if o is None else o.numpy() for o in jax_rope(*args, **kw)]

    def _port(self, *arrs, **kw):
        args = [None if a is None else torch.from_numpy(a) for a in arrs]
        kw = {k: torch.tensor(v) if isinstance(v, np.ndarray) else v
              for k, v in kw.items()}
        return [None if o is None else o.numpy()
                for o in fused_rotary_position_embedding(*args, **kw)]

    def test_rotate_half_matches_jax_and_slots_fixed(self):
        q, _, v = self._qkv()
        ref = self._jax(q, None, v, use_neox_rotary_style=False)
        out = self._port(q, None, v, use_neox_rotary_style=False)
        assert out[1] is None and ref[1] is None
        for o, r in ((out[0], ref[0]), (out[2], ref[2])):
            np.testing.assert_allclose(o, r, rtol=1e-5, atol=1e-5)
        # v is rotated too (position 0 = identity)
        np.testing.assert_allclose(out[2][:, 0], v[:, 0], rtol=1e-5)
        assert not np.allclose(out[2][:, 1:], v[:, 1:])

    def test_half_matches_llama_apply_rotary(self):
        q, k, _ = self._qkv()
        qh, kh, _ = self._port(q, k, use_neox_rotary_style=False)
        cos, sin = _rope_tables(8, 16, 10000.0, torch.float32, "cpu", every_two=False)
        q2, k2 = apply_rotary_pos_emb(torch.from_numpy(q), torch.from_numpy(k), cos, sin)
        np.testing.assert_allclose(qh, q2.numpy(), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(kh, k2.numpy(), rtol=1e-5, atol=1e-5)

    def test_4d_sin_cos_tables(self):
        q, k, _ = self._qkv()
        cos, sin = (np.asarray(t)[None, :, None, :]
                    for t in jax_rope_cos_sin(8, 16, 10000.0, jnp.float32))
        ref = self._jax(q, k, sin=sin, cos=cos, use_neox_rotary_style=False)
        out = self._port(q, k, sin=sin, cos=cos, use_neox_rotary_style=False)
        np.testing.assert_allclose(out[0], ref[0], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(out[1], ref[1], rtol=1e-5, atol=1e-5)

    def test_position_ids(self):
        q, k, _ = self._qkv()
        pos = np.random.RandomState(1).randint(0, 50, (2, 8)).astype("int64")
        ref = self._jax(q, k, position_ids=pos, use_neox_rotary_style=False)
        out = self._port(q, k, position_ids=pos, use_neox_rotary_style=False)
        np.testing.assert_allclose(out[0], ref[0], rtol=1e-5, atol=1e-5)

    def test_every_two_style_is_not_ported(self):
        """It was refused until the every-two pairing was ported; now it is
        the JAX function's (tests/test_torch_attention_functional.py holds
        the rest of its cases)."""
        q, k, _ = self._qkv()
        ref = self._jax(q, k, use_neox_rotary_style=True)
        out = self._port(q, k, use_neox_rotary_style=True)
        for o, r in zip(out[:2], ref[:2]):
            np.testing.assert_allclose(o, r, rtol=1e-5, atol=1e-5)


class TestHeadDims96And256:
    """Two layers at Phi-3-mini's head dim (hidden 192, 2 heads: D = 96) and
    Gemma-2B's (hidden 512, 2 heads, 1 KV head: D = 256): logits, loss and
    every gradient of the JAX model (math attention path) against the
    port's (plain versions), fp32, 1e-4 as the cases above."""

    @staticmethod
    def _pair(hidden, kv, seed):
        cfg = dict(_CFG, hidden_size=hidden, num_attention_heads=2, num_key_value_heads=kv)
        paddle.seed(seed)
        jm = JaxLlama(JaxConfig(**cfg))
        jm.eval()
        state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
        tm = llama_from_numpy(state, LlamaConfig(**cfg), device="cpu")
        assert tm.config.head_dim == hidden // 2
        return jm, tm

    @pytest.mark.parametrize("hidden,kv", [(192, 2), (512, 1)], ids=["d96", "d256"])
    def test_logits_loss_and_every_gradient_match(self, hidden, kv):
        jm, tm = self._pair(hidden, kv, seed=hidden)
        ids, labels = _ids(hidden, (2, 9)), _labels(hidden + 1, (2, 9))
        ref = jm(paddle.to_tensor(ids)).numpy()
        with torch.no_grad():
            np.testing.assert_allclose(tm(torch.from_numpy(ids)).numpy(), ref, rtol=1e-4,
                                       atol=1e-4)
        ref_loss, ref_grads = _jax_loss_and_grads(jm, ids, labels)
        loss, grads, _ = _port_loss_and_grads(tm, ids, labels)
        np.testing.assert_allclose(loss, ref_loss, rtol=1e-4, atol=1e-4)
        assert set(grads) == set(ref_grads)
        for name, r in ref_grads.items():
            np.testing.assert_allclose(grads[name], r, rtol=1e-4, atol=1e-4, err_msg=name)

    @pytest.mark.parametrize("hidden,kv", [(192, 2), (512, 1)], ids=["d96", "d256"])
    def test_greedy_generate_tokens_identical(self, hidden, kv):
        jm, tm = self._pair(hidden, kv, seed=hidden + 2)
        ids = _ids(hidden + 3, (2, 5))
        ref = jm.generate(paddle.to_tensor(ids), max_new_tokens=4).numpy()
        out = tm.generate(torch.from_numpy(ids), max_new_tokens=4).numpy()
        np.testing.assert_array_equal(out, ref)


class TestConverter:
    def test_unknown_name_raises(self):
        _, _, state, cfg = _pair()
        state = dict(state, **{"llama.layers.9.mlp.up_proj.weight": np.zeros((32, 64))})
        with pytest.raises(KeyError, match="unknown names.*layers.9"):
            llama_from_numpy(state, cfg, device="cpu")

    def test_missing_name_raises(self):
        _, _, state, cfg = _pair()
        del state["llama.layers.1.self_attn.k_proj.weight"]
        with pytest.raises(KeyError, match="missing names.*layers.1.self_attn.k_proj"):
            llama_from_numpy(state, cfg, device="cpu")

    def test_wrong_shape_raises(self):
        _, _, state, cfg = _pair()
        state["llama.norm.weight"] = np.ones(31, np.float32)
        with pytest.raises(ValueError, match="llama.norm.weight"):
            llama_from_numpy(state, cfg, device="cpu")

    def test_linear_weights_are_transposed(self):
        _, tm, state, _ = _pair()
        w = state["llama.layers.0.self_attn.k_proj.weight"]            # (in, out)
        np.testing.assert_array_equal(
            tm.llama.layers[0].self_attn.k_proj.weight.detach().numpy(), w.T)
        np.testing.assert_array_equal(tm.lm_head.weight.detach().numpy(),
                                      state["lm_head.weight"].T)


class TestUnportedOptions:
    @pytest.mark.parametrize("kw", [
        dict(tensor_parallel_degree=2), dict(sequence_parallel=True),
        dict(pipeline_parallel_degree=2), dict(num_experts=4),
        dict(use_ring_attention=True),
        # selective recompute and the fused head are ported
        # (tests/test_torch_recompute.py, tests/test_torch_fused_ce.py); the
        # budget remat planner is not
        dict(recompute=True, recompute_policy="auto"),
        dict(recompute=True, recompute_granularity="core_attn", recompute_policy="auto"),
    ])
    def test_raises_not_implemented(self, kw):
        cfg = LlamaConfig(hidden_size=32, **_CFG, **kw)
        # MoE is item 8's next entry (incubate.distributed with LlamaMoEMLP)
        item = "Queue A item 8" if kw.get("num_experts") else "Queue A item 10"
        with pytest.raises(NotImplementedError, match=item):
            LlamaForCausalLM(cfg, device="cpu")

    def test_labels_raise(self):
        # hard labels train (TestLossAndGradientParity); soft labels, class
        # weights and label smoothing are ported now and no longer raise
        # (held to the JAX function in test_torch_train.py): a uniform
        # weight gives the unweighted mean, smoothing 0 the plain loss
        logits = torch.randn(2, 3, 8, generator=torch.Generator().manual_seed(0))
        labels = torch.zeros(2, 3, dtype=torch.long)
        plain = cross_entropy(logits, labels)
        torch.testing.assert_close(cross_entropy(logits, labels, weight=torch.ones(8)), plain)
        torch.testing.assert_close(cross_entropy(logits, labels, label_smoothing=0.0), plain)
        soft = torch.nn.functional.one_hot(labels, 8).float()
        torch.testing.assert_close(cross_entropy(logits, soft, soft_label=True), plain)

    def test_bfloat16_config_builds_bfloat16_parameters(self):
        cfg = LlamaConfig(hidden_size=32, dtype="bfloat16", **_CFG)
        m = LlamaForCausalLM(cfg, device="cpu")
        assert {p.dtype for p in m.parameters()} == {torch.bfloat16}
        out = m(torch.from_numpy(_ids(0, (1, 4))))
        assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()
