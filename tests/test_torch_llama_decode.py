"""KV-cache decode engine of the PyTorch port against the JAX package's engine.

Both engines serve the same weights (JAX state_dict -> numpy ->
``llama_from_numpy``) on the same numpy prompts, on the CPU.
"""
import numpy as np
import pytest

import torch

import paddle_tpu as paddle
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama_decode import LlamaDecodeEngine as JaxEngine
from paddle_tpu_torch.models import (
    LlamaConfig, LlamaDecodeEngine, LlamaForCausalLM, llama_from_numpy)

_MAXLEN = 24


def _engines(kv=2, seed=0, max_len=_MAXLEN):
    paddle.seed(seed)
    kw = dict(vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
              num_attention_heads=4, num_key_value_heads=kv, max_position_embeddings=32)
    jm = JaxLlama(JaxConfig(**kw))
    jm.eval()
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = llama_from_numpy(state, LlamaConfig(**kw), device="cpu")
    return JaxEngine(jm, max_len=max_len), LlamaDecodeEngine(tm, max_len=max_len)


def _prompt(seed, shape=(2, 6)):
    return np.random.RandomState(seed).randint(0, 64, shape).astype("int32")


@pytest.fixture(scope="module")
def engines():
    return _engines()


class TestPrefillAndSteps:
    @pytest.mark.parametrize("kv", [1, 2, 4])
    def test_prefill_and_decode_logits_match(self, kv):
        je, te = _engines(kv=kv, seed=kv)
        ids = _prompt(kv)
        jl, jc, jpos = je.prefill(ids)
        tl, tc, tpos = te.prefill(ids)
        assert jpos == tpos == ids.shape[1]
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
        # feed both engines the same tokens, so each step compares one function
        toks = np.random.RandomState(100 + kv).randint(0, 64, (4, 2, 1)).astype("int32")
        pos = jpos
        for tok in toks:
            jl, jc = je.decode_step(tok, jc, pos)
            tl, tc = te.decode_step(torch.from_numpy(tok), tc, pos)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
            pos += 1

    def test_cache_written_in_place_at_pos(self, engines):
        _, te = engines
        ids = _prompt(3)
        _, cache, pos = te.prefill(ids)
        k0 = cache[0][0]
        _, cache2 = te.decode_step(torch.zeros(2, 1, dtype=torch.long), cache, pos)
        assert cache2[0][0] is k0
        assert k0[:, pos].abs().sum() > 0 and k0[:, pos + 1:].abs().sum() == 0


class TestGenerate:
    def test_greedy_tokens_identical(self, engines):
        je, te = engines
        ids = _prompt(5)
        ref = np.asarray(je.generate(ids, max_new_tokens=10))
        out = te.generate(ids, max_new_tokens=10).numpy()
        np.testing.assert_array_equal(out, ref)

    def test_eos_freeze_and_pad_identical(self, engines):
        je, te = engines
        ids = _prompt(6, (3, 5))
        greedy = np.asarray(je.generate(ids, max_new_tokens=12))
        # an EOS that one row emits early: that row freezes and pads with EOS
        eos = int(greedy[0, 2])
        ref = np.asarray(je.generate(ids, max_new_tokens=12, eos_token_id=eos))
        out = te.generate(ids, max_new_tokens=12, eos_token_id=eos).numpy()
        np.testing.assert_array_equal(out, ref)
        assert (out[0, 2:] == eos).all()

    def test_eos_all_finished_early_exit_pads(self, engines):
        je, te = engines
        ids = _prompt(7, (1, 5))
        eos = int(np.asarray(je.generate(ids, max_new_tokens=1))[0, 0])
        ref = np.asarray(je.generate(ids, max_new_tokens=17, eos_token_id=eos))
        out = te.generate(ids, max_new_tokens=17, eos_token_id=eos).numpy()
        np.testing.assert_array_equal(out, ref)
        assert out.shape == (1, 17) and (out == eos).all()

    def test_zero_new_tokens(self, engines):
        je, te = engines
        ids = _prompt(8)
        ref = np.asarray(je.generate(ids, max_new_tokens=0))
        out = te.generate(ids, max_new_tokens=0)
        assert out.shape == ref.shape == (2, 0)


class TestLimits:
    def test_decode_past_max_len_raises(self, engines):
        _, te = engines
        _, cache, _ = te.prefill(_prompt(9))
        with pytest.raises(ValueError, match="exceeds the cache"):
            te.decode_step(torch.zeros(2, 1, dtype=torch.long), cache, _MAXLEN)

    def test_prompt_plus_new_past_max_len_raises(self, engines):
        je, te = engines
        ids = _prompt(10)
        with pytest.raises(ValueError, match="exceeds the cache"):
            je.generate(ids, max_new_tokens=_MAXLEN)
        with pytest.raises(ValueError, match="exceeds the cache"):
            te.generate(ids, max_new_tokens=_MAXLEN)

    @pytest.mark.parametrize("kw", [dict(kv_cache_dtype="int8"),
                                    dict(kv_cache_layout="paged")])
    def test_unported_cache_forms_raise(self, kw):
        cfg = LlamaConfig(vocab_size=64, hidden_size=32, intermediate_size=64,
                          num_hidden_layers=1, num_attention_heads=4)
        with pytest.raises(NotImplementedError, match="slice"):
            LlamaDecodeEngine(LlamaForCausalLM(cfg, device="cpu"), **kw)


class TestSampling:
    def test_top_k_1_equals_greedy(self, engines):
        je, te = engines
        ids = _prompt(11)
        greedy = te.generate(ids, max_new_tokens=8).numpy()
        sampled = te.generate(ids, max_new_tokens=8, temperature=0.7, top_k=1,
                              seed=3).numpy()
        np.testing.assert_array_equal(sampled, greedy)

    @pytest.mark.parametrize("top_k,top_p", [(5, 1.0), (0, 0.6), (8, 0.8)])
    def test_samples_lie_in_the_jax_support(self, engines, top_k, top_p):
        je, te = engines
        ids = _prompt(12, (4, 6))
        temperature = 0.8
        logits = np.asarray(je.prefill(ids)[0], np.float64) / temperature
        allowed = np.ones_like(logits, bool)
        if top_k:
            kth = np.sort(logits, -1)[:, ::-1][:, top_k - 1:top_k]
            allowed &= logits >= kth
        if top_p < 1.0:
            srt = np.sort(logits, -1)[:, ::-1]
            probs = np.exp(srt - srt.max(-1, keepdims=True))
            probs /= probs.sum(-1, keepdims=True)
            keep = np.cumsum(probs, -1) - probs < top_p
            cutoff = np.where(keep, srt, np.inf).min(-1, keepdims=True)
            allowed &= logits >= cutoff
        for seed in range(6):
            tok = te.generate(ids, max_new_tokens=1, temperature=temperature,
                              top_k=top_k, top_p=top_p, seed=seed).numpy()[:, 0]
            assert allowed[np.arange(4), tok].all(), (seed, tok)
