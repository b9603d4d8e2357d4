"""KV-cache decode engine of the PyTorch port against the JAX package's engine.

Both engines serve the same weights (JAX state_dict -> numpy ->
``llama_from_numpy``) on the same numpy prompts, on the CPU: the dense
cache, the int8 cache, the paged cache (``kv_cache_layout="paged"``), the
paged int8 cache and beam search on each.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

import paddle_tpu as paddle
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama_decode import LlamaDecodeEngine as JaxEngine
from paddle_tpu_torch.models import (
    LlamaConfig, LlamaDecodeEngine, LlamaForCausalLM, llama_from_numpy)

_MAXLEN = 24


def _engines(kv=2, seed=0, max_len=_MAXLEN, float64=False, positions=32, state_fn=None,
             **engine_kw):
    """(JAX engine, port engine) over the same weights; ``state_fn`` may edit
    the numpy state first, and ``engine_kw`` go to both engines
    (kv_cache_dtype, kv_cache_layout, block_size)."""
    paddle.seed(seed)
    kw = dict(vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
              num_attention_heads=4, num_key_value_heads=kv,
              max_position_embeddings=positions)
    jm = JaxLlama(JaxConfig(**kw))
    if float64:
        jm = jm.astype("float64")
    jm.eval()
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    if state_fn is not None:
        state = state_fn(state)
        jm.set_state_dict(state)
    tm = llama_from_numpy(state, LlamaConfig(**kw), device="cpu",
                          dtype=torch.float64 if float64 else None)
    return (JaxEngine(jm, max_len=max_len, **engine_kw),
            LlamaDecodeEngine(tm, max_len=max_len, **engine_kw))


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

    @pytest.mark.parametrize("kw,match", [(dict(kv_cache_dtype="fp4"), "kv_cache_dtype"),
                                          (dict(kv_cache_layout="ring"), "kv_cache_layout")])
    def test_unsupported_cache_forms_raise_value_error(self, kw, match):
        cfg = LlamaConfig(vocab_size=64, hidden_size=32, intermediate_size=64,
                          num_hidden_layers=1, num_attention_heads=4)
        with pytest.raises(ValueError, match=match):
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


def _same_steps(je, te, ids, n_steps, seed):
    """Prefill, then decode steps on the same tokens: logits within 1e-4."""
    jl, jc, pos = je.prefill(ids)
    tl, tc, tpos = te.prefill(ids)
    assert tpos == pos
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
    toks = np.random.RandomState(seed).randint(0, 64, (n_steps, ids.shape[0], 1))
    for tok in toks.astype("int32"):
        jl, jc = je.decode_step(tok, jc, pos)
        tl, tc = te.decode_step(torch.from_numpy(tok), tc, pos)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
        pos += 1
    return jc, tc


class TestInt8Cache:
    def test_quantize_bit_exact(self):
        x = np.random.RandomState(0).randn(2, 5, 3, 16).astype(np.float32) * 3
        x[0, 0, 0] = 0.0                         # the 1e-8 floor
        x[1, 2, 1, :4] = [0.5, -0.5, 1.5, 2.5]   # halves: round half to even
        x[1, 2, 1, 4] = 127.0
        jq, js = JaxEngine._quantize_kv(jnp.asarray(x))
        tq, ts = LlamaDecodeEngine._quantize_kv(torch.from_numpy(x))
        assert tq.dtype == torch.int8 and ts.dtype == torch.float32
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))

    def test_quantize_known_values(self):
        x = torch.tensor([[[[1.0, -2.0, 0.5, 4.0]]], [[[0.0, 0.0, 0.0, 0.0]]]])
        q, s = LlamaDecodeEngine._quantize_kv(x)
        np.testing.assert_allclose(s[0, 0, 0].item(), 4.0 / 127.0, rtol=1e-7)
        np.testing.assert_array_equal(
            q[0, 0, 0].numpy(), np.round(np.array([1.0, -2.0, 0.5, 4.0]) / (4.0 / 127.0)))
        assert q[0, 0, 0, 3].item() == 127 and (q[1] == 0).all()
        assert s[1].item() == np.float32(1e-8)
        deq = q[0, 0, 0].float() * s[0, 0, 0]
        assert (deq - x[0, 0, 0]).abs().max().item() <= (4.0 / 127.0) / 2 + 1e-7

    @pytest.mark.parametrize("kv", [1, 2, 4])
    def test_prefill_and_decode_logits_match(self, kv):
        je, te = _engines(kv=kv, seed=20 + kv, kv_cache_dtype="int8")
        jc, tc = _same_steps(je, te, _prompt(20 + kv), 4, 30 + kv)
        # the four cache tensors of every layer over the filled prefix (the
        # prompt and four decoded tokens): K and V come out of the two
        # frameworks' projections a rounding apart, so a scale may differ in
        # its last bit and a value by one step where x / scale lands near .5
        for je_, te_ in zip(jc, tc):
            assert [a.dtype for a in te_] == [torch.int8, torch.float32] * 2
            for a, b in zip(je_, te_):
                a, b = np.asarray(a)[:, :10].astype(np.float64), b[:, :10].double().numpy()
                if b.ndim == 4:
                    assert np.abs(a - b).max() <= 1 and (a == b).mean() > 0.99
                else:
                    np.testing.assert_allclose(b, a, rtol=1e-5)

    def test_cache_is_int8_and_about_half_of_bf16(self):
        cfg = LlamaConfig(vocab_size=64, hidden_size=64, intermediate_size=64,
                          num_hidden_layers=1, num_attention_heads=2, dtype="bfloat16")
        model = LlamaForCausalLM(cfg, device="cpu")
        dense = LlamaDecodeEngine(model, max_len=16).init_cache(2)
        int8 = LlamaDecodeEngine(model, max_len=16, kv_cache_dtype="int8").init_cache(2)
        nbytes = [sum(a.numel() * a.element_size() for a in c[0]) for c in (dense, int8)]
        # int8 values + one fp32 scale per (token, head): (D + 4) / 2D of bf16
        assert nbytes[1] / nbytes[0] == (32 + 4) / (2 * 32)

    def test_greedy_tokens_identical(self):
        je, te = _engines(seed=3, kv_cache_dtype="int8")
        ids = _prompt(40)
        np.testing.assert_array_equal(te.generate(ids, max_new_tokens=10).numpy(),
                                      np.asarray(je.generate(ids, max_new_tokens=10)))

    def test_prompt_pass_attends_the_quantized_prompt(self, monkeypatch):
        """The int8 prompt pass attends the quantized K/V (as the JAX int8
        engine does), so it never reaches the flash-attention dispatcher."""
        _, te = _engines(seed=4, kv_cache_dtype="int8")
        calls = []
        monkeypatch.setattr(type(te), "_prompt_attention",
                            staticmethod(lambda *a: calls.append(a)))
        te.prefill(_prompt(41))
        assert calls == []


_PAGED = dict(max_len=64, positions=96, kv_cache_layout="paged", block_size=8)


class TestPagedCache:
    @pytest.mark.parametrize("kv_cache_dtype", [None, "int8"])
    def test_prefill_and_decode_logits_match(self, kv_cache_dtype):
        je, te = _engines(seed=5, kv_cache_dtype=kv_cache_dtype, **_PAGED)
        jc, tc = _same_steps(je, te, _prompt(50, (2, 9)), 9, 51)
        # the pools and the books, as the JAX engine leaves them
        np.testing.assert_array_equal(tc.pager._tables_np, jc.pager._tables_np)
        for je_, te_ in zip(jc.pools, tc.pools):
            for a, b in zip(je_, te_):
                np.testing.assert_allclose(b.float().numpy(), np.asarray(a, np.float32),
                                           rtol=0, atol=1e-5)

    @pytest.mark.parametrize("kv_cache_dtype", [None, "int8"])
    def test_generate_tokens_identical_and_lazy_grant(self, kv_cache_dtype):
        je, te = _engines(seed=6, kv_cache_dtype=kv_cache_dtype, **_PAGED)
        ids = np.random.RandomState(0).randint(0, 64, (2, 9)).astype("int32")
        ref = np.asarray(je.generate(ids, max_new_tokens=20))
        out = te.generate(ids, max_new_tokens=20).numpy()
        np.testing.assert_array_equal(out, ref)
        # lazy grant: after 9 + 20 tokens at block 8, each sequence owns
        # ceil(29 / 8) = 4 blocks, not the max_len / 8 = 8 worst case
        owned = (te._pager.block_tables.numpy() > 0).sum(axis=1)
        assert (owned == 4).all(), owned

    @pytest.mark.parametrize("kv_cache_dtype", [None, "int8"])
    def test_paged_equals_dense(self, kv_cache_dtype):
        """The paged engine serves the dense engine's function: the same
        greedy tokens (the JAX package's own acceptance bar)."""
        _, dense = _engines(seed=7, kv_cache_dtype=kv_cache_dtype, max_len=64, positions=96)
        _, paged = _engines(seed=7, kv_cache_dtype=kv_cache_dtype, **_PAGED)
        ids = _prompt(52, (3, 9))
        np.testing.assert_array_equal(paged.generate(ids, max_new_tokens=16).numpy(),
                                      dense.generate(ids, max_new_tokens=16).numpy())

    def test_interleaved_prefills_do_not_cross_wire(self):
        je, te = _engines(seed=8, max_len=48, positions=96, kv_cache_layout="paged",
                          block_size=8)
        rng = np.random.RandomState(3)
        ids_a = rng.randint(0, 64, (1, 7)).astype("int32")
        ids_b = rng.randint(0, 64, (1, 5)).astype("int32")
        want = np.asarray(je.generate(ids_a, max_new_tokens=8))
        la, ca, pa = te.prefill(ids_a)
        te.prefill(ids_b)                 # would clobber engine-level state
        toks = [la.argmax(-1, keepdim=True)]
        for _ in range(7):
            logits, ca = te.decode_step(toks[-1], ca, pa)
            pa += 1
            toks.append(logits.argmax(-1, keepdim=True))
        np.testing.assert_array_equal(torch.cat(toks, 1).numpy(), want)

    def test_decode_needs_the_paged_cache(self):
        _, te = _engines(seed=9, **_PAGED)
        with pytest.raises(TypeError, match="prefill"):
            te.decode_step(torch.zeros(2, 1, dtype=torch.long), [], 3)

    def test_cow_exhaustion_leaves_the_pools_live(self):
        """Shared tail blocks and no free block: decode_step raises
        CowPoolExhausted in both packages, and the cache keeps live pools."""
        from paddle_tpu.models.paged_kv import CowPoolExhausted as JaxCow
        from paddle_tpu_torch.models.paged_kv import CowPoolExhausted

        je, te = _engines(seed=10, **_PAGED)
        ids = _prompt(53, (2, 5))
        for eng, exc in ((je, JaxCow), (te, CowPoolExhausted)):
            _, cache, pos = eng.prefill(ids)
            pager = cache.pager
            pager.fork_rows([0, 0])               # both rows share row 0's blocks
            pager.take_blocks(len(pager._free))   # nothing left for a copy
            with pytest.raises(exc, match="copy-on-write"):
                eng.decode_step(np.zeros((2, 1), "int32"), cache, pos)
            assert cache.pools is not None
        assert all(a is b for a, b in zip(cache.pools[0], te._pager.k[:1] + te._pager.v[:1]))


class TestCapturedPrograms:
    """The engine's programs (captured as CUDA graphs on the card, run
    eagerly here): the dense decode step in the JAX engine's fixed shape,
    one program per (batch, form) across positions, and the cache slots
    the programs are bound to."""

    @pytest.mark.parametrize("kv", [1, 2])
    def test_device_pos_step_matches_jax_step_jit(self, kv):
        """The dense step (the position a device tensor, attention over every
        cache slot masked t <= pos) against JAX ``_step_jit`` at every
        position of a 10-token decode, fp32 within 1e-5 (sums in another
        order); the step function runs once a step, from one program."""
        je, te = _engines(kv=kv, seed=20 + kv)
        ids = _prompt(60 + kv)
        jl, jc, pos = je.prefill(ids)
        tl, tc, _ = te.prefill(ids)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5, atol=1e-5)
        calls = []
        step = te._step_dense
        te._step_dense = lambda *a: calls.append(a[2].clone()) or step(*a)
        toks = np.random.RandomState(70 + kv).randint(0, 64, (10, 2, 1)).astype("int32")
        for tok in toks:
            jl, jc = je._step_jit(jnp.asarray(tok), jc, jnp.asarray(pos, jnp.int32))
            tl, tc2 = te.decode_step(torch.from_numpy(tok), tc, pos)
            assert tc2 is tc
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5, atol=1e-5)
            pos += 1
        assert [int(p) for p in calls] == list(range(ids.shape[1], pos))
        assert all(p.dtype == torch.int32 and p.shape == (1,) for p in calls)
        assert sorted(map(str, tc._slot.programs)) == ["('prefill', 6, 1)", "step"]

    @pytest.mark.parametrize("kw", [{}, dict(kv_cache_dtype="int8"), _PAGED],
                             ids=["dense", "int8", "paged"])
    def test_slot_reused_after_the_cache_goes(self, kw):
        """A generate at a seen (B, S) takes the slot the last one left, with
        its programs (on the card: its captured graphs), and the same tokens."""
        kw = dict(kw)
        _, te = _engines(seed=30, max_len=kw.pop("max_len", _MAXLEN),
                         positions=kw.pop("positions", 32), **kw)
        ids = _prompt(80)
        first = te.generate(ids, max_new_tokens=6)
        (slot,) = te._free
        programs = dict(slot.programs)
        again = te.generate(ids, max_new_tokens=6)
        assert te._free == [slot] and slot.programs == programs
        np.testing.assert_array_equal(again.numpy(), first.numpy())

    def test_live_caches_never_share_buffers(self):
        """Two interleaved dense decodes at one batch size: two slots, each
        stream equal to its solo run."""
        _, te = _engines(seed=31)
        a, b = _prompt(81), _prompt(82)
        solo = [te.generate(p, max_new_tokens=6).numpy() for p in (a, b)]
        la, ca, pa = te.prefill(a)
        lb, cb, pb = te.prefill(b)
        assert ca._slot is not cb._slot
        assert all(x.data_ptr() != y.data_ptr() for ea, eb in zip(ca, cb)
                   for x, y in zip(ea, eb))
        toks = [[la.argmax(-1, keepdim=True)], [lb.argmax(-1, keepdim=True)]]
        for _ in range(5):
            la, ca = te.decode_step(toks[0][-1], ca, pa)
            lb, cb = te.decode_step(toks[1][-1], cb, pb)
            pa, pb = pa + 1, pb + 1
            toks[0].append(la.argmax(-1, keepdim=True))
            toks[1].append(lb.argmax(-1, keepdim=True))
        for want, got in zip(solo, toks):
            np.testing.assert_array_equal(torch.cat(got, 1).numpy(), want)

    def test_free_list_keeps_the_slots_released_last(self):
        """Past ``max_free_slots`` released caches the oldest slot goes, with
        its buffers and programs: generates at four batch sizes leave the
        last two, and a fifth at the first batch size makes a new slot."""
        _, te = _engines(seed=33)
        slots = []
        for B in (1, 2, 3, 4):
            te.generate(_prompt(83, (B, 6)), max_new_tokens=3)
            slots.append(te._free[-1])
        assert te._free == slots[2:] and [s.batch for s in te._free] == [3, 4]
        te.generate(_prompt(83, (1, 6)), max_new_tokens=3)
        assert te._free[-1] is not slots[0] and [s.batch for s in te._free] == [4, 1]

    @pytest.mark.parametrize("form", [{}, dict(kv_cache_dtype="int8")], ids=["dense", "int8"])
    def test_decode_from_init_cache_matches_jax(self, form):
        """A decode from ``init_cache`` (no prefill) against the JAX engine's
        ``decode_step`` on its ``init_cache``: logits at every position of a
        6-token decode within 1e-5 (fp32). The step binds a slot to the
        caller's buffers, writes them in place and returns a handle on them;
        that slot never joins the free list."""
        je, te = _engines(seed=32, **form)
        jc, tc = je.init_cache(2), te.init_cache(2)
        toks = np.random.RandomState(84).randint(0, 64, (6, 2, 1)).astype("int32")
        for pos, tok in enumerate(toks):
            jl, jc = je.decode_step(tok, jc, pos)
            tl, tc2 = te.decode_step(torch.from_numpy(tok), tc, pos)
            assert all(a is b for ea, eb in zip(tc, tc2) for a, b in zip(ea, eb))
            tc = tc2
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tc[0][0].numpy(), np.asarray(jc[0][0]), rtol=1e-5,
                                   atol=1e-5)
        assert list(tc._slot.programs) == ["step"]
        del tc, tc2
        assert te._free == []


class TestRopeAtRows:
    def test_matches_jax(self):
        from paddle_tpu.models.llama_decode import _rope_at_rows as jax_rope
        from paddle_tpu_torch.models.llama_decode import _rope_at_rows

        x = np.random.RandomState(0).randn(3, 1, 4, 16).astype(np.float32)
        pos = np.array([0, 7, 130], np.int32)
        want = np.asarray(jax_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0))
        got = _rope_at_rows(torch.from_numpy(x), torch.from_numpy(pos), 10000.0)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


_FORMS = [dict(), dict(kv_cache_dtype="int8"), dict(kv_cache_layout="paged", block_size=8),
          dict(kv_cache_dtype="int8", kv_cache_layout="paged", block_size=8)]
_FORM_IDS = ["dense", "int8", "paged", "paged_int8"]


class TestBeamSearch:
    """At float64 (the JAX package runs with x64 on): identical tokens, and
    scores (float32 log-prob sums, as in JAX) within 1e-5."""

    @pytest.mark.parametrize("form", _FORMS, ids=_FORM_IDS)
    @pytest.mark.parametrize("eos,lp", [(None, 0.0), (5, 0.5), (None, 1.0)])
    def test_matches_jax(self, form, eos, lp):
        je, te = _engines(seed=11, float64=True, max_len=64, positions=96, **form)
        ids = _prompt(60, (2, 9))
        jt, js = je.beam_search(ids, beam_size=3, max_new_tokens=12, eos_token_id=eos,
                                length_penalty=lp)
        tt, ts = te.beam_search(ids, beam_size=3, max_new_tokens=12, eos_token_id=eos,
                                length_penalty=lp)
        assert tt.shape == (2, 3, 12) and ts.dtype == torch.float32
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5, atol=1e-5)
        if form.get("kv_cache_layout") == "paged":
            pager = te._pager
            live = int((pager._refs > 0).sum())
            assert live + len(pager._free) == pager.num_blocks - 1

    def test_eos_freezing_and_tie_order(self):
        """An EOS that the beams reach early: frozen beams pad with EOS at a
        fixed score, and their -inf extensions tie; the order of tied
        candidates must be the JAX one (lower index first)."""
        je, te = _engines(seed=12, float64=True, max_len=64, positions=96)
        ids = _prompt(61, (1, 6))
        first = np.asarray(je.beam_search(ids, beam_size=4, max_new_tokens=1)[0])[0]
        eos = int(first[0, 0])                  # the best first token ends a beam at once
        jt, js = je.beam_search(ids, beam_size=4, max_new_tokens=10, eos_token_id=eos)
        tt, ts = te.beam_search(ids, beam_size=4, max_new_tokens=10, eos_token_id=eos)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5, atol=1e-5)
        frozen = [row for row in tt[0].numpy() if (row == eos).any()]
        assert frozen
        for row in frozen:
            hit = np.flatnonzero(row == eos)[0]
            assert (row[hit:] == eos).all()

    @pytest.mark.parametrize("eos", [None, "top"])
    def test_tied_logits_keep_the_jax_order(self, eos):
        """Tokens 10-13 get the embedding row and the LM-head column of the
        first greedy token, so five candidates tie and beams that differ
        only in those tokens tie in score to the end: top-k and the final
        sort must order them as the JAX package does (lower index first;
        ``torch.topk`` promises no order)."""
        base, _ = _engines(seed=16, float64=True, max_len=64, positions=96)
        ids = _prompt(65, (2, 6))
        top = int(np.asarray(base.prefill(ids)[0]).argmax(-1)[0])

        def tie(state):
            w = state["lm_head.weight"].copy()       # (hidden, vocab)
            w[:, 10:14] = w[:, top:top + 1]
            e = state["llama.embed_tokens.weight"].copy()
            e[10:14] = e[top]
            return dict(state, **{"lm_head.weight": w, "llama.embed_tokens.weight": e})

        je, te = _engines(seed=16, float64=True, max_len=64, positions=96, state_fn=tie)
        eos = top if eos else None
        jt, js = je.beam_search(ids, beam_size=4, max_new_tokens=8, eos_token_id=eos)
        tt, ts = te.beam_search(ids, beam_size=4, max_new_tokens=8, eos_token_id=eos)
        assert len(np.unique(np.asarray(js)[0])) < 4          # tied scores occur
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("form", _FORMS[::2], ids=_FORM_IDS[::2])
    def test_beam_size_1_is_greedy(self, form):
        _, te = _engines(seed=13, float64=True, max_len=64, positions=96, **form)
        ids = _prompt(62, (2, 7))
        tokens, _ = te.beam_search(ids, beam_size=1, max_new_tokens=9)
        np.testing.assert_array_equal(tokens[:, 0].numpy(),
                                      te.generate(ids, max_new_tokens=9).numpy())

    @pytest.mark.parametrize("form", _FORMS[::2], ids=_FORM_IDS[::2])
    def test_zero_new_tokens(self, form):
        je, te = _engines(seed=14, **form)
        ids = _prompt(63, (2, 3))
        jt, js = je.beam_search(ids, beam_size=2, max_new_tokens=0)
        tt, ts = te.beam_search(ids, beam_size=2, max_new_tokens=0)
        assert tt.shape == np.asarray(jt).shape == (2, 2, 0)
        assert ts.shape == np.asarray(js).shape == (2, 2)

    def test_past_max_len_raises(self):
        _, te = _engines(seed=15)
        with pytest.raises(ValueError, match="exceeds"):
            te.beam_search(_prompt(64), beam_size=2, max_new_tokens=_MAXLEN)
