"""The attention functionals of the PyTorch port against the JAX package's:
``flash_attention``, ``flash_attn_unpadded`` (and its segment-masked
``_varlen``), the packed wrappers, ``sdp_kernel`` and the rotate-every-two
rotary pairing of ``fused_rotary_position_embedding``.

Same numpy inputs on both sides; the JAX side on the CPU (its math path), the
port on CPU tensors (its plain versions). fp32 unless a case says otherwise.
"""
import importlib

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as jax_F
from paddle_tpu.incubate.nn.functional import (
    fused_rotary_position_embedding as jax_rope)
from paddle_tpu.incubate.nn.functional import _rope_tables as jax_rope_tables
from paddle_tpu.models.llama import _rope_cos_sin as jax_rope_cos_sin
import paddle_tpu_torch.nn.functional as F
from paddle_tpu_torch.incubate.nn.functional import (_rope_tables, _rotate_every_two,
                                                     fused_rotary_position_embedding)
from paddle_tpu_torch.models import llama_decode
from paddle_tpu_torch.models.llama import apply_rotary_pos_emb

port_F = importlib.import_module("paddle_tpu_torch.nn.functional.flash_attention")


def _arrays(seed, *shapes, dtype=np.float32):
    r = np.random.RandomState(seed)
    return [r.randn(*s).astype(dtype) for s in shapes]


def _jax(x):
    return paddle.to_tensor(x)


def _np(t):
    return np.asarray(t.numpy(), np.float32)


class TestFlashAttention:
    # the JAX function on its math path (CPU), the port's on its plain one:
    # fp32, 2e-5 (the tolerance of tests/test_pallas.py's forward)
    @pytest.mark.parametrize("B,S,Hq,Hkv,D,causal", [
        (2, 16, 4, 4, 32, True),
        (2, 24, 4, 2, 96, False),     # GQA at Phi-3-mini's head dim
        (1, 20, 2, 1, 256, True),     # MQA at Gemma-2B's head dim
    ])
    def test_matches_jax(self, B, S, Hq, Hkv, D, causal):
        q, k, v = _arrays(0, (B, S, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D))
        ref, ref_sm = jax_F.flash_attention(_jax(q), _jax(k), _jax(v), causal=causal)
        out, sm = F.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal)
        assert ref_sm is None and sm is None
        np.testing.assert_allclose(out.numpy(), _np(ref), rtol=2e-5, atol=2e-5)

    def test_return_softmax_still_returns_none(self):
        q, k, v = (torch.from_numpy(a) for a in _arrays(1, *[(1, 8, 2, 16)] * 3))
        out, sm = F.flash_attention(q, k, v, return_softmax=True)
        assert sm is None and out.shape == (1, 8, 2, 16)

    def test_is_sdpa_and_reaches_the_kernel_path(self, monkeypatch):
        """A CUDA query of 128 or more rows goes where sdpa sends it: the
        flash-attention wrapper (here a spy), not the math path."""
        calls = []

        def spy(q, k, v, causal=False, scale=None):
            calls.append((tuple(q.shape), causal))
            return port_F._math_sdpa(q, k, v, causal=causal)

        q, k, v = (torch.from_numpy(a) for a in _arrays(2, *[(1, 128, 2, 32)] * 3))
        monkeypatch.setattr(port_F, "flash_attention_fwd", spy)
        monkeypatch.setattr(port_F, "_use_kernel", lambda q: q.shape[1] >= 128)
        out, _ = F.flash_attention(q, k, v, causal=True)
        assert calls == [((1, 128, 2, 32), True)]
        np.testing.assert_array_equal(
            out.numpy(), F.scaled_dot_product_attention(q, k, v, is_causal=True).numpy())

    def test_dropout_outside_training_is_off(self):
        q, k, v = (torch.from_numpy(a) for a in _arrays(3, *[(1, 8, 2, 16)] * 3))
        a, _ = F.flash_attention(q, k, v, dropout=0.5, training=False)
        b, _ = F.flash_attention(q, k, v)
        np.testing.assert_array_equal(a.numpy(), b.numpy())


# three ragged sequences packed into one: lengths 5, 11, 8
_CU = np.array([0, 5, 16, 24], np.int32)


def _varlen_inputs(seed, H=2, D=16, dtype=np.float32):
    return _arrays(seed, (24, H, D), (24, H, D), (24, H, D), dtype=dtype)


def _loop_reference(q, k, v, cu, causal):
    """Attention of each sequence alone (the plain sdpa), concatenated."""
    outs = []
    for a, b in zip(cu[:-1], cu[1:]):
        qs, ks, vs = (torch.from_numpy(x[a:b])[None] for x in (q, k, v))
        outs.append(port_F._math_sdpa(qs, ks, vs, causal=causal)[0])
    return torch.cat(outs).numpy()


class TestFlashAttnUnpadded:
    @pytest.mark.parametrize("causal", [False, True])
    def test_matches_jax(self, causal):
        q, k, v = _varlen_inputs(4)
        ref, _ = jax_F.flash_attn_unpadded(_jax(q), _jax(k), _jax(v), _jax(_CU), _jax(_CU),
                                           11, 11, causal=causal)
        out, none = F.flash_attn_unpadded(*(torch.from_numpy(a) for a in (q, k, v)),
                                          torch.from_numpy(_CU), torch.from_numpy(_CU), 11,
                                          11, causal=causal)
        assert none is None and out.shape == (24, 2, 16)
        np.testing.assert_allclose(out.numpy(), _np(ref), rtol=2e-5, atol=2e-5)

    @pytest.mark.parametrize("causal", [False, True])
    def test_equals_a_loop_over_the_sequences(self, causal):
        q, k, v = _varlen_inputs(5)
        out, _ = F.flash_attn_unpadded(*(torch.from_numpy(a) for a in (q, k, v)), _CU, _CU,
                                       11, 11, causal=causal)
        np.testing.assert_allclose(out.numpy(), _loop_reference(q, k, v, _CU, causal),
                                   rtol=2e-5, atol=2e-5)

    def test_scale_and_bfloat16_match_jax(self):
        # bf16 logits and probabilities, as in JAX: one bf16 step (2**-8) apart
        q, k, v = _varlen_inputs(6)
        args = [a.astype(np.float32) for a in (q, k, v)]
        ref, _ = jax_F.flash_attn_unpadded(
            *(_jax(a).astype("bfloat16") for a in args), _jax(_CU), _jax(_CU), 11, 11,
            scale=0.3, causal=True)
        out, _ = F.flash_attn_unpadded(*(torch.from_numpy(a).to(torch.bfloat16) for a in args),
                                       _CU, _CU, 11, 11, scale=0.3, causal=True)
        assert out.dtype == torch.bfloat16
        np.testing.assert_allclose(out.float().numpy(), _np(ref.astype("float32")),
                                   rtol=1e-2, atol=1e-2)

    def test_segment_ids_are_jax_segment_ids(self):
        # an empty sequence puts two marks on one row; the last boundary
        # (== total) is dropped, as JAX's scatter drops it
        cu = np.array([0, 3, 3, 7, 9, 9], np.int32)
        seg = port_F._segment_ids(torch.from_numpy(cu), 9, "cpu")
        ref = jnp.cumsum(jnp.zeros(9, jnp.int32).at[jnp.asarray(cu)[1:-1]].add(1))
        np.testing.assert_array_equal(seg.numpy(), np.asarray(ref))

    def test_varlen_op_matches_jax(self):
        from paddle_tpu.nn.functional.flash_attention import _varlen as jax_varlen

        q, k, v = _varlen_inputs(7, H=3, D=96)
        seg = np.repeat(np.arange(3), [5, 11, 8]).astype(np.int32)
        ref = jax_varlen(_jax(q), _jax(k), _jax(v), _jax(seg), _jax(seg), causal=True)
        t = torch.from_numpy(seg)
        out = port_F._varlen(*(torch.from_numpy(a) for a in (q, k, v)), t, t, causal=True)
        np.testing.assert_allclose(out.numpy(), _np(ref), rtol=2e-5, atol=2e-5)


class TestPackedWrappers:
    @pytest.mark.parametrize("causal", [False, True])
    def test_qkvpacked_matches_jax(self, causal):
        (qkv,) = _arrays(8, (2, 16, 3, 4, 32))
        ref, _ = jax_F.flash_attn_qkvpacked(_jax(qkv), causal=causal)
        out, none = F.flash_attn_qkvpacked(torch.from_numpy(qkv), causal=causal)
        assert none is None
        np.testing.assert_allclose(out.numpy(), _np(ref), rtol=2e-5, atol=2e-5)

    @pytest.mark.parametrize("causal", [False, True])
    def test_varlen_qkvpacked_matches_jax(self, causal):
        (qkv,) = _arrays(9, (24, 3, 2, 16))
        ref, _ = jax_F.flash_attn_varlen_qkvpacked(_jax(qkv), _jax(_CU), 11, causal=causal)
        out, none = F.flash_attn_varlen_qkvpacked(torch.from_numpy(qkv), torch.from_numpy(_CU),
                                                  11, causal=causal)
        assert none is None
        np.testing.assert_allclose(out.numpy(), _np(ref), rtol=2e-5, atol=2e-5)


class TestSdpKernel:
    def test_is_a_context_manager_that_changes_nothing(self):
        flags = (torch.backends.cuda.flash_sdp_enabled(),
                 torch.backends.cuda.mem_efficient_sdp_enabled(),
                 torch.backends.cuda.math_sdp_enabled())
        q, k, v = (torch.from_numpy(a) for a in _arrays(10, *[(1, 8, 2, 16)] * 3))
        plain = F.scaled_dot_product_attention(q, k, v, is_causal=True)
        with F.sdp_kernel(enable_flash=False, enable_math=True) as got:
            assert got is None
            inside = F.scaled_dot_product_attention(q, k, v, is_causal=True)
            assert (torch.backends.cuda.flash_sdp_enabled(),
                    torch.backends.cuda.mem_efficient_sdp_enabled(),
                    torch.backends.cuda.math_sdp_enabled()) == flags
        np.testing.assert_array_equal(inside.numpy(), plain.numpy())
        with jax_F.sdp_kernel(enable_flash=False):  # the JAX one takes the same arguments
            pass


class TestRotaryEveryTwo:
    """use_neox_rotary_style=True (the default): the interleaved pairing, held
    to the JAX function at 1e-5 (fp32)."""

    def _qkv(self, seed=0, D=16):
        return _arrays(seed, *[(2, 8, 4, D)] * 3)

    def _jax(self, *arrs, **kw):
        args = [None if a is None else paddle.to_tensor(a) for a in arrs]
        kw = {k: paddle.to_tensor(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
        return [None if o is None else o.numpy() for o in jax_rope(*args, **kw)]

    def _port(self, *arrs, **kw):
        args = [None if a is None else torch.from_numpy(a) for a in arrs]
        kw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
        return [None if o is None else o.numpy()
                for o in fused_rotary_position_embedding(*args, **kw)]

    def _close(self, out, ref):
        assert len(out) == len(ref) == 3
        for o, r in zip(out, ref):
            assert (o is None) == (r is None)
            if o is not None:
                np.testing.assert_allclose(o, r, rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("D", [16, 96])
    def test_default_tables(self, D):
        q, k, v = self._qkv(D=D)
        self._close(self._port(q, k, v), self._jax(q, k, v))
        self._close(self._port(q, k), self._jax(q, k, use_neox_rotary_style=True))

    def test_position_ids(self):
        q, k, _ = self._qkv(1)
        pos = np.random.RandomState(2).randint(0, 50, (2, 8)).astype("int64")
        self._close(self._port(q, k, position_ids=pos), self._jax(q, k, position_ids=pos))

    @pytest.mark.parametrize("layout", ["S,D", "B,S,D", "1,S,1,D"])
    def test_user_tables(self, layout):
        q, k, _ = self._qkv(3)
        r = np.random.RandomState(4)
        shape = {"S,D": (8, 16), "B,S,D": (2, 8, 16), "1,S,1,D": (1, 8, 1, 16)}[layout]
        cos, sin = (r.randn(*shape).astype(np.float32) for _ in range(2))
        self._close(self._port(q, k, sin=sin, cos=cos), self._jax(q, k, sin=sin, cos=cos))

    def test_fixed_slots_and_v_rotated(self):
        q, _, v = self._qkv(5)
        out, ref = self._port(q, None, v), self._jax(q, None, v)
        self._close(out, ref)
        assert out[1] is None
        np.testing.assert_allclose(out[2][:, 0], v[:, 0], rtol=1e-5)   # position 0
        assert not np.allclose(out[2][:, 1:], v[:, 1:])

    def test_rotate_every_two_and_tables_match_jax(self):
        (x,) = _arrays(6, (2, 3, 8))
        np.testing.assert_array_equal(
            _rotate_every_two(torch.from_numpy(x)).numpy(),
            np.asarray(jnp.stack([-x[..., 1::2], x[..., ::2]], -1).reshape(x.shape)))
        for every_two in (True, False):
            cos, sin = _rope_tables(8, 16, 10000.0, torch.float32, "cpu", every_two=every_two)
            jc, js = jax_rope_tables(8, 16, 10000.0, jnp.float32, every_two=every_two)
            np.testing.assert_allclose(cos.numpy(), np.asarray(jc), rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(sin.numpy(), np.asarray(js), rtol=1e-6, atol=1e-6)

    def test_bfloat16_tables_cast_before_the_product(self):
        q, k, _ = (a.astype(np.float32) for a in self._qkv(7))
        ref = jax_rope(paddle.to_tensor(q).astype("bfloat16"),
                       paddle.to_tensor(k).astype("bfloat16"))
        out = fused_rotary_position_embedding(torch.from_numpy(q).to(torch.bfloat16),
                                              torch.from_numpy(k).to(torch.bfloat16))
        for o, r in zip(out[:2], ref[:2]):
            assert o.dtype == torch.bfloat16
            np.testing.assert_allclose(o.float().numpy(), _np(r.astype("float32")),
                                       rtol=1e-2, atol=1e-2)


class TestFusedRopeSemantics:
    """The port's counterparts of tests/test_models.py::TestFusedRopeSemantics
    (fixed slots, v rotation, the neox flag's pairing, 4-D tables)."""

    def _qkv(self):
        r = np.random.RandomState(0)
        return tuple(torch.from_numpy(r.randn(2, 8, 4, 16).astype("float32"))
                     for _ in range(3))

    def test_slots_fixed_when_k_none(self):
        q, _, v = self._qkv()
        oq, ok, ov = fused_rotary_position_embedding(q, None, v)
        assert ok is None and ov is not None
        np.testing.assert_allclose(ov.numpy()[:, 0], v.numpy()[:, 0], rtol=1e-5)
        assert not np.allclose(ov.numpy()[:, 1:], v.numpy()[:, 1:])

    def test_styles_differ_and_half_matches_llama(self):
        q, k, _ = self._qkv()
        q_h, k_h, _ = fused_rotary_position_embedding(q, k, use_neox_rotary_style=False)
        q_i, _, _ = fused_rotary_position_embedding(q, k, use_neox_rotary_style=True)
        assert not np.allclose(q_h.numpy(), q_i.numpy())
        cos, sin = (torch.from_numpy(np.asarray(t))
                    for t in jax_rope_cos_sin(8, 16, 10000.0, jnp.float32))
        q2, k2 = apply_rotary_pos_emb(q, k, cos, sin)
        np.testing.assert_allclose(q_h.numpy(), q2.numpy(), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(k_h.numpy(), k2.numpy(), rtol=1e-5, atol=1e-5)

    def test_4d_sin_cos_tables(self):
        q, k, _ = self._qkv()
        cos, sin = (torch.from_numpy(np.asarray(t))[None, :, None, :]
                    for t in jax_rope_cos_sin(8, 16, 10000.0, jnp.float32))
        ref, _, _ = fused_rotary_position_embedding(q, k, use_neox_rotary_style=False)
        got, _, _ = fused_rotary_position_embedding(q, k, sin=sin, cos=cos,
                                                    use_neox_rotary_style=False)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)


def _half_tables(positions, head_dim, theta):
    """The rotate-half tables as the port computed them before the every-two
    layout came (float32 throughout)."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32)
                                / head_dim))
    freqs = positions.to(torch.float32)[..., None] * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos(), emb.sin()


class TestServingTablesStayRotateHalf:
    """The decode and serving engines build their tables through
    ``_rope_tables``, whose default is now the every-two layout (the JAX
    default): they ask for the half layout by name, so their tables are bit
    for bit what they were, and the JAX LLaMA's rotate-half tables within
    1e-6 (fp32 cos and sin of XLA and torch differ in the last bits)."""

    def test_prompt_tables(self):
        cos, sin = _rope_tables(12, 96, 10000.0, torch.float32, "cpu", every_two=False)
        old = _half_tables(torch.arange(12), 96, 10000.0)
        assert torch.equal(cos, old[0]) and torch.equal(sin, old[1])
        jc, js = jax_rope_cos_sin(12, 96, 10000.0, jnp.float32)
        np.testing.assert_allclose(cos.numpy(), np.asarray(jc), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(sin.numpy(), np.asarray(js), rtol=1e-6, atol=1e-6)

    def test_row_tables(self):
        pos = torch.tensor([0, 3, 11, 7])
        cos, sin = llama_decode._row_rope_tables(pos, 96, 10000.0, torch.float32, "cpu")
        old = _half_tables(pos[:, None], 96, 10000.0)
        assert torch.equal(cos, old[0]) and torch.equal(sin, old[1])
        jc, js = jax_rope_cos_sin(12, 96, 10000.0, jnp.float32)
        np.testing.assert_allclose(cos[:, 0].numpy(), np.asarray(jc)[pos.numpy()], rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(sin[:, 0].numpy(), np.asarray(js)[pos.numpy()], rtol=1e-6,
                                   atol=1e-6)
