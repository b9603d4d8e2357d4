"""Flash attention of the PyTorch port against the JAX package's Pallas kernels
(forward, and the backward through ``jax.grad`` of the custom VJP).

The JAX side runs the Pallas kernel in interpret mode, as tests/test_pallas.py
does; the port side runs the wrapper on CPU tensors, which takes the plain
PyTorch version (the CUDA kernel itself is held to that version on the card
by chip_smoke.py). Same numpy inputs on both sides.
"""
import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from paddle_tpu.ops.pallas.flash_attention import flash_attention_fwd as jax_flash
from paddle_tpu_torch.ops.cuda import flash_attention as port_fa

# the module: ``paddle_tpu_torch.nn.functional.flash_attention`` as an
# attribute is the function of that name, as in the JAX package
port_F = importlib.import_module("paddle_tpu_torch.nn.functional.flash_attention")
# the autograd node torch.library gives the forward op
# (``paddle_tpu_torch::flash_attention_fwd``, whose backward is the backward op)
_FWD_OP_NODE = "GeneratedBackwardFor_paddle_tpu_torch_flash_attention_fwd_defaultBackward"


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")


def _qkv(seed, B, Sq, Sk, Hq, Hkv, D):
    r = np.random.RandomState(seed)
    return (r.randn(B, Sq, Hq, D).astype(np.float32),
            r.randn(B, Sk, Hkv, D).astype(np.float32),
            r.randn(B, Sk, Hkv, D).astype(np.float32))


def _both(q, k, v, causal):
    ref = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               causal=causal))
    out = port_fa.flash_attention_fwd(torch.from_numpy(q), torch.from_numpy(k),
                                      torch.from_numpy(v), causal=causal)
    return out.numpy(), ref


class TestPlainVersionMatchesPallas:
    # the four shapes of tests/test_pallas.py, at its tolerance
    @pytest.mark.parametrize("B,S,Hq,Hkv,D,causal", [
        (2, 256, 4, 4, 64, True),
        (2, 256, 4, 2, 64, True),     # GQA
        (1, 128, 2, 2, 32, False),
        (1, 384, 2, 1, 64, True),     # MQA, non-pow2 seq blocks
        (2, 256, 4, 2, 32, True),     # causal GQA at head dim 32
    ])
    def test_forward(self, B, S, Hq, Hkv, D, causal):
        out, ref = _both(*_qkv(0, B, S, S, Hq, Hkv, D), causal)
        np.testing.assert_allclose(out, ref, rtol=2e-5, atol=2e-5)

    def test_cross_length_causal_bottom_right(self):
        # Sq < Sk causal aligns bottom-right (tests/test_pallas.py TestCrossLengthCausal)
        out, ref = _both(*_qkv(3, 1, 128, 256, 2, 2, 64), True)
        np.testing.assert_allclose(out, ref, rtol=2e-5, atol=2e-5)

    def test_counter_untouched_on_cpu(self):
        before = port_fa.launches
        _both(*_qkv(5, 1, 128, 128, 2, 2, 32), True)
        assert port_fa.launches == before


def _grads_both(seed, B, Sq, Sk, Hq, Hkv, D, causal):
    """(port dq, dk, dv), (JAX dq, dk, dv) of sum(O * G) for a random G."""
    q, k, v = _qkv(seed, B, Sq, Sk, Hq, Hkv, D)
    g = np.random.RandomState(seed + 100).randn(B, Sq, Hq, D).astype(np.float32)
    ref = jax.grad(lambda q, k, v: jnp.sum(jax_flash(q, k, v, causal=causal) * g),
                   (0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    port_fa.flash_attention_fwd(tq, tk, tv, causal=causal).backward(torch.from_numpy(g))
    return [t.grad.numpy() for t in (tq, tk, tv)], [np.asarray(r) for r in ref]


class TestBackwardMatchesPallas:
    # the four shapes of tests/test_pallas.py and cross-length causal, at its
    # backward tolerance
    @pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D,causal", [
        (2, 256, 256, 4, 4, 64, True),
        (2, 256, 256, 4, 2, 64, True),     # GQA
        (1, 128, 128, 2, 2, 32, False),
        (1, 384, 384, 2, 1, 64, True),     # MQA
        (1, 128, 256, 2, 2, 64, True),     # cross-length, bottom-right
        (2, 256, 256, 4, 2, 32, True),     # causal GQA at head dim 32
    ])
    def test_gradients(self, B, Sq, Sk, Hq, Hkv, D, causal):
        out, ref = _grads_both(7, B, Sq, Sk, Hq, Hkv, D, causal)
        for name, o, r in zip(("dq", "dk", "dv"), out, ref):
            np.testing.assert_allclose(o, r, rtol=1e-3, atol=1e-3, err_msg=name)

    @pytest.mark.parametrize("causal", [True, False])
    def test_plain_backward_is_autograd_of_plain_forward(self, causal):
        q, k, v = (torch.from_numpy(a).requires_grad_() for a in _qkv(8, 2, 96, 160, 4, 2, 32))
        g = torch.from_numpy(np.random.RandomState(9).randn(2, 96, 4, 32).astype(np.float32))
        out, lse = port_fa.flash_attention_fwd_plain(q, k, v, causal)
        out.backward(g)
        got = port_fa.flash_attention_bwd_plain(q.detach(), k.detach(), v.detach(),
                                                out.detach(), lse.detach(), g, causal)
        for name, a, t in zip(("dq", "dk", "dv"), got, (q, k, v)):
            assert a.shape == t.shape and a.dtype == t.dtype
            np.testing.assert_allclose(a.numpy(), t.grad.numpy(), rtol=1e-5, atol=1e-5,
                                       err_msg=name)

    def test_output_carries_the_function_on_cpu(self):
        q, k, v = (torch.from_numpy(a).requires_grad_() for a in _qkv(5, 1, 64, 64, 2, 2, 32))
        out, lse = port_fa.flash_attention_fwd_lse(q, k, v, causal=True)
        assert out.grad_fn is not None
        assert type(out.grad_fn).__name__ == _FWD_OP_NODE
        assert not lse.requires_grad

    def test_backward_counters_untouched_on_cpu(self):
        before = (port_fa.launches, port_fa.launches_bwd_dq, port_fa.launches_bwd_dkv)
        _grads_both(5, 1, 128, 128, 2, 2, 32, True)
        after = (port_fa.launches, port_fa.launches_bwd_dq, port_fa.launches_bwd_dkv)
        assert after == before

    def test_non_contiguous_head_dim_of_do_is_refused(self):
        q, k, v = (torch.from_numpy(a) for a in _qkv(6, 1, 16, 16, 2, 2, 64))
        out, lse = port_fa.flash_attention_fwd_lse(q, k, v, causal=True)
        do = torch.zeros(1, 16, 2, 128)[..., ::2]
        delta = port_fa._delta(out, do)
        with pytest.raises(port_fa.FlashShapeError, match="head dim"):
            port_fa._check_bwd_inputs(q, k, v, do, lse, delta)


class TestHeadDims96And256:
    """Phi-3-mini's head dim (96), Gemma-2B's (256) and one the kernels pad
    (80): the plain forward and backward against the Pallas kernels in
    interpret mode, at tests/test_pallas.py's tolerances (forward 2e-5,
    gradients 1e-3)."""

    CASES = [
        # B, Sq, Sk, Hq, Hkv, D, causal
        (1, 128, 128, 4, 4, 96, True),
        (2, 128, 128, 4, 2, 96, False),     # GQA 2:1
        (1, 256, 256, 4, 1, 256, True),     # GQA 4:1, as Gemma-2B's one KV head
        (1, 128, 256, 2, 2, 80, True),      # cross-length, bottom-right
    ]

    @pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D,causal", CASES)
    def test_forward(self, B, Sq, Sk, Hq, Hkv, D, causal):
        out, ref = _both(*_qkv(11, B, Sq, Sk, Hq, Hkv, D), causal)
        np.testing.assert_allclose(out, ref, rtol=2e-5, atol=2e-5)

    @pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D,causal", CASES)
    def test_gradients(self, B, Sq, Sk, Hq, Hkv, D, causal):
        out, ref = _grads_both(12, B, Sq, Sk, Hq, Hkv, D, causal)
        for name, o, r in zip(("dq", "dk", "dv"), out, ref):
            np.testing.assert_allclose(o, r, rtol=1e-3, atol=1e-3, err_msg=name)


class TestPadToNativeHeadDim:
    """On the card a head dim the kernels are not built for is zero-padded to
    the next one they are (``_at_native_dim``), and autograd slices the
    gradients back. Run here with the plain versions in the kernels' place:
    the padded function equals the unpadded plain one, forward and
    gradients, at 1e-5 (fp32; the padded columns add exact zeros)."""

    @pytest.mark.parametrize("D,native", [(80, 96), (17, 32), (100, 128), (200, 256),
                                          (96, 96)])
    def test_forward_and_gradients_equal_the_unpadded_plain_version(self, D, native):
        assert port_fa._native_dim(D) == native
        qn, kn, vn = _qkv(13, 2, 40, 56, 4, 2, D)
        g = torch.from_numpy(np.random.RandomState(14).randn(2, 40, 4, D).astype(np.float32))
        ref = [torch.from_numpy(a).requires_grad_() for a in (qn, kn, vn)]
        ref_out, ref_lse = port_fa.flash_attention_fwd_plain(*ref, True)
        ref_out.backward(g)
        got = [torch.from_numpy(a).requires_grad_() for a in (qn, kn, vn)]
        before = port_fa.pads_for_head_dim
        out, lse = port_fa._at_native_dim(*got, True, 1.0 / np.sqrt(D))
        assert port_fa.pads_for_head_dim - before == (0 if D == native else 3)
        assert out.shape == (2, 40, 4, D)
        out.backward(g)
        np.testing.assert_allclose(out.detach().numpy(), ref_out.detach().numpy(),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(lse.numpy(), ref_lse.detach().numpy(), rtol=1e-5, atol=1e-5)
        for name, t, r in zip(("dq", "dk", "dv"), got, ref):
            assert t.grad.shape == r.grad.shape
            np.testing.assert_allclose(t.grad.numpy(), r.grad.numpy(), rtol=1e-5, atol=1e-5,
                                       err_msg=name)

    def test_card_kernels_see_the_native_dim(self, monkeypatch):
        """On the card at D = 80 the three launchers (stubbed with the plain
        versions) get q, k, v, O and dO at D = 96; O and the gradients come
        back at 80, equal to the plain version's."""
        seen = []

        def fwd(q, k, v, causal, scale):
            seen.append(("fwd", q.shape[-1], scale))
            return port_fa.flash_attention_fwd_plain(q, k, v, causal, scale)

        def dq(q, k, v, do, out, lse, causal, scale):
            seen.append(("dq", do.shape[-1], scale))
            grads[:] = port_fa.flash_attention_bwd_plain(q, k, v, out, lse, do, causal, scale)
            return grads[0], port_fa._delta(out, do)

        def dkv(q, k, v, do, lse, delta, causal, scale):
            seen.append(("dkv", do.shape[-1], scale))
            return grads[1], grads[2]

        grads = []
        qn, kn, vn = _qkv(15, 1, 32, 32, 4, 2, 80)
        g = torch.from_numpy(np.random.RandomState(16).randn(1, 32, 4, 80).astype(np.float32))
        ref = [torch.from_numpy(a).requires_grad_() for a in (qn, kn, vn)]
        ref_out = port_fa.flash_attention_fwd_plain(*ref, True)[0]
        ref_out.backward(g)
        monkeypatch.setattr(port_fa, "_launch", fwd)
        monkeypatch.setattr(port_fa, "_launch_bwd_dq", dq)
        monkeypatch.setattr(port_fa, "_launch_bwd_dkv", dkv)
        monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
        got = [torch.from_numpy(a).requires_grad_() for a in (qn, kn, vn)]
        out = port_fa.flash_attention_fwd(*got, causal=True)
        out.backward(g)
        monkeypatch.undo()
        scale = 1.0 / np.sqrt(80)
        assert [(n, d) for n, d, _ in seen] == [("fwd", 96), ("dq", 96), ("dkv", 96)]
        assert all(abs(s - scale) < 1e-12 for _, _, s in seen)
        assert out.shape == (1, 32, 4, 80)
        np.testing.assert_allclose(out.detach().numpy(), ref_out.detach().numpy(), rtol=1e-5,
                                   atol=1e-5)
        for name, t, r in zip(("dq", "dk", "dv"), got, ref):
            assert t.grad.shape == r.grad.shape
            np.testing.assert_allclose(t.grad.numpy(), r.grad.numpy(), rtol=1e-5, atol=1e-5,
                                       err_msg=name)

    def test_above_256_takes_the_math_path_on_the_card(self, monkeypatch):
        def launched(*a):
            raise AssertionError("a kernel launched for D = 288")

        monkeypatch.setattr(port_fa, "_launch", launched)
        q, k, v = (torch.from_numpy(a) for a in _qkv(17, 1, 128, 128, 2, 2, 288))
        ref = port_F._math_sdpa(q, k, v, causal=True)
        monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
        with pytest.raises(port_fa.FlashShapeError, match="up to 256"):
            port_fa.flash_attention_fwd(q, k, v, causal=True)
        out = port_F._sdpa(q, k, v, causal=True, use_kernel=True)
        monkeypatch.undo()
        np.testing.assert_array_equal(out.numpy(), ref.numpy())


class TestLSE:
    @pytest.mark.parametrize("causal", [True, False])
    def test_lse_is_logsumexp_of_math_scores(self, causal):
        q, k, v = _qkv(1, 2, 96, 160, 4, 2, 32)
        _, lse = port_fa.flash_attention_fwd_lse(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=causal)
        qt = q.transpose(0, 2, 1, 3).astype(np.float64)
        kt = np.repeat(k.transpose(0, 2, 1, 3), 2, axis=1).astype(np.float64)
        s = qt @ kt.transpose(0, 1, 3, 2) / np.sqrt(32)
        if causal:
            s = np.where(np.tril(np.ones((96, 160), bool), k=160 - 96), s, -1e30)
        m = s.max(-1, keepdims=True)
        ref = (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]
        assert lse.shape == (2, 4, 96) and lse.dtype == torch.float32
        np.testing.assert_allclose(lse.numpy(), ref, rtol=2e-5, atol=2e-5)


class TestShapePolicy:
    def test_gqa_heads_not_divisible(self):
        q, k, v = (torch.from_numpy(a) for a in _qkv(0, 1, 16, 16, 3, 2, 8))
        with pytest.raises(ValueError, match="not divisible"):
            port_fa.flash_attention_fwd(q, k, v)
        with pytest.raises(ValueError, match="not divisible"):
            jax_flash(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()), jnp.asarray(v.numpy()))

    def test_causal_needs_sq_le_sk(self):
        q, k, v = (torch.from_numpy(a) for a in _qkv(0, 1, 32, 16, 2, 2, 8))
        with pytest.raises(ValueError, match="Sq<=Sk"):
            port_fa.flash_attention_fwd(q, k, v, causal=True)
        with pytest.raises(ValueError, match="Sq<=Sk"):
            jax_flash(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
                      jnp.asarray(v.numpy()), causal=True)

    def test_policy_error_is_the_dispatcher_fallback_type(self):
        assert issubclass(port_fa.FlashShapeError, ValueError)

    @pytest.mark.parametrize("D", [32, 64, 96, 128, 256])
    def test_kernel_head_dims(self, D):
        q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _qkv(0, 1, 16, 16, 2, 2, D))
        port_fa._check_kernel_inputs(q, k, v)

    @pytest.mark.parametrize("D", [16, 288, 512])
    def test_other_head_dims_raise(self, D):
        q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _qkv(0, 1, 16, 16, 2, 2, D))
        with pytest.raises(port_fa.FlashShapeError, match="head_dim"):
            port_fa._check_kernel_inputs(q, k, v)

    def test_backward_kernels_take_64_and_128(self):
        # ... and 32, 96 and 256: every head dim the forward kernel takes has
        # a backward
        for D in (32, 64, 96, 128, 256):
            q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
                       for a in _qkv(0, 1, 16, 16, 2, 2, D))
            out, lse = port_fa.flash_attention_fwd_lse(q, k, v, causal=True)
            delta = port_fa._delta(out, q)
            port_fa._check_bwd_inputs(q, k, v, q, lse, delta, out=out)

    @pytest.mark.parametrize("D", [16, 288, 512])
    def test_backward_refuses_other_head_dims(self, D):
        q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _qkv(0, 1, 16, 16, 2, 2, D))
        lse = torch.zeros(1, 2, 16)
        with pytest.raises(port_fa.FlashShapeError, match="head_dim"):
            port_fa._check_bwd_inputs(q, k, v, q, lse, out=q)

    def test_d32_with_gradient_on_the_card_takes_the_math_path(self, monkeypatch):
        """No longer: at D = 32 a forward that wants a gradient on the card
        reaches the forward op, whose backward runs the dq and dk/dv
        launchers (stubbed here with the plain versions), never the math
        path."""
        calls = []

        def fwd(q, k, v, causal, scale):
            calls.append("fwd")
            return port_fa.flash_attention_fwd_plain(q, k, v, causal, scale)

        def dq(q, k, v, do, out, lse, causal, scale):
            calls.append("dq")
            got = port_fa.flash_attention_bwd_plain(q, k, v, out, lse, do, causal, scale)
            return got[0], port_fa._delta(out, do)

        def dkv(q, k, v, do, lse, delta, causal, scale):
            calls.append("dkv")
            assert delta.shape == lse.shape and delta.dtype == torch.float32
            return saved["dk"], saved["dv"]

        def math_path(*a, **kw):
            raise AssertionError("the math path ran for a D = 32 forward with a gradient")

        qn, kn, vn = _qkv(0, 1, 16, 16, 2, 2, 32)
        g = torch.from_numpy(np.random.RandomState(1).randn(1, 16, 2, 32).astype(np.float32))
        ref = [torch.from_numpy(a).requires_grad_() for a in (qn, kn, vn)]
        port_fa.flash_attention_fwd_plain(*ref, True)[0].backward(g)
        saved = dict(dk=ref[1].grad, dv=ref[2].grad)
        monkeypatch.setattr(port_fa, "_launch", fwd)
        monkeypatch.setattr(port_fa, "_launch_bwd_dq", dq)
        monkeypatch.setattr(port_fa, "_launch_bwd_dkv", dkv)
        monkeypatch.setattr(port_F, "_math_sdpa", math_path)
        q, k, v = (torch.from_numpy(a).requires_grad_() for a in (qn, kn, vn))
        monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
        out = port_F._sdpa(q, k, v, causal=True, use_kernel=True)
        assert type(out.grad_fn).__name__ == _FWD_OP_NODE
        out.backward(g)
        monkeypatch.undo()
        assert calls == ["fwd", "dq", "dkv"]
        for t, r in zip((q, k, v), ref):
            np.testing.assert_allclose(t.grad.numpy(), r.grad.numpy(), rtol=1e-5, atol=1e-5)

    def test_plain_delta_is_the_jax_delta(self):
        # delta = rowsum(dO * O) as the JAX package's _bwd computes it in XLA,
        # (B, Hq, Sq) beside (B, Hq, Sq, 1) there
        r = np.random.RandomState(3)
        out = r.randn(2, 48, 4, 32).astype(np.float32)
        do = r.randn(2, 48, 4, 32).astype(np.float32)
        ref = np.asarray(jnp.sum(jnp.asarray(do).astype(jnp.float32) *
                                 jnp.asarray(out).astype(jnp.float32), axis=-1))
        got = port_fa._delta(torch.from_numpy(out), torch.from_numpy(do))
        assert got.shape == (2, 4, 48) and got.dtype == torch.float32 and got.is_contiguous()
        np.testing.assert_allclose(got.numpy(), ref.transpose(0, 2, 1), rtol=2e-5, atol=2e-5)


class TestAlignmentCopy:
    """TMA reads q, k and v through tensor maps: a 16-byte-aligned base and
    strides that are multiples of 16 bytes. The wrapper copies what is not
    (and counts it); these run on CPU tensors, where the decision is the same."""

    def test_contiguous_and_strided_views_are_read_in_place(self):
        x = torch.zeros(2, 64, 3, 4, 32, dtype=torch.bfloat16)
        assert not port_fa._needs_alignment_copy(x[:, :, 1])             # k of a packed qkv slab
        assert not port_fa._needs_alignment_copy(torch.zeros(2, 16, 4, 128).transpose(1, 2))

    def test_misaligned_base_or_stride_needs_a_copy(self):
        flat = torch.zeros(1 + 2 * 16 * 4 * 64, dtype=torch.bfloat16)
        assert port_fa._needs_alignment_copy(flat[1:].view(2, 16, 4, 64))  # base + 2 bytes
        odd = torch.zeros(2, 16, 4, 68, dtype=torch.bfloat16)[..., :64]   # 136-byte rows
        assert port_fa._needs_alignment_copy(odd)
        expanded = torch.zeros(1, 16, 4, 64).expand(2, 16, 4, 64)         # batch stride 0
        assert port_fa._needs_alignment_copy(expanded)

    def test_size_one_dims_have_free_strides(self):
        # batch and head of size 1 with odd strides: never stepped over
        t = torch.zeros(16 * 64, dtype=torch.bfloat16).as_strided((1, 16, 1, 64), (7, 64, 3, 1))
        assert not port_fa._needs_alignment_copy(t)
        assert port_fa._strides(t) == [64, 64, 64]

    def test_copy_is_counted_and_equal(self):
        flat = torch.arange(1 + 2 * 16 * 4 * 64, dtype=torch.float32).to(torch.bfloat16)
        view = flat[1:].view(2, 16, 4, 64)
        before = port_fa.copies_for_alignment
        got = port_fa._tma_ready(view)
        assert port_fa.copies_for_alignment == before + 1
        assert got.data_ptr() % 16 == 0 and got.is_contiguous() and torch.equal(got, view)
        aligned = torch.zeros(2, 16, 4, 64, dtype=torch.bfloat16)
        assert port_fa._tma_ready(aligned) is aligned
        assert port_fa.copies_for_alignment == before + 1


class TestDispatcher:
    def test_cpu_tensor_takes_the_math_path(self, monkeypatch):
        calls = []

        def spy(*a, **kw):
            calls.append(a)
            return port_fa.flash_attention_fwd(*a, **kw)

        monkeypatch.setattr(port_F, "flash_attention_fwd", spy)
        q, k, v = (torch.from_numpy(a) for a in _qkv(2, 1, 256, 256, 4, 2, 32))
        assert not port_F._use_kernel(q)
        out = port_F.scaled_dot_product_attention(q, k, v, is_causal=True)
        assert calls == []
        ref = port_F._math_sdpa(q, k, v, causal=True)
        np.testing.assert_array_equal(out.numpy(), ref.numpy())

    def test_math_path_matches_jax_math_path(self):
        from paddle_tpu.nn.functional.flash_attention import _math_sdpa as jax_math

        q, k, v = _qkv(4, 2, 64, 96, 4, 2, 32)
        ref = np.asarray(jax_math(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  causal=True))
        out = port_F._math_sdpa(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), causal=True)
        np.testing.assert_allclose(out.numpy(), ref, rtol=2e-5, atol=2e-5)

    def test_only_the_policy_error_falls_back(self, monkeypatch):
        q, k, v = (torch.from_numpy(a) for a in _qkv(2, 1, 16, 16, 2, 2, 8))

        def refuse(*a, **kw):
            raise port_fa.FlashShapeError("unsupported")

        def broken(*a, **kw):
            raise RuntimeError("launch failed")

        monkeypatch.setattr(port_F, "flash_attention_fwd", refuse)
        out = port_F._sdpa(q, k, v, causal=True, use_kernel=True)
        np.testing.assert_array_equal(out.numpy(),
                                      port_F._math_sdpa(q, k, v, causal=True).numpy())
        monkeypatch.setattr(port_F, "flash_attention_fwd", broken)
        with pytest.raises(RuntimeError, match="launch failed"):
            port_F._sdpa(q, k, v, causal=True, use_kernel=True)
