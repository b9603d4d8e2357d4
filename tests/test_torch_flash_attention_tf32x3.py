"""The fp32 flash-attention kernels' arithmetic (3xTF32 on the tensor cores),
emulated in plain torch on the CPU and held against the JAX package's flash
attention in fp32: ``jax.grad`` of it for the backward kernels, its forward's
O and LSE for the forward kernel.

The kernels ``fa_bwd_dq_tf32`` and ``fa_bwd_dkv_tf32``
(``paddle_tpu_torch/csrc/flash_attention_bwd.cu``) and ``fa_fwd_tf32``
(``flash_attention_fwd.cu``) split each fp32 operand of a product a @ b in
two. The left one, a, lies in registers: hi = tf32(a), rounded to nearest with
ties away from zero (``cvt.rna``), and lo = a - hi. The right one, b, lies in
shared memory: hi is the fp32 word itself and lo = b - trunc(b), a plane the
block writes. The tensor cores read every word's top 19 bits (tf32 by
truncation). Each product accumulates a_hi b_lo, then a_lo b_hi, then a_hi
b_hi into its fp32 sum. The emulation does the rounding on the float32 bits,
the same splits and the same term order, inside a written-out FA2 backward
with the kernels' tiles (dq: 32-key tiles, delta = rowsum(dO O); dk/dv:
32-query tiles over every q head of a GQA group into one sum) and a
written-out online-softmax forward with the forward kernel's (64-key tiles,
16 at D = 256; exp2 of scores scaled by scale log2(e); P V with P split in
registers against V's hi and lo planes, keys in the kernel's permuted
contraction order), so it shows, without a card, that the split keeps the
kernels' fp32 accuracy: 1e-5 norm-relative to the JAX results, ten times
inside the 1e-4 the card's kernels are held to against the plain versions.
The JAX side runs the Pallas kernels in interpret mode, as
tests/test_torch_flash_attention.py does.
"""
import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from paddle_tpu.ops.pallas import flash_attention as jax_fa
from paddle_tpu.ops.pallas.flash_attention import flash_attention_fwd as jax_flash
from paddle_tpu_torch.ops.cuda import flash_attention as port_fa

TOL = 1e-5
TILE = 32  # keys of a dq tile, queries of a dk/dv tile (the kernels' kN below D = 256)


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")


def _tf32_rna(x):
    """float32 -> tf32 (10 mantissa bits), to nearest, ties away from zero,
    on the bits: add half of the 13 dropped bits' unit, then clear them."""
    bits = x.contiguous().view(torch.int32).to(torch.int64)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.to(torch.int32).view(torch.float32)


def _tf32_trunc(x):
    """The top 19 bits of each float32: what the tensor cores read of lo."""
    bits = x.contiguous().view(torch.int32) & ~0x1FFF
    return bits.view(torch.float32)


def _split_a(x):
    """A left operand in registers: (rna(x), x - rna(x)), as read."""
    hi = _tf32_rna(x)
    return hi, _tf32_trunc(x - hi)


def _split_b(x):
    """A right operand in shared memory: the word and its lo plane, as read."""
    hi = _tf32_trunc(x)
    return hi, _tf32_trunc(x - hi)


def _mma3(acc, a, b, passes=3):
    """acc + a @ b as the kernels take it: a_hi b_lo, a_lo b_hi, a_hi b_hi,
    each a float32 product of tf32 values added to the running sum in turn
    (``passes=1``: a_hi b_hi alone, one TF32 pass)."""
    ah, al = _split_a(a)
    bh, bl = _split_b(b)
    if passes == 3:
        acc = acc + ah @ bl
        acc = acc + al @ bh
    return acc + ah @ bh


def _visible(q0, nq, k0, nk, Sq, Sk, causal):
    """(nq, nk) mask: key t visible to query s (causal aligned bottom-right)."""
    s = torch.arange(q0, q0 + nq)[:, None]
    t = torch.arange(k0, k0 + nk)[None, :]
    ok = (s < Sq) & (t < Sk)
    return ok & (t <= s + (Sk - Sq)) if causal else ok


def _bwd_emulated(q, k, v, out, lse, do, causal, scale, passes=3):
    """(dq, dk, dv), (B, S, H, D) float32: the dq kernel's loop over key
    tiles and the dk/dv kernel's loop over q heads and q tiles, in 3xTF32."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    rep = Hq // Hkv
    qt, dot, ot = (x.transpose(1, 2) for x in (q, do, out))      # (B, Hq, Sq, D)
    kt, vt = (x.transpose(1, 2) for x in (k, v))                 # (B, Hkv, Sk, D)
    delta = (dot * ot).sum(-1)                                   # (B, Hq, Sq)
    kq, vq = (x.repeat_interleave(rep, dim=1) for x in (kt, vt))

    dq = torch.zeros(B, Hq, Sq, D)
    for k0 in range(0, Sk, TILE):
        kk, vv = kq[:, :, k0:k0 + TILE], vq[:, :, k0:k0 + TILE]
        n = kk.shape[2]
        s = _mma3(torch.zeros(B, Hq, Sq, n), qt, kk.transpose(-1, -2), passes)
        dp = _mma3(torch.zeros(B, Hq, Sq, n), dot, vv.transpose(-1, -2), passes)
        p = torch.exp(s * scale - lse[..., None])
        p = p.masked_fill(~_visible(0, Sq, k0, n, Sq, Sk, causal), 0.0)
        ds = p * (dp - delta[..., None]) * scale
        dq = _mma3(dq, ds, kk, passes)

    dk = torch.zeros(B, Hkv, Sk, D)
    dv = torch.zeros(B, Hkv, Sk, D)
    for r in range(rep):  # the group's q heads in turn, into one sum
        heads = [hk * rep + r for hk in range(Hkv)]
        for q0 in range(0, Sq, TILE):
            qq, oo = qt[:, heads, q0:q0 + TILE], dot[:, heads, q0:q0 + TILE]
            n = qq.shape[2]
            st = _mma3(torch.zeros(B, Hkv, Sk, n), kt, qq.transpose(-1, -2), passes)
            dpt = _mma3(torch.zeros(B, Hkv, Sk, n), vt, oo.transpose(-1, -2), passes)
            pt = torch.exp(st * scale - lse[:, heads, None, q0:q0 + n])
            pt = pt.masked_fill(~_visible(q0, n, 0, Sk, Sq, Sk, causal).T, 0.0)
            dst = pt * (dpt - delta[:, heads, None, q0:q0 + n]) * scale
            dv = _mma3(dv, pt, oo, passes)
            dk = _mma3(dk, dst, qq, passes)
    return dq.transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2)


def _inputs(seed, B, Sq, Sk, Hq, Hkv, D):
    r = np.random.RandomState(seed)
    return (r.randn(B, Sq, Hq, D).astype(np.float32), r.randn(B, Sk, Hkv, D).astype(np.float32),
            r.randn(B, Sk, Hkv, D).astype(np.float32), r.randn(B, Sq, Hq, D).astype(np.float32))


def _jax_grads(q, k, v, g, causal):
    grads = jax.grad(lambda q, k, v: jnp.sum(jax_flash(q, k, v, causal=causal) * g),
                     (0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(x) for x in grads]


def _emulated(q, k, v, g, causal, passes=3):
    tq, tk, tv, tg = (torch.from_numpy(a) for a in (q, k, v, g))
    out, lse = port_fa.flash_attention_fwd_plain(tq, tk, tv, causal)
    scale = 1.0 / math.sqrt(q.shape[-1])
    return [x.numpy() for x in _bwd_emulated(tq, tk, tv, out, lse, tg, causal, scale, passes)]


def _norm_rel(a, ref):
    return float(np.linalg.norm(a - ref) / np.linalg.norm(ref))


CASES = [
    # B, Sq, Sk, Hq, Hkv, D, causal
    (1, 128, 128, 2, 2, 32, True),
    (1, 256, 256, 2, 2, 64, False),
    (1, 128, 256, 2, 2, 96, True),      # cross-length, bottom-right
    (1, 256, 256, 2, 2, 128, True),
    (1, 128, 128, 2, 2, 128, False),
    (1, 128, 128, 2, 2, 256, True),
    (1, 256, 256, 2, 2, 256, False),
    (1, 256, 256, 4, 2, 64, True),      # GQA 2:1
]


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D,causal", CASES)
def test_emulated_kernels_match_jax_grad(B, Sq, Sk, Hq, Hkv, D, causal):
    q, k, v, g = _inputs(D + Sq + Hq, B, Sq, Sk, Hq, Hkv, D)
    ref = _jax_grads(q, k, v, g, causal)
    got = _emulated(q, k, v, g, causal)
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        assert a.shape == r.shape
        err = _norm_rel(a, r)
        assert err <= TOL, f"{name}: {err} > {TOL}"


def test_one_tf32_pass_misses_the_tolerance():
    """The same loops with a_hi b_hi alone (one TF32 pass, ~3 decimal digits)
    are far outside it: the tolerance tells the split from plain TF32."""
    q, k, v, g = _inputs(3, 1, 128, 128, 2, 2, 128)
    ref = _jax_grads(q, k, v, g, True)
    got = _emulated(q, k, v, g, True, passes=1)
    assert min(_norm_rel(a, r) for a, r in zip(got, ref)) > 10 * TOL


def test_tf32_rounding_is_to_nearest_ties_away():
    one = 1.0
    ulp = 2.0 ** -10
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - 2.0 ** -20,
                      one + 3 * ulp / 2, 0.0, -0.0, 3.0], dtype=torch.float32)
    want = [one + ulp, -(one + ulp), one, one + 2 * ulp, 0.0, -0.0, 3.0]
    assert _tf32_rna(x).tolist() == want


@pytest.mark.parametrize("split,bits", [(_split_a, 21), (_split_b, 20)])
def test_split_keeps_fp32(split, bits):
    """hi + lo as the tensor cores read them is within 2^-21 of x (a rounded
    hi leaves a lo of at most half a tf32 step) or 2^-20 (a truncated one)."""
    r = np.random.RandomState(0)
    x = torch.from_numpy((r.randn(4096) * 10.0 ** r.randint(-20, 20, 4096)).astype(np.float32))
    hi, lo = split(x)
    assert torch.all((hi.double() + lo.double() - x.double()).abs()
                     <= 2.0 ** -bits * x.double().abs())
    assert torch.all(_tf32_trunc(hi) == hi) and torch.all(_tf32_trunc(lo) == lo)


# ---------------------------------------------------------------------------
# the forward kernel (fa_fwd_tf32)
# ---------------------------------------------------------------------------
LOG2E = np.float32(1.4426950408889634)
LN2 = np.float32(0.6931471805599453)
# the contraction order of an 8-key step: the accumulator's columns 2 t and
# 2 t + 1 are A positions t and t + 4, and V^T's planes hold keys in that order
PERM = (0, 2, 4, 6, 1, 3, 5, 7)


def _fwd_tile(D):
    """Keys of the forward kernel's K/V tile (F32FwdLayout::kN)."""
    return 16 if D > 128 else 64


def _fwd_emulated(q, k, v, causal, scale, passes=3):
    """(O (B, Sq, Hq, D), LSE (B, Hq, Sq)), float32: the forward kernel's loop
    over key tiles (zero-filled past Sk, as TMA fills them) in 3xTF32, with
    the online softmax in log2 units as the kernel keeps it."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    rep = Hq // Hkv
    n = _fwd_tile(D)
    qt = q.transpose(1, 2)
    kq, vq = (x.transpose(1, 2).repeat_interleave(rep, dim=1) for x in (k, v))
    pad = -Sk % n
    kq, vq = (torch.nn.functional.pad(x, (0, 0, 0, pad)) for x in (kq, vq))
    order = (torch.arange(0, n, 8)[:, None] + torch.tensor(PERM)).reshape(-1)
    scale_log2 = float(np.float32(np.float32(scale) * LOG2E))
    m = torch.full((B, Hq, Sq), -1e30)
    lsum = torch.zeros(B, Hq, Sq)
    o = torch.zeros(B, Hq, Sq, D)
    for k0 in range(0, Sk, n):
        kk, vv = kq[:, :, k0:k0 + n], vq[:, :, k0:k0 + n]
        s = _mma3(torch.zeros(B, Hq, Sq, n), qt, kk.transpose(-1, -2), passes) * scale_log2
        s = s.masked_fill(~_visible(0, Sq, k0, n, Sq, Sk, causal), -1e30)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new[..., None])
        lsum = lsum * alpha + p.sum(-1)
        o = _mma3(o * alpha[..., None], p[..., order], vv[:, :, order], passes)
        m = m_new
    lsum = lsum.clamp(min=1e-30)
    return (o / lsum[..., None]).transpose(1, 2), (m + torch.log2(lsum)) * float(LN2)


def _jax_fwd(q, k, v, causal, scale):
    """JAX's (O (B, Sq, Hq, D), LSE (B, Hq, Sq)): the Pallas forward kernel in
    interpret mode, one block over each sequence."""
    qt, kt, vt = (jnp.swapaxes(jnp.asarray(x), 1, 2) for x in (q, k, v))
    out, lse = jax_fa._fwd(qt, kt, vt, np.float32(scale), causal, q.shape[1], k.shape[1])
    return np.asarray(jnp.swapaxes(out, 1, 2)), np.asarray(lse[..., 0])


def _fwd_case(B, Sq, Sk, Hq, Hkv, D, causal, passes=3):
    r = np.random.RandomState(D + Sq + Sk + Hq)
    q = r.randn(B, Sq, Hq, D).astype(np.float32)
    k, v = (r.randn(B, Sk, Hkv, D).astype(np.float32) for _ in range(2))
    scale = 1.0 / math.sqrt(D)
    ref = _jax_fwd(q, k, v, causal, scale)
    got = _fwd_emulated(*(torch.from_numpy(x) for x in (q, k, v)), causal, scale, passes)
    return [x.numpy() for x in got], ref


FWD_CASES = [
    # B, Sq, Sk, Hq, Hkv, D, causal
    (1, 128, 128, 2, 2, 32, True),
    (1, 200, 200, 2, 2, 32, False),     # ragged last tile (64-key tiles)
    (1, 256, 256, 2, 2, 64, True),
    (1, 100, 300, 4, 2, 64, False),     # GQA 2:1, Sq != Sk, ragged
    (1, 128, 256, 2, 2, 96, True),      # cross-length, bottom-right
    (2, 256, 256, 2, 2, 128, True),
    (1, 128, 128, 2, 2, 128, False),
    (1, 300, 700, 4, 1, 128, True),     # MQA, ragged, bottom-right
    (1, 128, 128, 2, 2, 256, True),     # 16-key tiles
    (1, 200, 333, 4, 2, 256, False),    # 16-key tiles, GQA, ragged
]


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D,causal", FWD_CASES)
def test_emulated_forward_matches_jax(B, Sq, Sk, Hq, Hkv, D, causal):
    (out, lse), (ref_out, ref_lse) = _fwd_case(B, Sq, Sk, Hq, Hkv, D, causal)
    assert out.shape == ref_out.shape and lse.shape == ref_lse.shape
    err = _norm_rel(out, ref_out)
    assert err <= TOL, f"O: {err} > {TOL}"
    lse_err = float(np.max(np.abs(lse - ref_lse) / np.maximum(1.0, np.abs(ref_lse))))
    assert lse_err <= TOL, f"LSE: {lse_err} > {TOL}"


def test_forward_one_tf32_pass_misses_the_tolerance():
    """The forward with a_hi b_hi alone in both products is far outside it."""
    (out, _), (ref_out, _) = _fwd_case(1, 256, 256, 2, 2, 128, True, passes=1)
    assert _norm_rel(out, ref_out) > 10 * TOL


def _vt_planes(v8):
    """V^T's hi plane for the 8 keys of one k8 step as the forward kernel
    writes it: 16-byte chunk c of row d holds keys 2 e + c (e = 0..3) of the
    step, so position 4 c + e of row d is key 2 e + c."""
    D = v8.shape[1]
    vt = torch.empty(D, 8, dtype=v8.dtype)
    for d in range(D):
        for c in range(2):
            for e in range(4):
                vt[d, 4 * c + e] = v8[2 * e + c, d]
    return vt


@pytest.mark.parametrize("D", [32, 128])
def test_pv_fragments_pair_with_vt_planes(D):
    """P V as the kernel runs it: a warp's 16 x 8 slice of P as the S
    accumulator lies (thread 4 g + t holds rows g, g + 8 at columns 2 t,
    2 t + 1) is the A fragment a0..a3 = elements 0, 2, 1, 3 (rows g, g + 8 at
    k positions t, t + 4); against V^T's planes, whose row d holds the keys
    in the same order, the product is P V."""
    r = np.random.RandomState(D)
    p = torch.from_numpy(r.rand(16, 8)).double()
    v = torch.from_numpy(r.randn(8, D)).double()
    a = torch.empty(16, 8, dtype=torch.float64)
    for g in range(8):
        for t in range(4):
            elem = [p[g + 8 * (e >> 1), 2 * t + (e & 1)] for e in range(4)]
            a0, a1, a2, a3 = elem[0], elem[2], elem[1], elem[3]
            a[g, t], a[g + 8, t], a[g, t + 4], a[g + 8, t + 4] = a0, a1, a2, a3
    b = _vt_planes(v).T  # B[k][n] = V^T[n][k]
    torch.testing.assert_close(a @ b, p @ v, rtol=1e-14, atol=1e-14)


def test_pv_split_keeps_fp32():
    """P split in registers (rna) against V's hi and lo planes, three passes
    a k8 step in the kernel's order, is within fp32 rounding of the float64
    product; one pass (a_hi b_hi) is not."""
    r = np.random.RandomState(1)
    p = torch.from_numpy(np.exp(-3 * r.rand(64, 32)).astype(np.float32))
    v = torch.from_numpy(r.randn(32, 128).astype(np.float32))
    ref = p.double() @ v.double()
    scale = ref.abs().max().item()
    for passes, ok in ((3, True), (1, False)):
        acc = torch.zeros(64, 128)
        for kc in range(0, 32, 8):
            acc = _mma3(acc, p[:, kc:kc + 8], v[kc:kc + 8], passes)
        err = (acc.double() - ref).abs().max().item() / scale
        assert (err <= 2.0 ** -19) == ok, (passes, err)
