"""The port's incubate surface (paddle_tpu_torch/incubate: the fused
functionals and layers, asp, the graph ops, softmax_mask_fuse*,
identity_loss) and paddle_tpu_torch/geometric.py against the JAX package's.

Each functional case is written once and called with each package as ``P``
on the same numpy inputs from a seed (``check_functional`` of
test_torch_nn_common.py: outputs, dtypes and the gradients of
``sum(out * ct)``); each layer case builds the layer in both packages, carries
the JAX ``state_dict`` into the port's and compares outputs and gradients
(``check_layer``). float32 throughout: rtol 1e-5 with atol 1e-6, or 1e-5 for
the cases that chain several products (the transformer functionals and
layers). The host-numpy parts (asp's masks, reindexing, the samplers with one
seed given to both) are compared bit for bit. The functions whose JAX version
works on raw arrays (``fused_moe``, ``masked_multihead_attention``, the cached
``fused_multi_transformer``) carry no JAX gradient, so their cases compare
outputs only. The dropout variants draw from the port's generator: they are
held to what does not depend on the draw.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as T
from test_torch_nn_common import check_functional, check_layer
from test_torch_ops import A, I, N, U, _np, _on_cpu  # noqa: F401

TOL = 1e-5           # rtol and atol of the chained-product cases


def IF(P):
    return P.incubate.nn.functional


def C(name, fn, inputs, grad=True, rtol=1e-5, atol=1e-6):
    return pytest.param(fn, inputs, grad, rtol, atol, id=name)


E, H, D, B, S, FF = 16, 4, 4, 2, 5, 32


def _mha(P, x, qkv_w, lin_w, ln_s, ln_b, **kw):
    return IF(P).fused_multi_head_attention(
        x, qkv_w, lin_w, ln_scale=ln_s, ln_bias=ln_b, pre_ln_scale=ln_s, pre_ln_bias=ln_b,
        dropout_rate=0.0, attn_dropout_rate=0.0, **kw)


def _ffn(P, x, w1, w2, b1, b2, s, b, **kw):
    return IF(P).fused_feedforward(x, w1, w2, linear1_bias=b1, linear2_bias=b2, ln1_scale=s,
                                   ln1_bias=b, ln2_scale=s, ln2_bias=b, dropout1_rate=0.0,
                                   dropout2_rate=0.0, **kw)


def _stack(P, x, qkv_w, lin_w, s, b, w1, w2, qkv_b, lin_b, b1, b2, **kw):
    """Two layers sharing weights; a None weight or bias is a None list."""
    def two(w):
        return None if w is None else [w] * 2

    return IF(P).fused_multi_transformer(
        x, two(s), two(b), two(qkv_w), two(qkv_b), two(lin_w), two(lin_b), two(s), two(b),
        two(w1), two(b1), two(w2), two(b2), **kw)


def _rotary(B_, T_, D_):
    """A [2, B, T, 1, D] cos/sin table of per-row position offsets."""
    pos = np.arange(T_)[None, :] + np.arange(B_)[:, None] * 3
    inv = 1.0 / (10000 ** (np.arange(0, D_, 2) / D_))
    ang = np.repeat(pos[..., None] * inv, 2, axis=-1)
    return np.stack([np.cos(ang), np.sin(ang)])[:, :, :, None, :].astype("float32")


def W(*shape):
    """A weight: uniform in +-0.25, so that chained products stay O(1)."""
    return U(shape, -0.25, 0.25)


MMHA_T = 6
QKV = [W(3, H, D, E), W(E, E)]
LN = [U((E,), 0.5, 1.5), N(E)]

FUNCTIONAL = [
    C("fused_rms_norm", lambda P, x, w, b: IF(P).fused_rms_norm(x, w, b), [N(2, 3, 8), N(8),
                                                                           N(8)]),
    C("fused_rms_norm_axis", lambda P, x, w: IF(P).fused_rms_norm(x, w, begin_norm_axis=1,
                                                                  epsilon=1e-5),
      [N(2, 3, 8), N(3, 8)]),
    C("fused_layer_norm", lambda P, x, w, b: IF(P).fused_layer_norm(x, w, b), [N(2, 3, 8),
                                                                               N(8), N(8)]),
    C("fused_layer_norm_residual", lambda P, x, r, w: IF(P).fused_layer_norm(
        x, w, None, residual=r), [N(4, 8), N(4, 8), N(8)]),
    C("fused_linear", lambda P, x, w, b: IF(P).fused_linear(x, w, b), [N(3, 4, 6), N(6, 5),
                                                                       N(5)]),
    C("fused_linear_transposed", lambda P, x, w: IF(P).fused_linear(x, w, transpose_weight=True),
      [N(3, 6), N(5, 6)]),
    *[C(f"fused_bias_act_{m}", lambda P, x, b, _m=m: IF(P).fused_bias_act(x, b, act_method=_m),
        [N(3, 8), N(8)]) for m in ("gelu", "relu", "swiglu", "silu")],
    C("fused_matmul_bias", lambda P, x, y, b: IF(P).fused_matmul_bias(
        x, y, b, transpose_x=True, transpose_y=True), [N(6, 3), N(5, 6), N(5)]),
    *[C(f"fused_linear_activation_{a}", lambda P, x, y, b, _a=a: IF(P).fused_linear_activation(
        x, y, b, activation=_a), [N(3, 6), N(6, 5), N(5)]) for a in ("relu", "gelu", "silu",
                                                                     None)],
    C("swiglu", lambda P, x: IF(P).swiglu(x), [N(3, 8)]),
    C("fused_gate_attention_merged", lambda P, q, w, gw, gb, ow, ob, nb, m: IF(P)
      .fused_gate_attention(q, qkv_weight=w, gate_linear_weight=gw, gate_linear_bias=gb,
                            out_linear_weight=ow, out_linear_bias=ob, nonbatched_bias=nb,
                            attn_mask=m),
      [N(1, 2, 5, 8), W(3, 2, 4, 8), W(8, 2, 4), N(2, 4), W(2, 4, 6), N(6), N(1, 2, 5, 5),
       N(1, 2, 1, 1, 5)]),
    C("fused_gate_attention_unmerged", lambda P, q, k, wq, wk, wv, ow: IF(P)
      .fused_gate_attention(q, k, query_weight=wq, key_weight=wk, value_weight=wv,
                            out_linear_weight=ow, has_gating=False, merge_qkv=False),
      [N(1, 2, 5, 8), N(1, 2, 7, 8), W(8, 2, 4), W(8, 2, 4), W(8, 2, 4), W(2, 4, 8)]),
    C("fused_dot_product_attention", lambda P, q, k, v: IF(P).fused_dot_product_attention(
        q, k, v, is_causal=True), [N(2, 6, 2, 8), N(2, 6, 2, 8), N(2, 6, 2, 8)]),
    C("fused_dot_product_attention_mask", lambda P, q, k, v, m: IF(P)
      .fused_dot_product_attention(q, k, v, attn_mask=m), [N(2, 6, 2, 8), N(2, 6, 2, 8),
                                                           N(2, 6, 2, 8), N(2, 1, 6, 6)]),
    C("varlen_attention", lambda P, q, k, v, lens: IF(P)
      .variable_length_memory_efficient_attention(q, k, v, lens, lens),
      [N(2, 2, 8, 4), N(2, 2, 8, 4), N(2, 2, 8, 4), A(np.array([5, 3], "int32"))]),
    C("varlen_attention_causal_kv_lens", lambda P, q, k, v, sl, kl: IF(P)
      .variable_length_memory_efficient_attention(q, k, v, sl, kl, causal=True, scale=0.3),
      [N(2, 2, 8, 4), N(2, 2, 8, 4), N(2, 2, 8, 4), A(np.array([8, 8], "int32")),
       A(np.array([6, 8], "int32"))]),
    C("varlen_attention_additive_mask", lambda P, q, k, v, lens, m: IF(P)
      .variable_length_memory_efficient_attention(q, k, v, lens, lens, mask=m),
      [N(2, 2, 8, 4), N(2, 2, 8, 4), N(2, 2, 8, 4), A(np.array([5, 7], "int32")),
       N(2, 1, 8, 8)]),
    C("varlen_attention_bool_mask", lambda P, q, k, v, lens, m: IF(P)
      .variable_length_memory_efficient_attention(q, k, v, lens, lens, mask=m),
      [N(2, 2, 8, 4), N(2, 2, 8, 4), N(2, 2, 8, 4), A(np.array([5, 7], "int32")),
       A(np.tril(np.ones((1, 1, 8, 8), bool)))]),
    C("fused_moe_gelu", lambda P, x, g, w1, w2, b1, b2: IF(P).fused_moe(
        x, g, w1, w2, b1, b2, moe_topk=2), [N(2, 3, 8), N(8, 4), W(4, 8, 6), W(4, 6, 8),
                                            W(4, 6), W(4, 8)], grad=False),
    C("fused_moe_swiglu_unnormed", lambda P, x, g, w1, w2: IF(P).fused_moe(
        x, g, w1, w2, moe_topk=3, norm_topk_prob=False), [N(2, 3, 8), N(8, 4), W(4, 8, 12),
                                                          W(4, 6, 8)], grad=False),
    C("fused_bias_dropout_residual_layer_norm", lambda P, x, r, b, s, lb: IF(P)
      .fused_bias_dropout_residual_layer_norm(x, r, b, s, lb, dropout_rate=0.0),
      [N(2, 3, 8), N(2, 3, 8), N(8), U((8,), 0.5, 1.5), N(8)]),
    C("fused_bias_dropout_residual_layer_norm_eval", lambda P, x, r: IF(P)
      .fused_bias_dropout_residual_layer_norm(x, r, training=False), [N(2, 3, 8), N(2, 3, 8)]),
    C("fused_mha_post_ln", lambda P, x, w, lw, s, b: _mha(P, x, w, lw, s, b),
      [N(B, S, E), *QKV, *LN], atol=TOL),
    C("fused_mha_pre_ln_biases", lambda P, x, w, lw, s, b, qb, lb: _mha(
        P, x, w, lw, s, b, pre_layer_norm=True, qkv_bias=qb, linear_bias=lb),
      [N(B, S, E), *QKV, *LN, W(3, H, D), W(E)], atol=TOL),
    C("fused_mha_mask_eval", lambda P, x, w, lw, m: IF(P).fused_multi_head_attention(
        x, w, lw, attn_mask=m, training=False), [N(B, S, E), *QKV, N(B, 1, S, S)], atol=TOL),
    C("fused_mha_cache_kv", lambda P, x, w, lw, c: _mha(P, x, w, lw, None, None, cache_kv=c),
      [N(B, S, E), *QKV, N(2, B, H, 3, D)], atol=TOL),
    C("fused_mha_no_residual", lambda P, x, w, lw: _mha(P, x, w, lw, None, None,
                                                       add_residual=False),
      [N(B, S, E), *QKV], atol=TOL),
    C("fused_feedforward_post_ln", lambda P, x, w1, w2, b1, b2, s, b: _ffn(
        P, x, w1, w2, b1, b2, s, b, activation="gelu"),
      [N(B, S, E), W(E, FF), W(FF, E), W(FF), W(E), *LN], atol=TOL),
    C("fused_feedforward_pre_ln_relu", lambda P, x, w1, w2, b1, b2, s, b: _ffn(
        P, x, w1, w2, b1, b2, s, b, pre_layer_norm=True),
      [N(B, S, E), W(E, FF), W(FF, E), W(FF), W(E), *LN], atol=TOL),
    C("fused_feedforward_no_residual", lambda P, x, w1, w2: _ffn(
        P, x, w1, w2, None, None, None, None, add_residual=False, training=False),
      [N(B, S, E), W(E, FF), W(FF, E)], atol=TOL),
    C("fused_multi_transformer", lambda P, x, w, lw, s, b, w1, w2, qb, lb, b1, b2: _stack(
        P, x, w, lw, s, b, w1, w2, qb, lb, b1, b2),
      [N(B, S, E), *QKV, *LN, W(E, FF), W(FF, E), W(3, H, D), W(E), W(FF), W(E)], atol=TOL),
    C("fused_multi_transformer_post_ln_mask", lambda P, x, w, lw, s, b, w1, w2, m: _stack(
        P, x, w, lw, s, b, w1, w2, None, None, None, None, pre_layer_norm=False, attn_mask=m,
        activation="relu"), [N(B, S, E), *QKV, *LN, W(E, FF), W(FF, E), N(B, 1, S, S)],
      atol=TOL),
    C("fused_multi_transformer_cached_prefill", lambda P, x, w, lw, s, b, w1, w2, qb, c: _stack(
        P, x, w, lw, s, b, w1, w2, qb, None, None, None, cache_kvs=[c, c]),
      [N(B, S, E), *QKV, *LN, W(E, FF), W(FF, E), W(3, H, D), N(2, B, H, 8, D)], grad=False,
      atol=TOL),
    C("fused_multi_transformer_cached_decode", lambda P, x, w, lw, s, b, w1, w2, c, t: _stack(
        P, x, w, lw, s, b, w1, w2, None, None, None, None, cache_kvs=[c, c], time_step=t),
      [N(B, 1, E), *QKV, *LN, W(E, FF), W(FF, E), N(2, B, H, 8, D), A(np.array([5]))],
      grad=False, atol=TOL),
    C("masked_mha", lambda P, x, c, sl: IF(P).masked_multihead_attention(
        x, cache_kv=c, sequence_lengths=sl), [N(B, 3 * E), N(2, B, H, MMHA_T, D),
                                              A(np.array([2, 4], "int32"))], grad=False),
    C("masked_mha_bias_src_mask", lambda P, x, c, sl, bias, m: IF(P).masked_multihead_attention(
        x, cache_kv=c, bias=bias, src_mask=m, sequence_lengths=sl),
      [N(B, 3 * E), N(2, B, H, MMHA_T, D), A(np.array([5, 0], "int32")), N(3 * E),
       N(B, 1, 1, MMHA_T)], grad=False),
    *[C(f"masked_mha_rotary_{'neox' if neox else 'interleaved'}",
        lambda P, x, c, sl, rot, _n=neox: IF(P).masked_multihead_attention(
            x, cache_kv=c, sequence_lengths=sl, rotary_tensor=rot, rotary_emb_dims=1,
            use_neox_rotary_style=_n),
        [N(B, 3 * E), N(2, B, H, MMHA_T, D), A(np.array([3, 1], "int32")),
         A(_rotary(B, MMHA_T, D))], grad=False) for neox in (False, True)],
    C("blha_get_max_len", lambda P, e, d: IF(P).blha_get_max_len(e, d),
      [A(np.array([3, 9, 2])), A(np.array([1, 7, 2]))], grad=False),
    C("softmax_mask_fuse", lambda P, x, m: P.incubate.softmax_mask_fuse(x, m),
      [N(2, 2, 5, 5), N(2, 1, 5, 5)]),
    C("softmax_mask_fuse_upper_triangle", lambda P, x: P.incubate
      .softmax_mask_fuse_upper_triangle(x), [N(2, 2, 5, 5)]),
    *[C(f"identity_loss_{r}", lambda P, x, _r=r: P.incubate.identity_loss(x, _r), [N(3, 4)])
      for r in ("none", "sum", "mean", 0, 1)],
]


@pytest.mark.parametrize("fn,inputs,grad,rtol,atol", FUNCTIONAL)
def test_functional_matches_jax(fn, inputs, grad, rtol, atol):
    check_functional(fn, inputs, grad=grad, rtol=rtol, atol=atol)


# -- geometric and the incubate graph ops -------------------------------------------
def G(P):
    return P.geometric


IDS = A(np.array([0, 0, 3, 1, 3, 3, 0]))       # segment 2 is empty
SRC, DST = A(np.array([0, 1, 2, 0, 4, 4, 3])), A(np.array([1, 2, 1, 0, 0, 4, 1]))

GEOMETRIC = [
    *[C(f"segment_{op}", lambda P, x, i, _op=op: getattr(G(P), f"segment_{op}")(x, i),
        [N(7, 3), IDS]) for op in ("sum", "mean", "max", "min")],
    *[C(f"segment_{op}_count", lambda P, x, i, _op=op: getattr(G(P), f"segment_{op}")(
        x, i, count=6), [N(7, 3), IDS]) for op in ("sum", "mean", "max", "min")],
    C("segment_max_int", lambda P, x, i: G(P).segment_max(x, i), [I((7, 2), -5, 5), IDS],
      grad=False),
    *[C(f"incubate_segment_{op}", lambda P, x, i, _op=op: getattr(P.incubate,
                                                                   f"segment_{op}")(x, i),
        [N(7, 3), IDS]) for op in ("sum", "mean", "max", "min")],
    *[C(f"send_u_recv_{op}", lambda P, x, s, d, _op=op: G(P).send_u_recv(x, s, d, _op),
        [N(5, 3), SRC, DST]) for op in ("sum", "mean", "max", "min")],
    C("send_u_recv_out_size", lambda P, x, s, d: G(P).send_u_recv(x, s, d, "sum", out_size=7),
      [N(5, 3), SRC, DST]),
    *[C(f"graph_send_recv_{op}", lambda P, x, s, d, _op=op: P.incubate.graph_send_recv(
        x, s, d, pool_type=_op), [N(5, 3), SRC, DST]) for op in ("sum", "mean", "max", "min")],
    *[C(f"send_ue_recv_{m}_{r}", lambda P, x, e, s, d, _m=m, _r=r: G(P).send_ue_recv(
        x, e, s, d, _m, _r), [N(5, 3), N(7, 3), SRC, DST])
      for m in ("add", "mul") for r in ("sum", "mean", "max")],
    *[C(f"send_uv_{m}", lambda P, x, y, s, d, _m=m: G(P).send_uv(x, y, s, d, _m),
        [N(5, 3), U((5, 3), 0.5, 2.0), SRC, DST]) for m in ("add", "sub", "mul", "div")],
]


@pytest.mark.parametrize("fn,inputs,grad,rtol,atol", GEOMETRIC)
def test_geometric_matches_jax(fn, inputs, grad, rtol, atol):
    check_functional(fn, inputs, grad=grad, rtol=rtol, atol=atol)


def test_geometric_rejections_match_jax():
    x, s = np.ones((3, 2), "float32"), np.array([0, 1, 2])
    for P in (paddle, T):
        t = P.to_tensor(x, place="cpu")
        i = P.to_tensor(s, place="cpu")
        with pytest.raises(ValueError, match="reduce_op"):
            G(P).send_ue_recv(t, t, i, i, "add", "min")
        with pytest.raises(ValueError, match="message_op"):
            G(P).send_ue_recv(t, t, i, i, "sub")
        with pytest.raises(ValueError, match="message_op"):
            G(P).send_uv(t, t, i, i, "pow")


CSC = dict(row=np.array([3, 7, 0, 9, 1, 4, 2, 9, 3, 9, 1, 9, 7], "int64"),
           colptr=np.array([0, 2, 4, 5, 6, 7, 9, 11, 11, 13, 13], "int64"))


@pytest.fixture
def seeded_draws(monkeypatch):
    """One seed for every ``RandomState()`` the samplers build, in both
    packages, and for graph_ops' per-call seed draw (JAX's key stream, the
    port's generator)."""
    import jax

    from paddle_tpu_torch.incubate import graph_ops

    real = np.random.RandomState
    monkeypatch.setattr(np.random, "RandomState",
                        lambda seed=None: real(1234 if seed is None else seed))
    monkeypatch.setattr(jax.random, "randint", lambda *a, **k: np.int32(4321))
    monkeypatch.setattr(graph_ops, "_draw_seed", lambda: 4321)


def _both(fn):
    """fn(P, tensor) in both packages; outputs as numpy, compared bit for bit."""
    outs = []
    for P in (paddle, T):
        def t(a, _P=P):
            return _P.to_tensor(a, place="cpu")
        out = fn(P, t)
        outs.append([_np(o) for o in (out if isinstance(out, (tuple, list)) else [out])])
    assert len(outs[0]) == len(outs[1])
    for a, b in zip(*outs):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    return outs[1]


HOST_GRAPH = {
    "reindex_graph": lambda P, t: G(P).reindex_graph(
        t(np.array([0, 1, 2])), t(np.array([8, 9, 0, 4, 7, 6, 7])), t(np.array([2, 3, 2]))),
    "reindex_heter_graph": lambda P, t: G(P).reindex_heter_graph(
        t(np.array([0, 1, 2])), [t(np.array([8, 9, 0, 4, 7, 6, 7])), t(np.array([1, 5, 3]))],
        [t(np.array([2, 3, 2])), t(np.array([1, 1, 1]))]),
    "sample_neighbors": lambda P, t: G(P).sample_neighbors(
        t(CSC["row"]), t(CSC["colptr"]), t(np.array([0, 8, 1, 2, 6])), sample_size=1),
    "sample_neighbors_all_eids": lambda P, t: G(P).sample_neighbors(
        t(CSC["row"]), t(CSC["colptr"]), t(np.array([0, 8, 1])), eids=t(np.arange(13) + 100),
        return_eids=True),
    "weighted_sample_neighbors": lambda P, t: G(P).weighted_sample_neighbors(
        t(CSC["row"]), t(CSC["colptr"]), t(np.arange(1.0, 14.0, dtype="float32")),
        t(np.array([0, 6, 8, 5])), sample_size=1, eids=t(np.arange(13)), return_eids=True),
    "graph_sample_neighbors": lambda P, t: P.incubate.graph_sample_neighbors(
        t(CSC["row"]), t(CSC["colptr"]), t(np.array([0, 8, 1, 2, 6])), sample_size=1,
        eids=t(np.arange(13) + 50), return_eids=True),
    "graph_reindex": lambda P, t: P.incubate.graph_reindex(
        t(np.array([0, 1, 2])), t(np.array([8, 9, 0, 4, 7, 6, 7])), t(np.array([2, 3, 2]))),
    "graph_khop_sampler": lambda P, t: P.incubate.graph_khop_sampler(
        t(CSC["row"]), t(CSC["colptr"]), t(np.array([0, 8])), [2, 1]),
    "graph_khop_sampler_eids": lambda P, t: P.incubate.graph_khop_sampler(
        t(CSC["row"]), t(CSC["colptr"]), t(np.array([5, 1])), [1, 2, 1],
        sorted_eids=t(np.arange(13)), return_eids=True),
}


@pytest.mark.parametrize("name", sorted(HOST_GRAPH))
def test_host_graph_ops_equal_jax_bit_for_bit(name, seeded_draws):
    _both(HOST_GRAPH[name])


def test_graph_sample_neighbors_follows_paddle_seed():
    args = (torch.from_numpy(CSC["row"]), torch.from_numpy(CSC["colptr"]),
            torch.tensor([0, 1, 5, 6]))
    T.seed(3)
    a = T.incubate.graph_sample_neighbors(*args, sample_size=1)
    T.seed(3)
    b = T.incubate.graph_sample_neighbors(*args, sample_size=1)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    with pytest.raises(ValueError):
        T.geometric.weighted_sample_neighbors(*args[:2], torch.ones(13), args[2],
                                              return_eids=True)


# -- the cached generation contract, masked attention, fused_moe -----------------------
def _cached_inputs(seed=0, L=2, max_len=8, S_=4):
    r = np.random.RandomState(seed)
    w = dict(qkv=[(r.randn(3, H, D, E) * 0.2).astype("float32") for _ in range(L)],
             lin=[(r.randn(E, E) * 0.2).astype("float32") for _ in range(L)],
             w1=[(r.randn(E, FF) * 0.2).astype("float32") for _ in range(L)],
             w2=[(r.randn(FF, E) * 0.2).astype("float32") for _ in range(L)],
             s=[np.ones(E, "float32")] * L, b=[np.zeros(E, "float32")] * L)
    x = r.randn(B, S_, E).astype("float32")
    steps = [r.randn(B, 1, E).astype("float32") for _ in range(3)]
    caches = [np.zeros((2, B, H, max_len, D), "float32") for _ in range(L)]
    return w, x, steps, caches


def _run_cached(P, w, x, steps, caches):
    t = lambda a: P.to_tensor(a, place="cpu")  # noqa: E731
    ws = {k: [t(a) for a in v] for k, v in w.items()}
    cs = [t(c) for c in caches]
    given = [_np(c).copy() for c in cs]

    def call(xx, cc, ts=None):
        return IF(P).fused_multi_transformer(
            t(xx), ws["s"], ws["b"], ws["qkv"], None, ws["lin"], None, ws["s"], ws["b"],
            ws["w1"], None, ws["w2"], None, cache_kvs=cc, time_step=ts)

    outs = []
    out, cs2 = call(x, cs)
    outs.append(_np(out))
    for c, g in zip(cs, given):                   # the caller's caches are unchanged
        np.testing.assert_array_equal(_np(c), g)
    for i, xs in enumerate(steps):
        out, cs2 = call(xs, cs2, ts=np.array([x.shape[1] + i]))
        outs.append(_np(out))
    return outs, [_np(c) for c in cs2]


def test_cached_fused_multi_transformer_matches_jax_and_leaves_inputs():
    w, x, steps, caches = _cached_inputs()
    jo, jc = _run_cached(paddle, w, x, steps, caches)
    to, tc = _run_cached(T, w, x, steps, caches)
    for a, b in zip(to + tc, jo + jc):
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)
    # the last decode step equals the uncached causal forward's last row
    full = np.concatenate([x] + steps, axis=1)
    t = lambda a: T.to_tensor(a, place="cpu")  # noqa: E731
    ws = {k: [t(a) for a in v] for k, v in w.items()}
    mask = np.where(np.tril(np.ones((full.shape[1],) * 2, bool)), 0.0, -1e30).astype("float32")
    ref = T.incubate.nn.functional.fused_multi_transformer(
        t(full), ws["s"], ws["b"], ws["qkv"], None, ws["lin"], None, ws["s"], ws["b"],
        ws["w1"], None, ws["w2"], None, attn_mask=t(mask[None, None]))
    np.testing.assert_allclose(to[-1][:, 0], _np(ref)[:, -1], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("case", ["time_step_no_cache", "overflow", "mask", "training",
                                  "two_tokens", "rotary", "trans_qkvw", "unknown_kw"])
def test_fused_multi_transformer_refusals_match_jax(case):
    w, x, _, caches = _cached_inputs(max_len=4, L=1)
    errs = []
    for P in (paddle, T):
        t = lambda a, _P=P: _P.to_tensor(a, place="cpu")  # noqa: E731
        ws = {k: [t(a) for a in v] for k, v in w.items()}
        cs = [t(c) for c in caches]
        kw = {"time_step_no_cache": dict(time_step=np.array([1])),
              "overflow": dict(cache_kvs=cs, time_step=np.array([4])),
              "mask": dict(cache_kvs=cs, attn_mask=t(np.zeros((1, 1, 4, 4), "float32"))),
              "training": dict(cache_kvs=cs, training=True),
              "two_tokens": dict(cache_kvs=cs, time_step=np.array([1])),
              "rotary": dict(rotary_embs=t(np.zeros(2, "float32"))),
              "trans_qkvw": dict(trans_qkvw=False),
              "unknown_kw": dict(bogus=1)}[case]
        xx = x[:, :2] if case == "two_tokens" else x[:, :1] if case == "overflow" else x
        with pytest.raises(Exception) as e:
            IF(P).fused_multi_transformer(
                t(xx), ws["s"], ws["b"], ws["qkv"], None, ws["lin"], None, ws["s"], ws["b"],
                ws["w1"], None, ws["w2"], None, **kw)
        errs.append((type(e.value), str(e.value)))
    assert errs[0] == errs[1]


@pytest.mark.parametrize("case", ["no_lengths", "no_cache", "past_cache", "past_rotary",
                                  "rotary_dims_2", "rotary_missing", "rotary_unused",
                                  "beam_offset", "quant", "bad_src_mask"])
def test_masked_mha_exceptions_match_jax(case):
    r = np.random.RandomState(3)
    x, c = r.randn(B, 3 * E).astype("float32"), r.randn(2, B, H, MMHA_T, D).astype("float32")
    rot = _rotary(B, 4, D)
    errs = []
    for P in (paddle, T):
        t = lambda a, _P=P: _P.to_tensor(a, place="cpu")  # noqa: E731
        sl = np.array([1, 2], "int32")
        kw = {"no_lengths": dict(cache_kv=t(c)),
              "no_cache": dict(sequence_lengths=sl),
              "past_cache": dict(cache_kv=t(c), sequence_lengths=np.array([1, MMHA_T])),
              "past_rotary": dict(cache_kv=t(c), sequence_lengths=np.array([1, 4]),
                                  rotary_tensor=t(rot), rotary_emb_dims=1),
              "rotary_dims_2": dict(cache_kv=t(c), sequence_lengths=sl, rotary_emb_dims=2),
              "rotary_missing": dict(cache_kv=t(c), sequence_lengths=sl, rotary_emb_dims=1),
              "rotary_unused": dict(cache_kv=t(c), sequence_lengths=sl, rotary_tensor=t(rot)),
              "beam_offset": dict(cache_kv=t(c), sequence_lengths=sl,
                                  beam_cache_offset=t(sl)),
              "quant": dict(cache_kv=t(c), sequence_lengths=sl, out_scale=2.0),
              "bad_src_mask": dict(cache_kv=t(c), sequence_lengths=sl,
                                   src_mask=t(np.zeros((B, 1, 1, 3), "float32")))}[case]
        with pytest.raises(Exception) as e:
            IF(P).masked_multihead_attention(t(x), **kw)
        errs.append((type(e.value), str(e.value)))
    assert errs[0] == errs[1]


def test_masked_mha_leaves_the_cache_and_lengths_on_a_tensor():
    r = np.random.RandomState(4)
    x, c = r.randn(B, 3 * E).astype("float32"), r.randn(2, B, H, MMHA_T, D).astype("float32")
    cache = torch.from_numpy(c.copy())
    lens = torch.tensor([2, 5], dtype=torch.int32)          # a host (CPU) tensor
    out, c2 = T.incubate.nn.functional.masked_multihead_attention(
        torch.from_numpy(x), cache_kv=cache, sequence_lengths=lens)
    np.testing.assert_array_equal(cache.numpy(), c)
    qkv = x.reshape(B, 3, H, D)
    np.testing.assert_array_equal(c2[0, 1, :, 5].numpy(), qkv[1, 1])
    with pytest.raises(ValueError, match="exceeds the cache"):
        T.incubate.nn.functional.masked_multihead_attention(
            torch.from_numpy(x), cache_kv=cache, sequence_lengths=torch.tensor([0, MMHA_T]))


def test_fused_moe_ties_lowest_expert_first():
    """Tied gate probabilities (a zero gate: every expert 1/E) route each
    token to the lowest expert indices, as ``jax.lax.top_k`` does."""
    r = np.random.RandomState(5)
    x = r.randn(2, 3, 8).astype("float32")
    gate = np.zeros((8, 4), "float32")
    gate[:, 3] = 0.0
    w1, w2 = r.randn(4, 8, 6).astype("float32"), r.randn(4, 6, 8).astype("float32")
    outs = [_np(IF(P).fused_moe(*[P.to_tensor(a, place="cpu") for a in (x, gate, w1, w2)],
                                moe_topk=2)) for P in (paddle, T)]
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-5, atol=1e-6)
    tokens = torch.from_numpy(x.reshape(-1, 8))
    h = torch.nn.functional.gelu(torch.einsum("td,edi->tei", tokens, torch.from_numpy(w1)))
    y = torch.einsum("tei,eid->ted", h, torch.from_numpy(w2))
    np.testing.assert_allclose(outs[1].reshape(-1, 8), (0.5 * (y[:, 0] + y[:, 1])).numpy(),
                               rtol=1e-5, atol=1e-6)


def test_fused_gate_attention_refusals_match_jax():
    q = np.ones((1, 1, 2, 4), "float32")
    w = np.ones((3, 1, 2, 4), "float32")
    for kw in (dict(key=q, qkv_weight=w), dict(), dict(merge_qkv=False),
               dict(qkv_weight=w), dict(qkv_weight=w, has_gating=False)):
        errs = []
        for P in (paddle, T):
            kt = {k: (P.to_tensor(v, place="cpu") if isinstance(v, np.ndarray) else v)
                  for k, v in kw.items()}
            with pytest.raises(ValueError) as e:
                IF(P).fused_gate_attention(P.to_tensor(q, place="cpu"), **kt)
            errs.append(str(e.value))
        assert errs[0] == errs[1]


def test_dropout_variants_draw_from_the_port_generator():
    x, y = torch.ones(200, 100), torch.full((200, 100), 2.0)
    F = T.incubate.nn.functional
    assert torch.equal(F.fused_dropout_add(x, y, training=False), x + y)
    assert torch.equal(F.fused_dropout_add(x, y, p=0.0), x + y)
    T.seed(1)
    a = F.fused_dropout_add(x, y, p=0.25)
    T.seed(1)
    b = F.fused_dropout_add(x, y, p=0.25)
    assert torch.equal(a, b)
    vals = set(a.unique().tolist())
    assert vals <= {2.0, (torch.ones(()) / 0.75 + 2.0).item()}
    kept = (a > 2.0).float().mean().item()
    assert abs(kept - 0.75) < 4 * (0.75 * 0.25 / a.numel()) ** 0.5
    c = F.fused_dropout_add(x, y, p=0.25, mode="downscale_in_infer")
    assert set(c.unique().tolist()) <= {2.0, 3.0}
    d = F.fused_bias_dropout_residual_layer_norm(x, y, dropout_rate=0.5)
    assert d.shape == x.shape and torch.isfinite(d).all()


# -- the fused layers --------------------------------------------------------------------
def L(name, make, inputs, steps=1, train=True):
    return pytest.param(make, inputs, steps, train, id=name)


def _inc(P):
    return P.incubate.nn


LAYERS = [
    L("FusedLinear", lambda P: _inc(P).FusedLinear(6, 5), [N(3, 6)]),
    L("FusedLinear_transposed_no_bias", lambda P: _inc(P).FusedLinear(
        6, 5, bias_attr=False, transpose_weight=True), [N(2, 3, 6)]),
    L("FusedMultiHeadAttention_post_ln", lambda P: _inc(P).FusedMultiHeadAttention(
        E, H, dropout_rate=0.0, attn_dropout_rate=0.0), [N(B, S, E)]),
    L("FusedMultiHeadAttention_pre_ln", lambda P: _inc(P).FusedMultiHeadAttention(
        E, H, dropout_rate=0.0, attn_dropout_rate=0.0, normalize_before=True), [N(B, S, E)]),
    L("FusedMultiHeadAttention_eval_defaults", lambda P: _inc(P).FusedMultiHeadAttention(E, H),
      [N(B, S, E)], train=False),
    L("FusedFeedForward", lambda P: _inc(P).FusedFeedForward(E, FF, dropout_rate=0.0),
      [N(B, S, E)]),
    L("FusedFeedForward_pre_ln_gelu", lambda P: _inc(P).FusedFeedForward(
        E, FF, dropout_rate=0.0, activation="gelu", normalize_before=True), [N(B, S, E)]),
    L("FusedTransformerEncoderLayer", lambda P: _inc(P).FusedTransformerEncoderLayer(
        E, H, FF, dropout_rate=0.0, activation="gelu"), [N(B, S, E)], steps=2),
    L("FusedTransformerEncoderLayer_eval", lambda P: _inc(P).FusedTransformerEncoderLayer(
        E, H, FF, normalize_before=True), [N(B, S, E)], train=False),
    L("FusedMultiTransformer", lambda P: _inc(P).FusedMultiTransformer(
        E, H, FF, num_layers=2), [N(B, S, E)], train=False),
    L("FusedDropoutAdd_eval", lambda P: _inc(P).FusedDropoutAdd(), [N(B, S, E), N(B, S, E)],
      train=False),
    L("FusedDropoutAdd_p0", lambda P: _inc(P).FusedDropoutAdd(p=0.0), [N(B, S, E),
                                                                      N(B, S, E)]),
    L("FusedBiasDropoutResidualLayerNorm", lambda P: _inc(P).FusedBiasDropoutResidualLayerNorm(
        E, dropout_rate=0.0), [N(B, S, E), N(B, S, E)]),
]


@pytest.mark.parametrize("make,inputs,steps,train", LAYERS)
def test_fused_layer_matches_jax(make, inputs, steps, train):
    check_layer(make, inputs, steps=steps, train=train, rtol=TOL, atol=TOL)


def test_fused_layer_refusals_and_repr_match_jax():
    for P in (paddle, T):
        with pytest.raises(NotImplementedError):
            _inc(P).FusedMultiHeadAttention(E, H, need_weights=True)
        with pytest.raises(NotImplementedError):
            _inc(P).FusedMultiTransformer(E, H, FF, normalize_before=False)
        with pytest.raises(ValueError):
            _inc(P).FusedTransformerEncoderLayer(E, H, FF, weight_attr=[None] * 3)
    assert _inc(T).FusedDropoutAdd(0.3).extra_repr() == _inc(paddle).FusedDropoutAdd(
        0.3).extra_repr()


def test_fused_multi_transformer_layer_cached_matches_jax():
    from test_torch_nn_layers import carry

    r = np.random.RandomState(6)
    paddle.seed(2)
    jl = _inc(paddle).FusedMultiTransformer(E, H, FF, num_layers=2)
    tl = _inc(T).FusedMultiTransformer(E, H, FF, num_layers=2)
    carry(jl, tl)
    jl.eval()
    tl.eval()
    x = r.randn(B, 3, E).astype("float32")
    step = r.randn(B, 1, E).astype("float32")
    caches = [np.zeros((2, B, H, 6, D), "float32") for _ in range(2)]
    res = []
    for P, layer in ((paddle, jl), (T, tl)):
        t = lambda a, _P=P: _P.to_tensor(a, place="cpu")  # noqa: E731
        out, cs = layer(t(x), caches=[t(c) for c in caches])
        out2, cs = layer(t(step), caches=cs, time_step=np.array([3]))
        res.append([_np(out), _np(out2)] + [_np(c) for c in cs])
    for a, b in zip(res[1], res[0]):
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)
    with pytest.raises(ValueError, match="time_step needs caches"):
        tl(torch.from_numpy(x), time_step=1)


# -- asp (tests/test_misc_kits.py TestASP on both) ----------------------------------------
@pytest.mark.parametrize("algo", ["mask_1d", "mask_2d_best"])
def test_asp_masks_equal_jax(algo):
    from paddle_tpu.incubate import asp as jasp
    from paddle_tpu_torch.incubate import asp as tasp

    r = np.random.RandomState(0)
    for shape in ((8, 16), (6, 10), (4, 3, 8)):
        mat = r.randn(*shape).astype("float32")
        a, b = tasp.create_mask(mat, algo), jasp.create_mask(mat, algo)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
        check = "check_1d" if algo == "mask_1d" else "check_2d"
        assert tasp.check_sparsity(mat * a, check) == jasp.check_sparsity(mat * b, check)
    assert tasp.calculate_density(a) == jasp.calculate_density(b)
    assert not tasp.check_mask_2d(np.ones((8, 8)), 2, 4)


def _asp_net(P):
    P.seed(0)
    return P.nn.Sequential(P.nn.Linear(8, 16), P.nn.ReLU(), P.nn.Linear(16, 4))


def test_asp_prune_and_decorate_match_jax():
    from paddle_tpu.incubate import asp as jasp
    from paddle_tpu_torch.incubate import asp as tasp
    from test_torch_nn_layers import _sd, carry

    jnet, tnet = _asp_net(paddle), _asp_net(T)
    carry(jnet, tnet)
    x = np.random.RandomState(2).randn(4, 8).astype("float32")
    states = []
    for P, asp, net in ((paddle, jasp, jnet), (T, tasp, tnet)):
        opt = asp.decorate(P.optimizer.SGD(learning_rate=0.1, parameters=net.parameters()))
        masks = asp.prune_model(net)
        assert sorted(masks) == ["0.weight", "2.weight"]
        xt = P.to_tensor(x, place="cpu")
        for _ in range(3):
            loss = (net(xt) ** 2).mean()
            loss.backward()
            opt.step()
            opt.clear_grad()
        for k, v in _sd(net).items():
            if v.ndim == 2:
                assert asp.check_sparsity(v, "check_1d")
                np.testing.assert_array_equal(v[masks[k] == 0], 0)
        states.append(_sd(net))
    for k in states[0]:
        np.testing.assert_allclose(states[1][k], states[0][k], rtol=1e-5, atol=1e-6)


def test_asp_excluded_layers():
    from paddle_tpu_torch.incubate import asp

    net = T.nn.Linear(8, 8)
    asp.set_excluded_layers([net])
    try:
        assert asp.prune_model(net) == {}
    finally:
        asp.reset_excluded_layers()


def test_varlen_attention_padding_does_not_leak():
    """tests/test_advice_fixes.py TestVarlenAttentionSeqLens on the port:
    keys and values past the valid length change nothing."""
    r = np.random.RandomState(1)
    q, k, v = (r.randn(1, 1, 4, 4).astype("float32") for _ in range(3))
    k2, v2 = k.copy(), v.copy()
    k2[:, :, 2:] = 1e3
    v2[:, :, 2:] = -1e3
    lens = torch.tensor([2], dtype=torch.int32)
    F = T.incubate.nn.functional
    a = F.variable_length_memory_efficient_attention(*map(torch.from_numpy, (q, k, v)), lens,
                                                     lens)
    b = F.variable_length_memory_efficient_attention(*map(torch.from_numpy, (q, k2, v2)),
                                                     lens, lens)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-6)
