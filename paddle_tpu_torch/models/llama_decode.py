"""KV-cache decode engine for LLaMA serving: the port of
paddle_tpu/models/llama_decode.py.

Three cache forms, as in the JAX engine:

- dense (the default): a (B, max_len, Hkv, D) pair of tensors per layer,
  allocated at prefill and written in place;
- ``kv_cache_dtype="int8"``: the same layout in int8 with one fp32 absmax
  scale per (token, head), four tensors per layer; attention folds the
  scales into its products and never builds a dequantized copy;
- ``kv_cache_layout="paged"``: block pools indexed by per-sequence block
  tables (``models/paged_kv.py``), granted on the host as decoding advances,
  in bf16/fp16/fp32 or int8.

On the card the engine's programs are captured as CUDA graphs, as the JAX
engine jits them (``jit/_cuda_graph.py``): the prompt pass, one program per
(batch, prompt length), with the flash-attention kernel inside the graph;
the decode step, one program per batch size, with the position an int32
device tensor, as JAX ``_step_jit`` traces it; and beam search's cache
reorder. A graph is bound to the addresses of the cache it writes, so the
buffers of a cache and the programs bound to them form a slot: ``prefill``
takes a free slot of its batch size (or makes one), and the slot goes back
to the free list when the caller drops the cache it returned. Two live
caches never share buffers, and a warm ``generate`` at a seen shape
captures nothing. The free list keeps the ``max_free_slots`` slots released
last and drops older ones with their buffers and graphs, and every graph of
an engine is captured into one memory pool, so what the programs keep
beyond their caches is their outputs, however many prompt lengths and
batch sizes the engine has served. A ``decode_step`` on a cache that did
not come from ``prefill`` (``init_cache``'s, or one the caller built) binds
a slot of its own to that cache's buffers; such a slot never joins the
free list. Block grants and copy-on-write stay on the host, before the
replay; sampling and the EOS poll stay outside the graphs. On the CPU the
same functions run eagerly.

The decode step takes the JAX engine's fixed shape: RoPE rows gathered at
the device position, the K/V written at it by ``index_copy_``, and attention
over every ``max_len`` slot of the cache, masked ``t <= pos``.

The bf16/fp16/fp32 prompt pass, dense or paged, attends causally over the
prompt's own K/V through ``F.scaled_dot_product_attention(is_causal=True)``,
which runs the Hopper flash-attention kernel on the card. That is the JAX
engine's function: at start_pos=0 it attends query s to cache slots t <= s,
and the slots past the prompt are zero and masked to -1e30, so they add
exactly 0. The int8 prompt pass attends the quantized prompt in plain torch
(``_attend_int8``), as the JAX int8 engine does, so it never takes the
kernel. Decode steps attend a (B, 1) query to the cache in plain torch, as
the JAX engine does in XLA outside any kernel.

The continuous-batching engine (``models/serving.py``) runs two programs
built here: ``build_mixed_step`` (one token a lane at a per-lane position
and table row: decode lanes, draft-verify lanes and prefill chunks in one
fixed-size pack) and ``build_decode_burst`` (k fused decode iterations over
every slot). Both are plain functions of tensors with no host sync and no
data-dependent shape, written to the pools in place: the engine runs them
eagerly on the CPU and captures each once as a CUDA graph on the card. A
lane's token must not depend on the program that computes it, so both
compute every lane with the same shapes: the burst runs at the mixed step's
lane count, and both attend in groups of ``LANE_GROUP`` lanes, the burst
only the groups that hold its rows (``_attend_lane_groups``).
"""
from __future__ import annotations

import math
import weakref

import numpy as np
import torch
import torch.nn.functional as tF

from ..incubate.nn.functional import _rope_tables, fused_rotary_position_embedding
from ..jit._cuda_graph import _Program
from ..nn import functional as F
from . import paged_kv as _pk


# lanes the serving programs attend at once: a lane's attention has the same
# shapes (so the same library kernels and rounding) in the mixed step and in
# the burst, while the burst reads only the groups that hold its rows
LANE_GROUP = 16


def _attend_lane_groups(attend, q, tables, lens, live):
    """``attend(q, tables, lens)`` over the first ``live`` of q's lanes, one
    group of LANE_GROUP lanes at a time (a short last group padded with lanes
    that read the null block); the lanes after the last group get zeros."""
    n, outs = q.shape[0], []
    for s in range(0, live, LANE_GROUP):
        e = min(s + LANE_GROUP, n)
        qg, tg, lg = q[s:e], tables[s:e], lens[s:e]
        pad = LANE_GROUP - (e - s)
        if pad:
            qg = torch.cat([qg, qg.new_zeros((pad,) + qg.shape[1:])])
            tg = torch.cat([tg, tg.new_zeros((pad, tg.shape[1]))])
            lg = torch.cat([lg, lg.new_zeros(pad)])
        outs.append(attend(qg, tg, lg)[:e - s])
    out = torch.cat(outs)
    if out.shape[0] < n:
        out = torch.cat([out, out.new_zeros((n - out.shape[0],) + out.shape[1:])])
    return out


def _row_rope_tables(positions, head_dim, theta, dtype, device):
    """Rotate-half cos/sin (B, 1, D) at per-row absolute ``positions`` (B,)."""
    return _rope_tables(1, head_dim, theta, dtype, device, positions[:, None], every_two=False)


def _rope_at_rows(x, positions, theta):
    """x: (B, 1, H, D) rotated at per-row absolute ``positions`` (B,): the
    ragged-batch form (continuous batching decodes every slot at its own
    position in one step)."""
    cos, sin = _row_rope_tables(positions, x.shape[-1], theta, x.dtype, x.device)
    return fused_rotary_position_embedding(x, sin=sin, cos=cos,
                                           use_neox_rotary_style=False)[0]


class _PagedCache:
    """Cache value of the paged engine: the block pools (device) and their
    pager (host allocator + tables). The pager travels with the cache, not
    the engine, so interleaved prefills cannot cross-wire block tables."""

    __slots__ = ("pager", "pools", "_slot", "__weakref__")

    def __init__(self, pager, pools):
        self.pager = pager
        self.pools = pools


class _DenseCache(list):
    """Cache value of the dense engine: one tuple of tensors per layer, (k, v)
    or the int8 form (k_q, k_scale, v_q, v_scale), each (B, max_len, ...)."""


class _Slot:
    """One cache's buffers and the programs bound to their addresses."""

    __slots__ = ("batch", "cache", "pager", "programs")

    def __init__(self, batch, cache, pager=None):
        self.batch = batch
        self.cache = cache          # per-layer tuples (dense) or pools (paged)
        self.pager = pager
        self.programs = {}


def _release(free, cap, slot):
    """``slot`` back on the free list ``free`` (the last released last), the
    oldest dropped past ``cap``."""
    free.append(slot)
    del free[:max(len(free) - cap, 0)]


def _reorder_dense(parent, cache):
    """Beam reorder in place: row i of every cache tensor becomes row
    ``parent[i]`` (the JAX engine's ``_reorder_jit``, into the same
    buffers)."""
    for entry in cache:
        for a in entry:
            a.copy_(a.index_select(0, parent))


class LlamaDecodeEngine:
    """Greedy/temperature decoding and beam search with a per-layer KV cache
    on the model's device. The engine holds the model's parameters, not
    copies."""

    #: released slots kept for reuse, with their buffers and graphs
    max_free_slots = 2

    def __init__(self, model, max_len=None, kv_cache_dtype=None,
                 kv_cache_layout=None, block_size=64):
        cfg = model.config
        self._free = []        # released slots, the last released last
        self._graph_pool = None
        self.config = cfg
        if kv_cache_dtype not in (None, "int8"):
            raise ValueError(f"unsupported kv_cache_dtype {kv_cache_dtype!r}")
        self.kv_int8 = kv_cache_dtype == "int8"
        if kv_cache_layout not in (None, "dense", "paged"):
            raise ValueError(f"unsupported kv_cache_layout {kv_cache_layout!r}")
        self.paged = kv_cache_layout == "paged"
        self.block_size = int(block_size)
        self._pager = None   # the last prefill's pager (the cache owns it)
        self.max_len = int(max_len or cfg.max_position_embeddings)
        self.num_heads = cfg.num_attention_heads
        self.num_kv = cfg.num_key_value_heads
        self.head_dim = cfg.head_dim
        self.eps = cfg.rms_norm_eps
        self.theta = cfg.rope_theta
        self.layers = []
        for lyr in model.llama.layers:
            a, m = lyr.self_attn, lyr.mlp
            # torch.nn.Linear weights: (out, in), applied with F.linear
            self.layers.append(dict(
                ln1=lyr.input_layernorm.weight, ln2=lyr.post_attention_layernorm.weight,
                wq=a.q_proj.weight, wk=a.k_proj.weight, wv=a.v_proj.weight,
                wo=a.o_proj.weight, gate=m.gate_proj.weight, up=m.up_proj.weight,
                down=m.down_proj.weight))
        self.emb = model.llama.embed_tokens.weight
        self.norm_w = model.llama.norm.weight
        head = model.lm_head
        self.head_w = self.emb if head._tied else head.weight   # (vocab, hidden)

    @property
    def device(self):
        return self.emb.device

    # -- cache ---------------------------------------------------------------
    def init_cache(self, batch):
        shape = (batch, self.max_len, self.num_kv, self.head_dim)

        def zeros(shp, dt):
            return torch.zeros(shp, dtype=dt, device=self.device)

        if self.kv_int8:
            # one absmax scale per (token, kv head)
            return [(zeros(shape, torch.int8), zeros(shape[:-1], torch.float32),
                     zeros(shape, torch.int8), zeros(shape[:-1], torch.float32))
                    for _ in self.layers]
        return [(zeros(shape, self.emb.dtype), zeros(shape, self.emb.dtype))
                for _ in self.layers]

    @staticmethod
    def _quantize_kv(x):
        """(B, S, H, D) -> int8 values + per-(token, head) fp32 scales:
        scale = max|x| / 127 (at least 1e-8), q = round(x / scale), round
        half to even, clipped to [-127, 127]."""
        xf = x.float()
        scale = torch.clamp_min(xf.abs().amax(dim=-1) / 127.0, 1e-8)
        q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127).to(torch.int8)
        return q, scale

    def _init_paged(self, batch):
        max_blocks = -(-self.max_len // self.block_size)
        # pool sized for the worst case + the reserved null block; blocks are
        # still granted lazily, so a short-lived batch touches few
        pager = _pk.PagedKVCache(
            num_layers=len(self.layers), num_blocks=batch * max_blocks + 1,
            block_size=self.block_size, kv_heads=self.num_kv,
            head_dim=self.head_dim, batch=batch, max_blocks_per_seq=max_blocks,
            dtype=self.emb.dtype, quantized=self.kv_int8, device=self.device)
        if self.kv_int8:
            return pager, list(zip(pager.k, pager.k_scale, pager.v, pager.v_scale))
        return pager, list(zip(pager.k, pager.v))

    # -- functional blocks ---------------------------------------------------
    def _attend(self, q, ck, cv, pos_mask):
        """q: (B, S, Hq, D) vs cache (B, T, Hkv, D) under pos_mask (B, S, T)."""
        rep = self.num_heads // self.num_kv
        if rep > 1:
            ck = ck.repeat_interleave(rep, dim=2)
            cv = cv.repeat_interleave(rep, dim=2)
        logits = torch.einsum("bshd,bthd->bhst", q, ck) / math.sqrt(self.head_dim)
        logits = torch.where(pos_mask[:, None, :, :], logits, -1e30)
        # promote, don't demote: f64 parity runs must stay f64
        ct = torch.promote_types(q.dtype, torch.float32)
        probs = torch.softmax(logits.to(ct), dim=-1).to(q.dtype)
        return torch.einsum("bhst,bthd->bshd", probs, cv)

    def _attend_int8(self, q, ck_q, ck_s, cv_q, cv_s, pos_mask):
        """Attention over the int8 cache without a dequantized copy: the
        per-(token, head) scales fold into the products,
        logits[b,h,s,t] = (q . k_q) * ck_s[b,t,h] / sqrt(D) and
        out = (probs * cv_s)[b,h,s,t] @ v_q[b,t,h,d]; the products run in
        q.dtype and the scale fold in promote(q.dtype, float32), the same
        ops as ``paged_kv.paged_attention_decode_int8``."""
        rep = self.num_heads // self.num_kv
        if rep > 1:
            ck_q, cv_q, ck_s, cv_s = (a.repeat_interleave(rep, dim=2)
                                      for a in (ck_q, cv_q, ck_s, cv_s))
        ct = torch.promote_types(q.dtype, torch.float32)
        logits = torch.einsum("bshd,bthd->bhst", q, ck_q.to(q.dtype))
        logits = (logits.to(ct) * ck_s.transpose(1, 2)[:, :, None, :].to(ct)
                  / math.sqrt(self.head_dim))
        logits = torch.where(pos_mask[:, None, :, :], logits, -1e30)
        probs = torch.softmax(logits, dim=-1)
        pv = probs * cv_s.transpose(1, 2)[:, :, None, :].to(ct)
        return torch.einsum("bhst,bthd->bshd", pv.to(q.dtype), cv_q.to(q.dtype))

    def _qkv_rope(self, p, x, cos, sin):
        """Shared pre-attention: rms -> q/k/v projections -> RoPE."""
        B, S, _ = x.shape
        h = F.rms_norm(x, p["ln1"], epsilon=self.eps)
        q = tF.linear(h, p["wq"]).view(B, S, self.num_heads, self.head_dim)
        k = tF.linear(h, p["wk"]).view(B, S, self.num_kv, self.head_dim)
        v = tF.linear(h, p["wv"]).view(B, S, self.num_kv, self.head_dim)
        q, k, _ = fused_rotary_position_embedding(q, k, sin=sin, cos=cos,
                                                  use_neox_rotary_style=False)
        return q, k, v

    def _post_attn(self, p, x, attn):
        """Shared epilogue: output proj + residual + rms + SwiGLU MLP."""
        B, S = x.shape[0], x.shape[1]
        x = x + tF.linear(attn.reshape(B, S, -1), p["wo"])
        h2 = F.rms_norm(x, p["ln2"], epsilon=self.eps)
        mlp = tF.linear(tF.silu(tF.linear(h2, p["gate"])) * tF.linear(h2, p["up"]),
                        p["down"])
        return x + mlp

    @staticmethod
    def _prompt_attention(q, k, v):
        """Causal attention over the prompt's own K/V (the cache slots past
        it would add exactly 0): the flash kernel on the card."""
        return F.scaled_dot_product_attention(q, k, v, is_causal=True, training=False)

    def _block(self, p, x, cache_kv, rope, pos_mask):
        """A prompt-pass layer: K/V written into the cache's first S slots,
        in place (the JAX engine returns a new cache from a donated
        ``lax.dynamic_update_slice``, which is the same buffer reused)."""
        S = x.shape[1]
        q, k, v = self._qkv_rope(p, x, *rope)
        if self.kv_int8:
            ck_q, ck_s, cv_q, cv_s = cache_kv
            ck_q[:, :S], ck_s[:, :S] = self._quantize_kv(k)
            cv_q[:, :S], cv_s[:, :S] = self._quantize_kv(v)
            # the prompt pass too attends the quantized K/V, as the JAX int8
            # engine does (so no flash kernel here)
            attn = self._attend_int8(q, ck_q[:, :S], ck_s[:, :S], cv_q[:, :S],
                                     cv_s[:, :S], pos_mask)
        else:
            ck, cv = cache_kv
            ck[:, :S] = k
            cv[:, :S] = v
            attn = self._prompt_attention(q, k, v)
        return self._post_attn(p, x, attn)

    def _logits(self, x):
        """Final norm and LM head of the last position: (B, V)."""
        return tF.linear(F.rms_norm(x[:, -1], self.norm_w, epsilon=self.eps), self.head_w)

    def _prefill_dense(self, ids, cache):
        """The prompt pass: ids (B, S) at positions 0..S-1 written into the
        cache's first S slots; returns the last position's logits (B, V)."""
        B, S = ids.shape
        x = self.emb[ids]
        # rotate-half cos/sin (S, D), built once for every layer
        rope = _rope_tables(S, self.head_dim, self.theta, x.dtype, x.device, every_two=False)
        pos_mask = None
        if self.kv_int8:
            t = torch.arange(S, device=x.device)
            pos_mask = (t[None, None, :] <= t[None, :, None]).expand(B, S, S)
        for p, ckv in zip(self.layers, cache):
            x = self._block(p, x, ckv, rope, pos_mask)
        return self._logits(x)

    def _step_dense(self, token, cache, pos):
        """One lockstep decode step at the device position ``pos`` ((1,)
        int32) for every row, in the JAX engine's fixed shape: RoPE rows
        gathered at ``pos``, the K/V written there by ``index_copy_``, and
        attention over all ``max_len`` slots masked ``t <= pos``."""
        B = token.shape[0]
        x = self.emb[token]                                   # (B, 1, hidden)
        idx = pos.long()
        rope = _rope_tables(1, self.head_dim, self.theta, x.dtype, x.device, idx,
                            every_two=False)
        t = torch.arange(self.max_len, device=x.device)
        pos_mask = (t[None, :] <= idx[:, None])[None].expand(B, 1, self.max_len)
        for p, cache_kv in zip(self.layers, cache):
            q, k, v = self._qkv_rope(p, x, *rope)
            if self.kv_int8:
                ck_q, ck_s, cv_q, cv_s = cache_kv
                kq, ks = self._quantize_kv(k)
                vq, vs = self._quantize_kv(v)
                for buf, new in ((ck_q, kq), (ck_s, ks), (cv_q, vq), (cv_s, vs)):
                    buf.index_copy_(1, idx, new)
                attn = self._attend_int8(q, ck_q, ck_s, cv_q, cv_s, pos_mask)
            else:
                ck, cv = cache_kv
                ck.index_copy_(1, idx, k.to(ck.dtype))
                cv.index_copy_(1, idx, v.to(cv.dtype))
                attn = self._attend(q, ck, cv, pos_mask)
            x = self._post_attn(p, x, attn)
        return self._logits(x)

    # -- paged forward paths (models/paged_kv.py pools + tables) -------------
    def _block_paged_prefill(self, p, x, pool, tables, lens, rope, pos_mask):
        """Prompt pass: causal self-attention within the prompt (the history
        is the prompt), K/V written into the sequences' blocks."""
        q, k, v = self._qkv_rope(p, x, *rope)
        if self.kv_int8:
            kq, kscale = self._quantize_kv(k)
            vq, vscale = self._quantize_kv(v)
            _pk.paged_write_prefill_int8(*pool, tables, lens, kq, kscale, vq, vscale)
            # attend the quantized prompt, as the dense int8 engine does
            attn = self._attend_int8(q, kq, kscale, vq, vscale, pos_mask)
        else:
            _pk.paged_write_prefill(*pool, tables, lens, k, v)
            attn = self._prompt_attention(q, k, v)
        return self._post_attn(p, x, attn)

    def _block_paged_decode(self, p, x, pool, tables, lens, rope, plan, live=None):
        """One decode token per row at per-row position lens[b] (the write
        and RoPE both happen there): the same block serves lockstep decoding
        (lens = pos everywhere) and ragged batches. ``plan`` is the step's
        write plan (``paged_kv._decode_plan``), the same for every layer.
        The serving programs pass ``live``: attention then runs in lane
        groups over the first ``live`` rows (``_attend_lane_groups``)."""
        q, k, v = self._qkv_rope(p, x, *rope)
        if self.kv_int8:
            kq, kscale = self._quantize_kv(k)      # (B, 1, kv, D)
            vq, vscale = self._quantize_kv(v)
            _pk._write_planned(pool, plan, (kq[:, 0], kscale[:, 0], vq[:, 0], vscale[:, 0]))
            attend = _pk.paged_attention_decode_int8
        else:
            _pk._write_planned(pool, plan, (k[:, 0], v[:, 0]))
            attend = _pk.paged_attention_decode
        if live is None:
            attn = attend(q[:, 0], *pool, tables, lens)
        else:
            attn = _attend_lane_groups(lambda q, t, s: attend(q, *pool, t, s), q[:, 0],
                                       tables, lens, live)
        return self._post_attn(p, x, attn[:, None])

    def build_mixed_step(self):
        """The continuous-batching mixed step as a function for the serving
        engine: ``run(pack, pools, tables, slot_ids, valid, chain)``.

        ``pack`` is (2, T) int32: row 0 the lanes' token ids, row 1 their
        positions; ``slot_ids``, ``valid`` and ``chain`` are (T,). One
        forward writes every valid lane's K/V into its slot's blocks, in
        place in ``pools``, and returns (2, T) int32: each lane's greedy
        token and its accept flag.

        ``chain[i]`` marks lane i as a draft token continuing lane i-1's
        sequence (self-speculative decoding). Draft lane i is accepted iff
        lane i-1's greedy token equals the draft it carries and every draft
        before it in its chain was accepted: a segmented running AND,
        computed on the device from a running count of disagreements and
        that count at the segment's start. With ``chain`` all False every
        flag is 0 and row 0 is the plain mixed step.

        The JAX step's block (``_block_paged_mixed``) is the decode block
        over each lane's own table row and position; here its write plan
        (``paged_kv._write_plan`` with ``valid``) makes invalid lanes write
        nothing. Writes land before the attention gather, so the lanes of
        one prefill chunk see each other through the pool."""
        def run(pack, pools, tables, slot_ids, valid, chain):
            token_ids, positions = pack[0], pack[1]
            x = self.emb[token_ids.long()][:, None]          # (T, 1, hidden)
            row_tables = tables[slot_ids.long()]             # (T, max_blocks)
            rope = _row_rope_tables(positions, self.head_dim, self.theta, x.dtype,
                                    x.device)
            plan = _pk._write_plan(*_pk._decode_scatter_idx(row_tables, positions,
                                                            self.block_size), valid)
            for p, pool in zip(self.layers, pools):
                x = self._block_paged_decode(p, x, pool, row_tables, positions, rope, plan,
                                             live=x.shape[0])
            nt = torch.argmax(self._logits(x), dim=-1).to(torch.int32)
            agree = torch.where(chain, torch.roll(nt, 1) == token_ids, True)
            # disagreements so far, and that count at each lane's segment start
            # (the last lane with chain False; lanes before any start count
            # from lane 0, as the JAX scan does)
            bad = torch.cumsum((~agree).to(torch.int32), 0)
            at_start = torch.cummax(torch.where(chain, 0, bad), 0).values
            accept = chain & (bad == at_start)
            return torch.stack([nt, accept.to(torch.int32)])

        return run

    def build_decode_burst(self, k, rows=None):
        """``k`` ragged decode iterations fused into one function,
        ``run(pack, pools, tables)``: ``pack`` is (2, B) int32 (each row's
        current token and position), ``tables`` the (B, max_blocks) block
        tables. Returns (B, k) int32, the greedy tokens; the pools are
        written in place. Inactive rows (table rows of zeros) write into the
        reserved null block, as in the JAX engine.

        ``rows`` > B runs every iteration at ``rows`` lanes: the B rows plus
        lanes that read the null block, write nothing and are dropped. The
        serving engine passes its mixed step's T, so a decode token is
        computed with the same GEMM shapes in either program (a library may
        pick another kernel, and another rounding, for another row count).
        Attention runs in the mixed step's lane groups, and only over the
        groups that hold the B rows."""
        def run(pack, pools, tables):
            B = pack.shape[1]
            n = B if rows is None else int(rows)
            toks = torch.zeros(n, dtype=torch.int32, device=pack.device)
            lens = torch.zeros(n, dtype=torch.int32, device=pack.device)
            toks[:B], lens[:B] = pack[0], pack[1]
            if n > B:
                tables = torch.cat([tables, tables.new_zeros((n - B, tables.shape[1]))])
            valid = None if n == B else torch.arange(n, device=pack.device) < B
            outs = []
            for i in range(k):
                x = self.emb[toks.long()][:, None]
                rope = _row_rope_tables(lens, self.head_dim, self.theta, x.dtype, x.device)
                plan = _pk._write_plan(*_pk._decode_scatter_idx(tables, lens,
                                                                self.block_size), valid)
                for p, pool in zip(self.layers, pools):
                    x = self._block_paged_decode(p, x, pool, tables, lens, rope, plan, live=B)
                toks = torch.argmax(self._logits(x), dim=-1).to(torch.int32)
                lens = lens + 1
                outs.append(toks[:B])
            return torch.stack(outs, dim=1)

        return run

    def _prefill_paged(self, ids, pools, tables, lens):
        """Prompt pass of every row into the pools; last position's logits."""
        B, S = ids.shape
        x = self.emb[ids]
        rope = _rope_tables(S, self.head_dim, self.theta, x.dtype, x.device, every_two=False)
        t = torch.arange(S, device=x.device)
        pos_mask = (t[None, None, :] <= t[None, :, None]).expand(B, S, S)
        for p, pool in zip(self.layers, pools):
            x = self._block_paged_prefill(p, x, pool, tables, lens, rope, pos_mask)
        return self._logits(x)

    def _step_paged(self, token, pools, tables, pos):
        """One lockstep decode step at the device position ``pos`` ((1,)
        int32) for every row: ``lens`` derives from it on the device, as in
        JAX ``_step_paged_jit``."""
        x = self.emb[token]
        lens = pos.to(torch.int32).repeat(token.shape[0])
        rope = _row_rope_tables(lens, self.head_dim, self.theta, x.dtype, x.device)
        plan = _pk._decode_plan(tables, lens, self.block_size)
        for p, pool in zip(self.layers, pools):
            x = self._block_paged_decode(p, x, pool, tables, lens, rope, plan)
        return self._logits(x)

    # -- slots: cache buffers and their programs -----------------------------
    def _acquire(self, batch):
        """The free slot of ``batch`` rows released last, reset to a fresh
        cache's state, or a new one."""
        mine = [s for s in self._free if s.batch == batch]
        if not mine:
            if self.paged:
                pager, pools = self._init_paged(batch)
                return _Slot(batch, pools, pager)
            return _Slot(batch, self.init_cache(batch))
        slot = mine[-1]
        self._free.remove(slot)
        if self.paged:
            slot.pager.reset()
        else:
            for entry in slot.cache:
                for a in entry:
                    a.zero_()
        return slot

    def _handle(self, slot):
        """The cache value a caller holds for ``slot``; the slot returns to
        the free list when the last reference to it goes."""
        cache = (_PagedCache(slot.pager, slot.cache) if self.paged
                 else _DenseCache(slot.cache))
        cache._slot = slot
        weakref.finalize(cache, _release, self._free, self.max_free_slots, slot)
        return cache

    def _adopt(self, cache):
        """(slot, cache) for a cache ``prefill`` did not return: a slot bound
        to its buffers, which stay the caller's (it never joins the free
        list). A dense cache comes back as a handle on the same tensors."""
        if self.paged:
            cache._slot = _Slot(cache.pager.batch, cache.pools, cache.pager)
            return cache._slot, cache
        slot = _Slot(cache[0][0].shape[0], [tuple(entry) for entry in cache])
        handle = _DenseCache(slot.cache)
        handle._slot = slot
        return slot, handle

    def _program(self, slot, key, fn):
        """The slot's program ``key``, made from ``fn(first, pools, *rest)``
        on first use; on the card every program of the engine captures into
        one graph memory pool."""
        prog = slot.programs.get(key)
        if prog is None:
            if self._graph_pool is None and self.device.type == "cuda":
                self._graph_pool = torch.cuda.graph_pool_handle()
            prog = slot.programs[key] = _Program(fn, slot.cache, pool=self._graph_pool)
        return prog

    # The programs' functions hold the engine weakly and the slot not at all:
    # engine -> free slots -> programs -> functions, with no cycle back, so a
    # dropped engine frees its buffers and graphs at once.
    def _prefill_program(self, slot, S, rows=1):
        """The prompt pass of (B, S) prompts into rows ``::rows`` of the slot
        (beam search prefills row b*K)."""
        eng = weakref.proxy(self)
        tables = slot.pager.block_tables[::rows] if self.paged else None

        def run(ids, cache):
            if tables is not None:
                lens = torch.full((ids.shape[0],), S, dtype=torch.int32, device=ids.device)
                return eng._prefill_paged(ids, cache, tables, lens)
            return eng._prefill_dense(ids, [tuple(a[::rows] for a in e) for e in cache])

        return self._program(slot, ("prefill", S, rows), run)

    def _step_program(self, slot):
        eng = weakref.proxy(self)
        tables = slot.pager.block_tables if self.paged else None

        def run(token, cache, pos):
            if tables is not None:
                return eng._step_paged(token, cache, tables, pos)
            return eng._step_dense(token, cache, pos)

        return self._program(slot, "step", run)

    # -- public API ----------------------------------------------------------
    def _ids(self, input_ids):
        return torch.as_tensor(input_ids, device=self.device).long()

    @torch.inference_mode()
    def prefill(self, input_ids):
        """(B, S) prompt -> (next-token logits (B, V), cache, S)."""
        ids = self._ids(input_ids)
        B, S = ids.shape
        if S > self.max_len:
            raise ValueError(f"prompt ({S}) exceeds the cache (max_len={self.max_len})")
        slot = self._acquire(B)
        if self.paged:
            self._pager = slot.pager   # introspection only; the cache owns it
            slot.pager.ensure_capacity([S] * B)
        logits = self._prefill_program(slot, S)(ids).clone()
        return logits, self._handle(slot), S

    @torch.inference_mode()
    def decode_step(self, token, cache, pos):
        """token (B, 1) -> (next-token logits (B, V), cache). The cache is
        written in place and comes back as the same object, or, for a dense
        cache that did not come from ``prefill``, as a handle on the same
        buffers: pass the returned cache to the next step, as in JAX."""
        if int(pos) >= self.max_len:
            raise ValueError(
                f"decode position {int(pos)} exceeds the cache "
                f"(max_len={self.max_len}); build the engine with a larger "
                "max_len")
        if self.paged and not isinstance(cache, _PagedCache):
            raise TypeError(
                "paged decode_step needs the cache returned by prefill() (each "
                "prefill owns its own block tables; engine-level state would "
                "cross-wire interleaved sequences)")
        slot = getattr(cache, "_slot", None)
        if slot is None:
            slot, cache = self._adopt(cache)
        if self.paged:
            pager = cache.pager
            # host-side block grant for position pos (writes land at pos), then
            # copy-on-write for any shared tail block (beam forks; a cheap no-op
            # when nothing is shared). The copy writes the pools in place, so on
            # CowPoolExhausted cache.pools stay live: the JAX engine has to adopt
            # the replacement pools the exception carries instead.
            pager.ensure_capacity([int(pos) + 1] * pager.batch)
            cache.pools = pager.make_tail_exclusive(int(pos), cache.pools)
        pos_t = torch.tensor([int(pos)], dtype=torch.int32)
        return self._step_program(slot)(self._ids(token), pos_t).clone(), cache

    def _select(self, logits, temperature, top_k, top_p, generator):
        """Greedy (temperature 0) or temperature/top-k/top-p sampling."""
        if not temperature:
            return torch.argmax(logits, dim=-1, keepdim=True)
        logits = logits.float() / float(temperature)
        if top_k:
            kth = torch.topk(logits, int(top_k), dim=-1).values[:, -1:]
            logits = torch.where(logits < kth, -1e30, logits)
        if top_p is not None and top_p < 1.0:
            sort = torch.sort(logits, dim=-1, descending=True).values
            probs = torch.softmax(sort, dim=-1)
            cum = torch.cumsum(probs, dim=-1)
            # smallest set whose mass >= top_p: cutoff at the first crossing
            mask_sorted = cum - probs < top_p
            kth = torch.where(mask_sorted, sort, math.inf).min(dim=-1, keepdim=True).values
            logits = torch.where(logits < kth, -1e30, logits)
        return torch.multinomial(torch.softmax(logits, dim=-1), 1, generator=generator)

    @torch.inference_mode()
    def generate(self, input_ids, max_new_tokens=32, temperature=0.0,
                 top_k=0, top_p=1.0, seed=0, eos_token_id=None):
        """Decode with the cache; returns the (B, max_new_tokens) new tokens.

        temperature=0 is greedy; otherwise temperature/top-k/top-p sampling
        from a ``torch.Generator`` seeded with ``seed``. With
        ``eos_token_id``, a finished row keeps emitting EOS, and the loop
        pads with EOS and stops once every row has finished."""
        ids = self._ids(input_ids)
        need = int(ids.shape[1]) + int(max_new_tokens)
        if need > self.max_len:
            raise ValueError(
                f"prompt ({ids.shape[1]}) + max_new_tokens ({max_new_tokens})"
                f" = {need} exceeds the cache (max_len={self.max_len})")
        if max_new_tokens <= 0:
            return ids[:, :0]
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        logits, cache, pos = self.prefill(ids)
        tok = self._select(logits, temperature, top_k, top_p, gen)
        finished = None
        if eos_token_id is not None:
            finished = tok[:, 0] == eos_token_id
        out = [tok]
        for i in range(max_new_tokens - 1):
            # poll for all-finished only every few steps: the read is a
            # host-device sync (frozen rows already emit EOS, so a late exit
            # is correct, just not early)
            if finished is not None and i % 8 == 7 and bool(finished.all()):
                out.extend([torch.full_like(out[-1], eos_token_id)]
                           * (max_new_tokens - len(out)))
                break
            logits, cache = self.decode_step(out[-1], cache, pos)
            pos += 1
            tok = self._select(logits, temperature, top_k, top_p, gen)
            if finished is not None:
                tok = torch.where(finished[:, None], eos_token_id, tok)
                finished = finished | (tok[:, 0] == eos_token_id)
            out.append(tok)
        return torch.cat(out, dim=1)

    # -- beam search ---------------------------------------------------------
    @staticmethod
    def _top_k(x, k):
        """(values, indices) of the k largest along the last axis, the lower
        index first among equal values (``jax.lax.top_k``'s order, which
        ``torch.topk`` does not promise)."""
        values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
        return values[..., :k], idx[..., :k]

    @torch.inference_mode()
    def beam_search(self, input_ids, beam_size=4, max_new_tokens=32,
                    length_penalty=0.0, eos_token_id=None):
        """Beam-search decoding over the KV cache: beams ride the batch axis,
        so every step is one decode_step at batch B*K plus a cache reorder
        (dense: every cache tensor's rows gathered into the same buffers, a
        program of its own; paged: the beams fork the parents' block tables,
        copy-on-write at the next write).

        Returns (tokens (B, K, T), scores (B, K) fp32), beams sorted best
        first per batch row. ``length_penalty`` alpha divides final scores by
        len**alpha (0 = raw log-prob sum). EOS-finished beams are frozen
        (their score stops accumulating and the tail pads with EOS)."""
        ids = self._ids(input_ids)
        B, S = ids.shape
        K, V = int(beam_size), self.head_w.shape[0]
        if S + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt ({S}) + max_new_tokens ({max_new_tokens}) exceeds "
                f"the cache (max_len={self.max_len})")
        if max_new_tokens <= 0:  # mirror generate(): nothing requested
            return (torch.zeros((B, K, 0), dtype=torch.long, device=self.device),
                    torch.zeros((B, K), dtype=torch.float32, device=self.device))

        # prefill the B prompts into rows b*K of a B*K-row cache. The paged
        # beams then fork the prompt blocks (refcounted sharing,
        # copy-on-write) instead of copying the prompt KV K times; the dense
        # rows copy in place (the reorder program)
        slot = self._acquire(B * K)
        if self.paged:
            self._pager = slot.pager
            need = np.zeros(B * K, np.int64)
            need[::K] = S
            slot.pager.ensure_capacity(need)
        logits = self._prefill_program(slot, S, rows=K)(ids).clone()
        cache, pos = self._handle(slot), S
        logp = torch.log_softmax(logits.float(), dim=-1)              # (B, V)
        scores, first = self._top_k(logp, K)                          # (B, K)
        # expand the cache to B*K rows: beam k of row b lives at b*K + k
        base = torch.arange(B, device=self.device).repeat_interleave(K)
        # the first call of a slot's reorder (its capture, whose warm-up run
        # and replay both apply it) is this expansion, which gives the same
        # rows applied once or twice
        reorder = None if self.paged else self._program(slot, "reorder", _reorder_dense)
        if self.paged:
            cache.pager.fork_rows(base.cpu().numpy() * K)
        else:
            reorder(base * K)
        tokens = first[:, :, None]
        finished = (torch.zeros((B, K), dtype=torch.bool, device=self.device)
                    if eos_token_id is None else first == eos_token_id)
        if eos_token_id is not None:
            # frozen beams may only extend with EOS, at zero cost
            frozen = torch.full((V,), -math.inf, device=self.device)
            frozen[eos_token_id] = 0.0

        for _ in range(int(max_new_tokens) - 1):
            flat_tok = tokens[:, :, -1].reshape(B * K, 1)
            logits, cache = self.decode_step(flat_tok, cache, pos)
            pos += 1
            logp = torch.log_softmax(logits.float(), dim=-1).reshape(B, K, V)
            if eos_token_id is not None:
                logp = torch.where(finished[:, :, None], frozen, logp)
            total = scores[:, :, None] + logp                         # (B, K, V)
            scores, idx = self._top_k(total.reshape(B, K * V), K)
            parent = idx // V                                         # (B, K)
            tok = idx % V
            # reorder histories and caches to the surviving parents
            tokens = torch.gather(tokens, 1, parent[:, :, None].expand(-1, -1, tokens.shape[2]))
            tokens = torch.cat([tokens, tok[:, :, None]], dim=-1)
            flat_parent = (torch.arange(B, device=self.device)[:, None] * K + parent).reshape(-1)
            if self.paged:
                cache.pager.fork_rows(flat_parent.cpu().numpy())
            else:
                reorder(flat_parent)
            if eos_token_id is not None:
                finished = torch.gather(finished, 1, parent) | (tok == eos_token_id)

        if length_penalty:
            if eos_token_id is None:
                lens = torch.full((B, K), float(tokens.shape[-1]), device=self.device)
            else:
                lens = torch.clamp_min((tokens != eos_token_id).sum(-1).float(), 1.0)
            final = scores / lens ** float(length_penalty)
        else:
            final = scores
        order = torch.argsort(-final, dim=-1, stable=True)
        tokens = torch.gather(tokens, 1, order[:, :, None].expand(-1, -1, tokens.shape[2]))
        return tokens, torch.gather(final, 1, order)
