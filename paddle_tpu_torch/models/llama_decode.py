"""KV-cache decode engine for LLaMA serving: the port of
paddle_tpu/models/llama_decode.py (dense cache layout).

The cache is a (B, max_len, Hkv, D) pair of tensors per layer, allocated at
prefill. The prompt pass attends causally over the prompt's own K/V through
``F.scaled_dot_product_attention(is_causal=True)``, which runs the Hopper
flash-attention kernel on the card. That is the JAX engine's function: at
start_pos=0 it attends query s to cache slots t <= s, and the slots past the
prompt are zero and masked to -1e30, so they add exactly 0. Decode steps
attend a (B, 1) query to the cache in plain torch, as the JAX engine does in
XLA outside any kernel.

The int8 cache, the paged layout and beam search belong to a later slice
and raise ``NotImplementedError``; the continuous-batching steps
(``build_mixed_step``, ``build_decode_burst``) are not ported yet.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as tF

from ..incubate.nn.functional import _rope_tables, fused_rotary_position_embedding
from ..nn import functional as F


class LlamaDecodeEngine:
    """Greedy/temperature decoding with a per-layer KV cache on the model's
    device. The engine holds the model's parameters, not copies."""

    def __init__(self, model, max_len=None, kv_cache_dtype=None, kv_cache_layout=None):
        cfg = model.config
        self.config = cfg
        if kv_cache_dtype not in (None, "int8"):
            raise ValueError(f"unsupported kv_cache_dtype {kv_cache_dtype!r}")
        if kv_cache_layout not in (None, "dense", "paged"):
            raise ValueError(f"unsupported kv_cache_layout {kv_cache_layout!r}")
        if kv_cache_dtype == "int8" or kv_cache_layout == "paged":
            raise NotImplementedError(
                "the int8 and paged KV caches are not ported yet: they belong "
                "to the paged-serving slice of the port")
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
        return [(torch.zeros(shape, dtype=self.emb.dtype, device=self.device),
                 torch.zeros(shape, dtype=self.emb.dtype, device=self.device))
                for _ in self.layers]

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

    def _block(self, p, x, cache_kv, start, rope, pos_mask):
        S = x.shape[1]
        q, k, v = self._qkv_rope(p, x, *rope)
        ck, cv = cache_kv
        # written in place; the JAX engine returns a new cache from a donated
        # lax.dynamic_update_slice, which is the same buffer reused
        ck[:, start:start + S] = k
        cv[:, start:start + S] = v
        if start == 0:
            # prompt pass: causal attention over the prompt's own K/V (the
            # cache slots past it would add exactly 0) -> the flash kernel
            attn = F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                  training=False)
        else:
            attn = self._attend(q, ck[:, :start + S], cv[:, :start + S], pos_mask)
        return self._post_attn(p, x, attn)

    def _forward(self, ids, cache, start_pos):
        """ids: (B, S) at absolute positions start_pos..start_pos+S-1; returns
        the last position's logits (B, V) — the only ones any caller reads."""
        B, S = ids.shape
        x = self.emb[ids]
        positions = torch.arange(start_pos, start_pos + S, device=x.device)
        # rotate-half cos/sin (S, D) at the absolute positions, built once for
        # every layer
        rope = _rope_tables(S, self.head_dim, self.theta, x.dtype, x.device, positions)
        pos_mask = None
        if start_pos > 0:
            # cache slots past start_pos + S are masked in the JAX engine and
            # add 0: attend only the filled prefix
            t = torch.arange(start_pos + S, device=x.device)[None, None, :]
            pos_mask = (t <= positions[None, :, None]).expand(B, S, start_pos + S)
        for p, ckv in zip(self.layers, cache):
            x = self._block(p, x, ckv, start_pos, rope, pos_mask)
        x = F.rms_norm(x[:, -1], self.norm_w, epsilon=self.eps)
        return tF.linear(x, self.head_w)

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
        cache = self.init_cache(B)
        return self._forward(ids, cache, 0), cache, S

    @torch.inference_mode()
    def decode_step(self, token, cache, pos):
        """token (B, 1) -> (next-token logits (B, V), cache)."""
        if int(pos) >= self.max_len:
            raise ValueError(
                f"decode position {int(pos)} exceeds the cache "
                f"(max_len={self.max_len}); build the engine with a larger "
                "max_len")
        return self._forward(self._ids(token), cache, int(pos)), cache

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

    def beam_search(self, *args, **kwargs):
        raise NotImplementedError(
            "beam_search is not ported yet: it belongs to the paged-serving "
            "slice of the port")
