"""Weight transfer between the JAX package's LLaMA and the port.

``state`` maps the JAX model's ``state_dict()`` names to numpy arrays. Paddle
stores a Linear weight as (in, out) with y = x @ W; torch.nn.Linear as
(out, in), so every projection is transposed. The untied LM head is (hidden,
vocab) in paddle and (vocab, hidden) here; a tied model has no
``lm_head.weight`` at all. ``llama_to_numpy`` goes the other way, for
parameters or their gradients, so that tests compare both by the JAX names.

A JAX model that ``quantize_for_inference`` quantized has, in place of a
projection's ``weight``, its ``WeightOnlyLinear``'s ``quant_weight`` (int8
``[in, out]``, or int4 packed ``[ceil(in / 2), out]``) and ``weight_scale``
(float32 ``[out]``) buffers: ``llama_from_numpy`` swaps that projection for
a ``WeightOnlyLinear`` holding those buffers as they are, so the model
carries across quantized.
"""
from __future__ import annotations

import numpy as np
import torch

from .llama import LlamaConfig, LlamaForCausalLM

_ATTN = ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj", "self_attn.o_proj")
_MLP = ("gate_proj", "up_proj", "down_proj")
_NORMS = ("input_layernorm", "post_attention_layernorm")


def name_map(config: LlamaConfig) -> dict[str, tuple[str, bool]]:
    """JAX state_dict name -> (port parameter name, transpose?), in the JAX
    ``state_dict``'s order. A MoE layer's experts (``mlp.moe.experts.{e}.``)
    are transposed as the dense MLP is; its router (``mlp.moe.gate.gate.``
    weight and bias) is the port's public ``nn.Linear``, in paddle's layout."""
    names = {"llama.embed_tokens.weight": ("llama.embed_tokens.weight", False)}
    every = max(1, config.moe_every_k or 1)
    for i in range(config.num_hidden_layers):
        pre = f"llama.layers.{i}."
        lins = [f"{pre}{lin}.weight" for lin in _ATTN]
        router = []
        if (config.num_experts or 0) > 1 and i % every == 0:
            lins += [f"{pre}mlp.moe.experts.{e}.{lin}.weight"
                     for e in range(config.num_experts) for lin in _MLP]
            router = [f"{pre}mlp.moe.gate.gate.{b}" for b in ("weight", "bias")]
        else:
            lins += [f"{pre}mlp.{lin}.weight" for lin in _MLP]
        names.update((n, (n, True)) for n in lins)
        names.update((n, (n, False)) for n in router)
        names.update((f"{pre}{norm}.weight", (f"{pre}{norm}.weight", False)) for norm in _NORMS)
    names["llama.norm.weight"] = ("llama.norm.weight", False)
    if not config.tie_word_embeddings:
        names["lm_head.weight"] = ("lm_head.weight", True)
    return names


def llama_from_numpy(state, config: LlamaConfig, device=None, dtype=None):
    """The port's LlamaForCausalLM holding the function of the JAX model whose
    ``state_dict()`` (as numpy arrays) is ``state``.

    Raises KeyError for unknown or missing names and ValueError for a shape
    that does not match ``config``. ``dtype`` defaults to ``config.dtype``.
    """
    names = name_map(config)
    quantized = [src[:-len(".weight")] for src, (_, transpose) in names.items()
                 if transpose and src.startswith("llama.")
                 and src[:-len(".weight")] + ".quant_weight" in state]
    for prefix in quantized:
        del names[prefix + ".weight"]
    expected = set(names) | {f"{p}.{b}" for p in quantized
                             for b in ("quant_weight", "weight_scale")}
    unknown = sorted(set(state) - expected)
    missing = sorted(expected - set(state))
    if unknown or missing:
        raise KeyError(f"LLaMA state does not match the config: unknown names "
                       f"{unknown}, missing names {missing}")
    model = LlamaForCausalLM(config, device=device)
    if dtype is not None:
        model.to(dtype)
    params = dict(model.named_parameters())
    with torch.no_grad():
        for src, (dst, transpose) in names.items():
            arr = np.asarray(state[src])
            t = torch.tensor(arr.T if transpose else arr)
            p = params[dst]
            if tuple(t.shape) != tuple(p.shape):
                raise ValueError(f"{src}: shape {tuple(arr.shape)} does not fit "
                                 f"{dst} {tuple(p.shape)}")
            p.copy_(t.to(p.dtype))
    for prefix in quantized:
        _load_weight_only(model, prefix, state)
    return model


def _load_weight_only(model, prefix, state):
    """Swap the projection ``prefix`` for a ``WeightOnlyLinear`` holding the
    JAX buffers ``state[prefix + ".quant_weight"]`` and ``".weight_scale"``."""
    from ..quantization.weight_only import WeightOnlyLinear

    linear = model.get_submodule(prefix)
    qw = np.asarray(state[prefix + ".quant_weight"])
    scale = np.asarray(state[prefix + ".weight_scale"])
    k, n = linear.in_features, linear.out_features
    if qw.dtype != np.int8 or scale.shape != (n,) or qw.shape not in ((k, n), ((k + 1) // 2, n)):
        raise ValueError(f"{prefix}: quant_weight {qw.dtype} {qw.shape} and weight_scale "
                         f"{scale.shape} fit neither int8 nor int4 of a {k} x {n} weight")
    wol = WeightOnlyLinear(linear, "weight_only_int8" if qw.shape[0] == k
                           else "weight_only_int4")
    with torch.no_grad():
        wol.quant_weight.copy_(torch.from_numpy(qw.copy()))
        wol.weight_scale.copy_(torch.from_numpy(scale.astype(np.float32)))
    parent, _, name = prefix.rpartition(".")
    setattr(model.get_submodule(parent), name, wol)


def llama_to_numpy(model, grads=False):
    """The port model's parameters (or, with ``grads``, their ``.grad``) as
    float32 numpy arrays under the JAX ``state_dict()`` names, in paddle's
    layout. A parameter without a gradient maps to None."""
    params = dict(model.named_parameters())
    out = {}
    for src, (dst, transpose) in name_map(model.config).items():
        t = params[dst].grad if grads else params[dst]
        if t is None:
            out[src] = None
            continue
        arr = t.detach().float().cpu().numpy()
        out[src] = arr.T if transpose else arr
    return out
