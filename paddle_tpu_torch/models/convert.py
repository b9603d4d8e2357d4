"""Weight transfer between the JAX package's LLaMA and the port.

``state`` maps the JAX model's ``state_dict()`` names to numpy arrays. Paddle
stores a Linear weight as (in, out) with y = x @ W; torch.nn.Linear as
(out, in), so every projection is transposed. The untied LM head is (hidden,
vocab) in paddle and (vocab, hidden) here; a tied model has no
``lm_head.weight`` at all. ``llama_to_numpy`` goes the other way, for
parameters or their gradients, so that tests compare both by the JAX names.
"""
from __future__ import annotations

import numpy as np
import torch

from .llama import LlamaConfig, LlamaForCausalLM

_LINEARS = ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj",
            "self_attn.o_proj", "mlp.gate_proj", "mlp.up_proj", "mlp.down_proj")
_NORMS = ("input_layernorm", "post_attention_layernorm")


def name_map(config: LlamaConfig) -> dict[str, tuple[str, bool]]:
    """JAX state_dict name -> (port parameter name, transpose?)."""
    names = {"llama.embed_tokens.weight": ("llama.embed_tokens.weight", False),
             "llama.norm.weight": ("llama.norm.weight", False)}
    for i in range(config.num_hidden_layers):
        for lin in _LINEARS:
            n = f"llama.layers.{i}.{lin}.weight"
            names[n] = (n, True)
        for norm in _NORMS:
            n = f"llama.layers.{i}.{norm}.weight"
            names[n] = (n, False)
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
    unknown = sorted(set(state) - set(names))
    missing = sorted(set(names) - set(state))
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
    return model


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
