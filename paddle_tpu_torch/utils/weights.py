"""Pretrained weights from local files, and the conversions between
ecosystems: the port of ``paddle_tpu/utils/weights.py``.

Reference analog: python/paddle/vision/models/resnet.py, whose zoo entries
download hub weights and set_state_dict() them. Here a local checkpoint
path takes the place of the download. Formats read:
  - ``.pdparams`` / ``.pkl`` / anything else: the reference's paddle.save
    state dict, a plain pickle of {name: ndarray}, or the format of either
    package's ``paddle.save`` (``framework_io``), decoded to numpy (bf16
    through its float32 bits);
  - ``.safetensors``: through safetensors.numpy, where that package is
    installed.

The conversions work on numpy arrays in paddle's layout and are the JAX
module's: torch's nn.Linear stores weight as [out, in] and paddle as
[in, out], so 2-D non-embedding weights transpose; torch's BatchNorm
running_mean/running_var are paddle's _mean/_variance, and
num_batches_tracked is dropped.

``load_pretrained`` loads into the port's modules, which are torch modules:
it checks the file against the model's state in paddle's layout (each
``torch.nn.Linear`` weight transposed, the LLaMA's projections included, and
the LLaMA head's; the port's ``nn.Linear`` is a ``Layer`` already in
paddle's layout) and writes each array back in the module's own layout. Not ported: ``load_zoo_pretrained``, the vision zoo's
hook (ROADMAP Queue A item 8, ``vision``).
"""
from __future__ import annotations

import pickle
import re

import numpy as np
import torch

__all__ = ["load_checkpoint", "convert_torch_state_dict",
           "convert_hf_bert_state_dict", "convert_torch_mha_state_dict",
           "load_pretrained"]


def load_checkpoint(path):
    """Read a checkpoint file into {name: np.ndarray}: safetensors; the
    reference's plain pickle of {name: ndarray}; and either package's
    paddle.save format (each tensor a {'__tensor__': ...} dict, bf16 as its
    uint16 bits)."""
    path = str(path)
    if path.endswith(".safetensors"):
        from safetensors.numpy import load_file

        return dict(load_file(path))
    from ..framework_io import _unpack

    with open(path, "rb") as f:
        sd = pickle.load(f)
    if not isinstance(sd, dict):
        raise ValueError(
            f"checkpoint {path!r} did not unpickle to a state dict "
            f"(got {type(sd).__name__})")
    out = {}
    for k, v in sd.items():
        if k == "StructuredToParameterName@@":  # reference bookkeeping entry
            continue
        out[str(k)] = np.asarray(_unpack(v, True, None))
    return out


_TORCH_RENAMES = (
    (re.compile(r"\.running_mean$"), "._mean"),
    (re.compile(r"\.running_var$"), "._variance"),
)


def convert_torch_state_dict(sd, no_transpose=("embed",)):
    """Map a torch-convention state dict onto this build's conventions:
    rename BN running stats, drop num_batches_tracked, strip a DataParallel
    'module.' prefix, and transpose 2-D linear weights ([out,in] -> [in,out]).
    Keys whose name contains any of ``no_transpose`` keep their layout
    (embedding tables are [vocab, dim] on both sides)."""
    out = {}
    for k, v in sd.items():
        v = np.asarray(v)
        if k.startswith("module."):
            k = k[len("module."):]
        if k.endswith("num_batches_tracked"):
            continue
        for pat, rep in _TORCH_RENAMES:
            k = pat.sub(rep, k)
        if (v.ndim == 2 and k.endswith("weight")
                and not any(t in k for t in no_transpose)):
            v = v.T
        out[k] = v
    return out


_HF_BERT_RENAMES = (
    (re.compile(r"^embeddings\.LayerNorm\."), "embeddings.layer_norm."),
    (re.compile(r"^encoder\.layer\.(\d+)\.attention\.self\.query\."),
     r"layer_\1.attention.q_proj."),
    (re.compile(r"^encoder\.layer\.(\d+)\.attention\.self\.key\."),
     r"layer_\1.attention.k_proj."),
    (re.compile(r"^encoder\.layer\.(\d+)\.attention\.self\.value\."),
     r"layer_\1.attention.v_proj."),
    (re.compile(r"^encoder\.layer\.(\d+)\.attention\.output\.dense\."),
     r"layer_\1.attention.out_proj."),
    (re.compile(r"^encoder\.layer\.(\d+)\.attention\.output\.LayerNorm\."),
     r"layer_\1.attn_norm."),
    (re.compile(r"^encoder\.layer\.(\d+)\.intermediate\.dense\."),
     r"layer_\1.ffn_in."),
    (re.compile(r"^encoder\.layer\.(\d+)\.output\.dense\."),
     r"layer_\1.ffn_out."),
    (re.compile(r"^encoder\.layer\.(\d+)\.output\.LayerNorm\."),
     r"layer_\1.ffn_norm."),
)


def convert_hf_bert_state_dict(sd):
    """HuggingFace/torch BertModel state dict -> models/bert.py BertModel.

    The naming map covers embeddings + every encoder sublayer + pooler; the
    layout rules are convert_torch_state_dict's (linear transposes, no
    transpose for the three embedding tables)."""
    renamed = {}
    for k, v in sd.items():
        if k.endswith("position_ids"):  # HF buffer, not a weight
            continue
        for pat, rep in _HF_BERT_RENAMES:
            k = pat.sub(rep, k)
        renamed[k] = np.asarray(v)
    return convert_torch_state_dict(renamed)


def convert_torch_mha_state_dict(sd):
    """torch.nn.MultiheadAttention (and the Transformer layers built on it)
    pack q/k/v into one [3E, E] in_proj_weight / [3E] in_proj_bias; this
    build (like the reference) keeps separate q/k/v projections. Split the
    packed tensors into {q,k,v}_proj entries, then apply the generic torch
    layout rules (linear transposes etc.). Works on full module trees: any
    key ending in in_proj_weight/in_proj_bias is split in place.

    torch MHA variants that do NOT pack (kdim/vdim != embed_dim uses
    separate q_proj_weight/..., add_bias_kv adds bias_k/bias_v) carry a
    different parameter contract — rejected explicitly rather than passed
    through under their torch names (which set_state_dict would miss)."""
    unpacked = sorted(k for k in sd
                      if k.endswith(("q_proj_weight", "k_proj_weight",
                                     "v_proj_weight", "bias_k", "bias_v")))
    if unpacked:
        raise NotImplementedError(
            "convert_torch_mha_state_dict: unpacked-projection MHA keys "
            f"{unpacked[:4]} (kdim/vdim != embed_dim or add_bias_kv) are "
            "not supported; export a same-dim MHA or map the projections "
            "manually")
    out = {}
    for k, v in sd.items():
        v = np.asarray(v)
        if k.endswith("in_proj_weight") or k.endswith("in_proj_bias"):
            prefix = k[:k.rindex("in_proj")]
            suffix = "weight" if k.endswith("weight") else "bias"
            q, kk, vv = np.split(v, 3, axis=0)
            out[f"{prefix}q_proj.{suffix}"] = q
            out[f"{prefix}k_proj.{suffix}"] = kk
            out[f"{prefix}v_proj.{suffix}"] = vv
        else:
            out[k] = v
    return convert_torch_state_dict(out)


def _paddle_state(model):
    """{name: (tensor, transposed)}: the model's state dict entries, with
    whether paddle's layout of each is its transpose (the weight of a
    torch.nn.Linear, or of a module that says so, as the LLaMA head)."""
    linears = {f"{prefix}.weight" if prefix else "weight"
               for prefix, m in model.named_modules()
               if isinstance(m, torch.nn.Linear) or getattr(m, "_transposed_weight", False)}
    return {name: (t, name in linears)
            for name, t in model.state_dict(keep_vars=True).items()}


def load_pretrained(model, path, source="auto", strict=True):
    """Load a checkpoint file into ``model`` (the reference zoo's
    pretrained-load step, local-file form).

    source: "paddle" (keys already match), "torch" (apply the layout and
    name conversion), or "auto": if the raw keys do not cover the model
    exactly, the torch conversion is applied when it lines the keys up
    strictly better (torch and paddle ResNets share most names and differ in
    the BN running stats, so overlap alone cannot decide). A torch
    checkpoint whose keys all match unconverted (no BN) cannot be told by
    name: pass source="torch"; the shape check catches non-square linears."""
    sd = load_checkpoint(path)
    state = _paddle_state(model)
    target = {k: tuple(reversed(t.shape)) if tr else tuple(t.shape)
              for k, (t, tr) in state.items()}
    if source == "torch":
        sd = convert_torch_state_dict(sd)
    elif source == "auto" and set(sd) != set(target):
        conv = convert_torch_state_dict(sd)
        if len(set(conv) ^ set(target)) < len(set(sd) ^ set(target)):
            sd = conv
    if strict:
        missing = sorted(set(target) - set(sd))
        unexpected = sorted(set(sd) - set(target))
        if missing or unexpected:
            raise ValueError(
                f"checkpoint {path!r} does not match the model: "
                f"missing={missing[:8]}{'...' if len(missing) > 8 else ''} "
                f"unexpected={unexpected[:8]}"
                f"{'...' if len(unexpected) > 8 else ''}")
    for name, arr in sd.items():
        if name in target and target[name] != tuple(arr.shape):
            raise ValueError(
                f"checkpoint {path!r}: shape mismatch for {name}: "
                f"model {target[name]} vs file "
                f"{tuple(arr.shape)} (wrong source= layout?)")
    with torch.no_grad():
        for name, arr in sd.items():
            if name in state:
                t, transposed = state[name]
                t.copy_(torch.from_numpy(np.ascontiguousarray(arr.T if transposed else arr)))
    return model
