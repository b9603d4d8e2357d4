"""Cross-entropy losses: the port of paddle_tpu/nn/functional/loss.py
(``_cross_entropy``, ``cross_entropy``, ``softmax_with_cross_entropy``).

Hard labels only, with the JAX arithmetic: ``log_softmax``, a gather at the
label (0 where the label is ``ignore_index``), ``where(valid, -picked, 0)``
and, for ``reduction="mean"``, the sum over valid tokens divided by
``max(count, 1)``. Everything is computed in the logits' dtype, as the JAX
functions do outside AMP (a bfloat16 model has a bfloat16 loss).
Soft labels, class weights and label smoothing belong to a later slice and
raise ``NotImplementedError``.
"""
from __future__ import annotations

import torch

_LATER = "a later slice of the port"


def _reduce(out, reduction):
    if reduction == "mean":
        return out.mean()
    if reduction == "sum":
        return out.sum()
    return out


def _cross_entropy(input, label, weight=None, ignore_index=-100, reduction="mean",  # noqa: A002
                   soft_label=False, axis=-1, label_smoothing=0.0):
    if soft_label:
        raise NotImplementedError(f"soft labels are not ported yet: they belong to {_LATER}")
    if weight is not None:
        raise NotImplementedError(f"class weights are not ported yet: they belong to {_LATER}")
    if label_smoothing > 0.0:
        raise NotImplementedError(
            f"label smoothing is not ported yet: it belongs to {_LATER}")
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"unknown reduction {reduction!r}")
    axis = axis % input.dim()
    logp = torch.log_softmax(input, dim=axis)
    lbl = label
    if lbl.dim() == input.dim() and lbl.shape[axis] == 1:
        lbl = lbl.squeeze(axis)
    lbl = lbl.long()
    valid = lbl != ignore_index
    safe = torch.where(valid, lbl, torch.zeros_like(lbl))
    picked = torch.gather(logp, axis, safe.unsqueeze(axis)).squeeze(axis)
    nll = torch.where(valid, -picked, torch.zeros_like(picked))
    if reduction == "mean":
        count = valid.to(nll.dtype).sum()
        return nll.sum() / torch.clamp(count, min=1.0)
    return _reduce(nll, reduction)


def cross_entropy(input, label, weight=None, ignore_index=-100, reduction="mean",  # noqa: A002
                  soft_label=False, axis=-1, use_softmax=True, label_smoothing=0.0,
                  name=None):
    """paddle.nn.functional.cross_entropy over logits (``use_softmax=True``)."""
    if not use_softmax:
        raise NotImplementedError(
            f"cross_entropy on probabilities (use_softmax=False) is not ported yet: "
            f"it belongs to {_LATER}")
    return _cross_entropy(input, label, weight, ignore_index=int(ignore_index),
                          reduction=reduction, soft_label=bool(soft_label), axis=int(axis),
                          label_smoothing=float(label_smoothing))


def softmax_with_cross_entropy(logits, label, soft_label=False, ignore_index=-100,
                               numeric_stable_mode=True, return_softmax=False, axis=-1):
    """Per-token loss with the class axis kept as size 1 (paddle's shape)."""
    loss = _cross_entropy(logits, label, None, ignore_index=int(ignore_index),
                          reduction="none", soft_label=bool(soft_label), axis=int(axis))
    loss = loss.unsqueeze(int(axis) % logits.dim())
    if return_softmax:
        return loss, torch.softmax(logits, dim=axis)
    return loss
