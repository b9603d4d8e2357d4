"""Cross-entropy losses: the port of paddle_tpu/nn/functional/loss.py
(``_cross_entropy``, ``cross_entropy``, ``softmax_with_cross_entropy``,
``nll_loss``).

The JAX arithmetic: ``log_softmax``, then
  * hard labels: a gather at the label (0 where the label is
    ``ignore_index``), ``-picked``, or with ``label_smoothing`` s
    ``-(1 - s) * picked - s * mean(logp)``; times the label's class
    ``weight``, if given; ``reduction="mean"`` divides the sum over valid
    tokens by ``max(count, 1)``, or with weights by ``max(sum of the valid
    tokens' weights, 1e-12)``;
  * soft labels: ``-sum(soft * logp)``, with ``label_smoothing`` s the
    labels ``soft * (1 - s) + s / classes``; ``reduction="mean"`` is the
    plain mean;
  * ``use_softmax=False``: the input is a distribution, and the loss is
    ``nll_loss(log(input))`` over class axis 1.
Everything is computed in the logits' dtype, as the JAX functions do outside
AMP (a bfloat16 model has a bfloat16 loss). ``_cross_entropy`` is the op
``cross_entropy`` and ``_nll_loss`` the op ``nll_loss_op``, both black-listed
under AMP (float32 inputs).
"""
from __future__ import annotations

import torch

from ...ops._apply import defop
from ...ops.manipulation import unsqueeze


def _reduce(out, reduction):
    if reduction == "mean":
        return out.mean()
    if reduction == "sum":
        return out.sum()
    return out


def _check_reduction(reduction):
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"unknown reduction {reduction!r}")


@defop("cross_entropy", amp_category="black")
def _cross_entropy(input, label, weight=None, ignore_index=-100, reduction="mean",  # noqa: A002
                   soft_label=False, axis=-1, label_smoothing=0.0):
    _check_reduction(reduction)
    axis = axis % input.dim()
    logp = torch.log_softmax(input, dim=axis)
    if soft_label:
        soft = label
        if label_smoothing > 0.0:
            soft = soft * (1 - label_smoothing) + label_smoothing / input.shape[axis]
        return _reduce(-(soft * logp).sum(dim=axis), reduction)
    lbl = label
    if lbl.dim() == input.dim() and lbl.shape[axis] == 1:
        lbl = lbl.squeeze(axis)
    lbl = lbl.long()
    valid = lbl != ignore_index
    safe = torch.where(valid, lbl, torch.zeros_like(lbl))
    picked = torch.gather(logp, axis, safe.unsqueeze(axis)).squeeze(axis)
    if label_smoothing > 0.0:
        nll = -(1 - label_smoothing) * picked - label_smoothing * logp.mean(dim=axis)
    else:
        nll = -picked
    zero = torch.zeros_like(nll)
    if weight is not None:
        w = torch.as_tensor(weight, device=nll.device)[safe]
        nll = torch.where(valid, nll * w, zero)
        if reduction == "mean":
            return nll.sum() / torch.clamp(torch.where(valid, w, torch.zeros_like(w)).sum(),
                                           min=1e-12)
        return _reduce(nll, reduction)
    nll = torch.where(valid, nll, zero)
    if reduction == "mean":
        return nll.sum() / torch.clamp(valid.to(nll.dtype).sum(), min=1.0)
    return _reduce(nll, reduction)


@defop("nll_loss_op", amp_category="black")
def _nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean"):  # noqa: A002
    _check_reduction(reduction)
    lbl = label.long()
    valid = lbl != ignore_index
    safe = torch.where(valid, lbl, torch.zeros_like(lbl))
    loss = -torch.gather(input, 1, safe.unsqueeze(1)).squeeze(1)
    zero = torch.zeros_like(loss)
    if weight is not None:
        w = torch.as_tensor(weight, device=loss.device)[safe]
        loss = torch.where(valid, loss * w, zero)
        if reduction == "mean":
            return loss.sum() / torch.clamp(torch.where(valid, w, torch.zeros_like(w)).sum(),
                                            min=1e-12)
    loss = torch.where(valid, loss, zero)
    return _reduce(loss, reduction)


def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean",  # noqa: A002
             name=None):
    """Negative log-likelihood of log-probabilities, the class axis 1."""
    return _nll_loss(input, label, weight, ignore_index=int(ignore_index), reduction=reduction)


def cross_entropy(input, label, weight=None, ignore_index=-100, reduction="mean",  # noqa: A002
                  soft_label=False, axis=-1, use_softmax=True, label_smoothing=0.0,
                  name=None):
    """paddle.nn.functional.cross_entropy: over logits (``use_softmax=True``)
    or over probabilities (``use_softmax=False``)."""
    if not use_softmax:
        return nll_loss(input.log(), label, weight, int(ignore_index), reduction)
    return _cross_entropy(input, label, weight, ignore_index=int(ignore_index),
                          reduction=reduction, soft_label=bool(soft_label), axis=int(axis),
                          label_smoothing=float(label_smoothing))


def softmax_with_cross_entropy(logits, label, soft_label=False, ignore_index=-100,
                               numeric_stable_mode=True, return_softmax=False, axis=-1):
    """Per-token loss; with hard labels the class axis is kept as size 1
    (paddle's shape), with soft labels it is reduced away (as the JAX
    function gives it)."""
    loss = _cross_entropy(logits, label, None, ignore_index=int(ignore_index),
                          reduction="none", soft_label=bool(soft_label), axis=int(axis))
    if not soft_label:
        loss = unsqueeze(loss, [int(axis)])
    if return_softmax:
        from .activation import softmax

        return loss, softmax(logits, axis=axis)
    return loss
