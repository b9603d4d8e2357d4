"""Losses: the port of paddle_tpu/nn/functional/loss.py, each an op under
the JAX op's name and AMP category, with the JAX arithmetic.

Cross entropy: ``log_softmax``, then
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

The rest: the regression losses (``mse_loss``, ``l1_loss``, ``smooth_l1_loss``
and ``huber_loss``, which differ at ``delta``: ``0.5 d^2 / delta`` against
``0.5 d^2``), the binary cross entropies (probabilities clipped at 1e-12; the
logits form stable through ``log1p(exp(-|x|))``, ``pos_weight`` scaling the
positive term), ``kl_div`` (``batchmean``: the sum over the batch size),
the margin and embedding losses, ``poisson_nll_loss`` (with ``full``, the
Stirling term where the label exceeds 1), ``gaussian_nll_loss`` (the
variance clamped at ``epsilon``), ``log_loss``, ``dice_loss`` (over a one-hot
of the last axis's labels) and ``ctc_loss``: the forward algorithm over the
blank-extended labels in log space, (T, N, C) log-probabilities, each
sequence's alphas held past its input length, ``reduction="mean"`` the mean
of each loss over its label length.
"""
from __future__ import annotations

import math

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


@defop("mse_loss")
def _mse_loss(input, label, reduction="mean"):  # noqa: A002
    return _reduce(torch.square(input - label), reduction)


def mse_loss(input, label, reduction="mean", name=None):  # noqa: A002
    return _mse_loss(input, label, reduction=reduction)


def square_error_cost(input, label):  # noqa: A002
    return _mse_loss(input, label, reduction="none")


@defop("l1_loss")
def _l1_loss(input, label, reduction="mean"):  # noqa: A002
    return _reduce(torch.abs(input - label), reduction)


def l1_loss(input, label, reduction="mean", name=None):  # noqa: A002
    return _l1_loss(input, label, reduction=reduction)


@defop("smooth_l1_loss")
def _smooth_l1(input, label, delta=1.0, reduction="mean"):  # noqa: A002
    d = torch.abs(input - label)
    return _reduce(torch.where(d < delta, 0.5 * d * d / delta, d - 0.5 * delta), reduction)


def smooth_l1_loss(input, label, reduction="mean", delta=1.0, name=None):  # noqa: A002
    return _smooth_l1(input, label, delta=float(delta), reduction=reduction)


@defop("huber_loss")
def _huber(input, label, delta=1.0, reduction="mean"):  # noqa: A002
    d = torch.abs(input - label)
    return _reduce(torch.where(d <= delta, 0.5 * d * d, delta * (d - 0.5 * delta)), reduction)


def huber_loss(input, label, delta=1.0, reduction="mean", name=None):  # noqa: A002
    return _huber(input, label, delta=float(delta), reduction=reduction)


@defop("bce_loss", amp_category="black")
def _bce(input, label, weight=None, reduction="mean"):  # noqa: A002
    eps = 1e-12
    loss = -(label * torch.log(torch.clamp(input, min=eps))
             + (1 - label) * torch.log(torch.clamp(1 - input, min=eps)))
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


def binary_cross_entropy(input, label, weight=None, reduction="mean", name=None):  # noqa: A002
    return _bce(input, label, weight, reduction=reduction)


@defop("bce_with_logits", amp_category="black")
def _bce_logits(logit, label, weight=None, pos_weight=None, reduction="mean"):
    max_val = torch.clamp(-logit, min=0.0)
    soft = torch.log1p(torch.exp(-torch.abs(logit)))
    if pos_weight is not None:
        log_w = (pos_weight - 1.0) * label + 1.0
        loss = (1 - label) * logit + log_w * (soft + max_val)
    else:
        loss = (1 - label) * logit + soft + max_val
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


def binary_cross_entropy_with_logits(logit, label, weight=None, reduction="mean",
                                     pos_weight=None, name=None):
    return _bce_logits(logit, label, weight, pos_weight, reduction=reduction)


def sigmoid_cross_entropy_with_logits(logit, label, normalize=False, ignore_index=-100):
    """The elementwise logits cross entropy (``normalize`` and
    ``ignore_index`` are accepted and unused, as in the JAX function)."""
    return _bce_logits(logit, label, None, None, reduction="none")


@defop("kl_div", amp_category="black")
def _kl_div(input, label, reduction="mean", log_target=False):  # noqa: A002
    if log_target:
        loss = torch.exp(label) * (label - input)
    else:
        loss = label * (torch.log(torch.clamp(label, min=1e-12)) - input)
    if reduction == "batchmean":
        return loss.sum() / input.shape[0]
    return _reduce(loss, reduction)


def kl_div(input, label, reduction="mean", log_target=False, name=None):  # noqa: A002
    return _kl_div(input, label, reduction=reduction, log_target=bool(log_target))


@defop("margin_ranking")
def _margin_ranking(input, other, label, margin=0.0, reduction="mean"):  # noqa: A002
    return _reduce(torch.clamp(-label * (input - other) + margin, min=0.0), reduction)


def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean", name=None):  # noqa: A002
    return _margin_ranking(input, other, label, margin=float(margin), reduction=reduction)


@defop("hinge_embedding")
def _hinge_embedding(input, label, margin=1.0, reduction="mean"):  # noqa: A002
    loss = torch.where(label == 1.0, input, torch.clamp(margin - input, min=0.0))
    return _reduce(loss, reduction)


def hinge_embedding_loss(input, label, margin=1.0, reduction="mean", name=None):  # noqa: A002
    return _hinge_embedding(input, label, margin=float(margin), reduction=reduction)


@defop("cosine_embedding")
def _cosine_embedding(input1, input2, label, margin=0.0, reduction="mean"):
    cos = torch.sum(input1 * input2, -1) / torch.clamp(
        torch.linalg.vector_norm(input1, dim=-1) * torch.linalg.vector_norm(input2, dim=-1),
        min=1e-12)
    loss = torch.where(label == 1, 1 - cos, torch.clamp(cos - margin, min=0.0))
    return _reduce(loss, reduction)


def cosine_embedding_loss(input1, input2, label, margin=0.0, reduction="mean", name=None):
    return _cosine_embedding(input1, input2, label, margin=float(margin), reduction=reduction)


@defop("triplet_margin")
def _triplet_margin(anchor, positive, negative, margin=1.0, p=2.0, eps=1e-6, swap=False,
                    reduction="mean"):
    def dist(a, b):
        return torch.pow(torch.sum(torch.pow(torch.abs(a - b) + eps, p), -1), 1.0 / p)

    dp = dist(anchor, positive)
    dn = dist(anchor, negative)
    if swap:
        dn = torch.minimum(dn, dist(positive, negative))
    return _reduce(torch.clamp(dp - dn + margin, min=0.0), reduction)


def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0, epsilon=1e-6,  # noqa: A002
                        swap=False, reduction="mean", name=None):
    return _triplet_margin(input, positive, negative, margin=float(margin), p=float(p),
                           eps=float(epsilon), swap=bool(swap), reduction=reduction)


@defop("soft_margin")
def _soft_margin(input, label, reduction="mean"):  # noqa: A002
    return _reduce(torch.log1p(torch.exp(-label * input)), reduction)


def soft_margin_loss(input, label, reduction="mean", name=None):  # noqa: A002
    return _soft_margin(input, label, reduction=reduction)


@defop("multi_label_soft_margin")
def _mlsm(input, label, weight=None, reduction="mean"):  # noqa: A002
    loss = -(label * torch.nn.functional.logsigmoid(input)
             + (1 - label) * torch.nn.functional.logsigmoid(-input))
    if weight is not None:
        loss = loss * weight
    return _reduce(loss.mean(-1), reduction)


def multi_label_soft_margin_loss(input, label, weight=None, reduction="mean", name=None):  # noqa: A002
    return _mlsm(input, label, weight, reduction=reduction)


@defop("poisson_nll")
def _poisson_nll(input, label, log_input=True, full=False, epsilon=1e-8, reduction="mean"):  # noqa: A002
    if log_input:
        loss = torch.exp(input) - label * input
    else:
        loss = input - label * torch.log(input + epsilon)
    if full:
        lbl = torch.clamp(label, min=1.0)
        stirling = label * torch.log(lbl) - label + 0.5 * torch.log(2 * math.pi * lbl)
        loss = loss + torch.where(label > 1, stirling, torch.zeros_like(stirling))
    return _reduce(loss, reduction)


def poisson_nll_loss(input, label, log_input=True, full=False, epsilon=1e-8,  # noqa: A002
                     reduction="mean", name=None):
    return _poisson_nll(input, label, log_input=bool(log_input), full=bool(full),
                        epsilon=float(epsilon), reduction=reduction)


@defop("gaussian_nll")
def _gaussian_nll(input, label, variance, full=False, epsilon=1e-6, reduction="mean"):  # noqa: A002
    var = torch.clamp(variance, min=epsilon)
    loss = 0.5 * (torch.log(var) + torch.square(input - label) / var)
    if full:
        loss = loss + 0.5 * math.log(2 * math.pi)
    return _reduce(loss, reduction)


def gaussian_nll_loss(input, label, variance, full=False, epsilon=1e-6, reduction="mean",  # noqa: A002
                      name=None):
    return _gaussian_nll(input, label, variance, full=bool(full), epsilon=float(epsilon),
                         reduction=reduction)


@defop("log_loss_op")
def _log_loss_op(input, label, epsilon=1e-4):  # noqa: A002
    return -label * torch.log(input + epsilon) - (1 - label) * torch.log(1 - input + epsilon)


def log_loss(input, label, epsilon=1e-4, name=None):  # noqa: A002
    return _log_loss_op(input, label, epsilon=float(epsilon))


_NEG_INF = -1e30


@defop("ctc_loss_op", amp_category="black")
def _ctc_loss_op(log_probs, labels, input_lengths, label_lengths, blank=0):
    """-log p(labels | log_probs) a sequence, (T, N, C) paddle layout: the
    forward algorithm over the labels with blanks between and around them
    (S = 2 L + 1 states), in log space."""
    T, N, _ = log_probs.shape
    S = 2 * labels.shape[1] + 1
    dev = log_probs.device
    rows = torch.arange(N, device=dev)
    ext = torch.full((N, S), blank, dtype=torch.long, device=dev)
    ext[:, 1::2] = labels.long()
    in_len = input_lengths.to(dev).long()
    lab_len = label_lengths.to(dev).long()
    neg = torch.full((N, S), _NEG_INF, dtype=log_probs.dtype, device=dev)
    first = torch.where(lab_len > 0, log_probs[0, rows, ext[:, 1]],
                        torch.full_like(lab_len, _NEG_INF, dtype=log_probs.dtype))
    alpha = torch.cat([log_probs[0, rows, blank][:, None], first[:, None], neg[:, 2:]], 1)
    same_as_prev2 = torch.cat([torch.zeros((N, 2), dtype=torch.bool, device=dev),
                               ext[:, 2:] == ext[:, :-2]], 1)
    for t in range(1, T):
        a1 = torch.cat([neg[:, :1], alpha[:, :-1]], 1)
        a2 = torch.where(same_as_prev2, neg, torch.cat([neg[:, :2], alpha[:, :-2]], 1))
        merged = torch.logaddexp(alpha, torch.logaddexp(a1, a2))
        new = merged + log_probs[t].gather(1, ext)
        alpha = torch.where((t < in_len)[:, None], new, alpha)
    end = 2 * lab_len
    last = alpha[rows, end]
    last2 = torch.where(end - 1 >= 0, alpha[rows, torch.clamp(end - 1, min=0)],
                        torch.full_like(last, _NEG_INF))
    return -torch.logaddexp(last, last2)


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0, reduction="mean",
             norm_by_times=False):
    """CTC over (T, N, C) log-probabilities (module docstring)."""
    loss = _ctc_loss_op(log_probs, labels, input_lengths, label_lengths, blank=int(blank))
    if reduction == "mean":
        return (loss / label_lengths.to(device=loss.device, dtype=loss.dtype)).mean()
    if reduction == "sum":
        return loss.sum()
    return loss


@defop("dice_loss_op")
def _dice_loss_op(input, label, epsilon=1e-5):  # noqa: A002
    lbl = torch.nn.functional.one_hot(label.squeeze(-1).long(), input.shape[-1]).to(input.dtype)
    red = tuple(range(1, input.dim()))
    inter = torch.sum(input * lbl, dim=red)
    union = torch.sum(input, dim=red) + torch.sum(lbl, dim=red)
    return torch.mean(1.0 - (2 * inter + epsilon) / (union + epsilon))


def dice_loss(input, label, epsilon=1e-5, name=None):  # noqa: A002
    return _dice_loss_op(input, label, epsilon=float(epsilon))
