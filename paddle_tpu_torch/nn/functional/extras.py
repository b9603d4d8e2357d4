"""The functional-surface batch: the port of paddle_tpu/nn/functional/extras.py.

Losses (``pairwise_distance``, ``npair_loss``, ``sigmoid_focal_loss``,
``multi_margin_loss``, ``triplet_margin_with_distance_loss``,
``margin_cross_entropy`` single process, ``hsigmoid_loss``, ``rnnt_loss``,
``adaptive_log_softmax_with_loss``), vision geometry (``affine_grid``,
``grid_sample``, ``temporal_shift``), pooling variants (``lp_pool*``,
``max_unpool*``, ``fractional_max_pool*``), ``log_sigmoid``, ``rrelu`` and
the in-place activations, ``zeropad2d``, ``gather_tree``, ``bilinear``,
``feature_alpha_dropout``, ``class_center_sample``, and the attention
wrappers (the packed ones, ``flashmask_attention``, ``sparse_attention``),
each with the JAX arithmetic; the ops keep the JAX names.

Random draws (``rrelu`` in training, ``fractional_max_pool*`` without
``random_u``, ``feature_alpha_dropout``, ``class_center_sample``) come from
the device's default generator, so ``paddle_tpu_torch.seed`` fixes them; the
JAX package's PRNG stream is not reproduced. As in JAX, host values are read
where the JAX function reads them: ``hsigmoid_loss``'s labels and paths,
``class_center_sample``'s labels and ``sparse_attention``'s CSR layout.
``rnnt_loss`` runs the JAX recursion over the (T, U) lattice in float64
(the JAX package's lattice is float64, as it runs with x64 on) and returns
float64 losses, as JAX does.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as tF

from ...ops import manipulation as _manip
from ...ops._apply import defop
from ...ops.math import _make_inplace, tanh
from ...ops.random_ops import _gen
from .activation import elu, hardtanh, leaky_relu, thresholded_relu
from .common import _alpha_affine
from .flash_attention import flash_attention, flash_attn_unpadded, scaled_dot_product_attention


# -- activations --------------------------------------------------------------
@defop("log_sigmoid")
def log_sigmoid(x):
    return tF.logsigmoid(x)


@defop("rrelu_eval")
def _rrelu_eval(x, slope=0.25):
    return torch.where(x >= 0, x, slope * x)


@defop("rrelu_train")
def _rrelu_train(x, slopes):
    return torch.where(x >= 0, x, slopes.to(x.dtype) * x)


def rrelu(x, lower=1.0 / 8.0, upper=1.0 / 3.0, training=False, name=None):
    """Randomized leaky relu: a float32 slope per element drawn from
    U(lower, upper) in training, the mean slope in eval."""
    if not training:
        return _rrelu_eval(x, slope=(lower + upper) / 2.0)
    u = torch.rand(tuple(x.shape), generator=_gen(x.device), device=x.device,
                   dtype=torch.float32)
    return _rrelu_train(x, lower + (upper - lower) * u)


elu_ = _make_inplace(elu)
tanh_ = _make_inplace(tanh)
leaky_relu_ = _make_inplace(leaky_relu)
hardtanh_ = _make_inplace(hardtanh)
thresholded_relu_ = _make_inplace(thresholded_relu)


# -- losses -------------------------------------------------------------------
@defop("pairwise_distance")
def pairwise_distance(x, y, p=2.0, epsilon=1e-6, keepdim=False):
    return torch.linalg.vector_norm(x - y + epsilon, ord=p, dim=-1, keepdim=keepdim)


@defop("npair_loss")
def npair_loss(anchor, positive, labels, l2_reg=0.002):
    """Cross entropy over ``anchor @ positive^T`` against the label-equality
    targets, plus the L2 term."""
    labels = labels.reshape(-1)
    eq = (labels[:, None] == labels[None, :]).to(anchor.dtype)
    targets = eq / torch.sum(eq, dim=1, keepdim=True)
    logp = torch.log_softmax(anchor @ positive.T, dim=1)
    ce = -torch.mean(torch.sum(targets * logp, dim=1))
    reg = (l2_reg * (torch.sum(anchor * anchor) + torch.sum(positive * positive))
           / (2.0 * anchor.shape[0]))
    return ce + reg


def _reduce(loss, reduction):
    if reduction == "mean":
        return torch.mean(loss)
    if reduction == "sum":
        return torch.sum(loss)
    return loss


@defop("sigmoid_focal_loss")
def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum"):
    p = torch.sigmoid(logit)
    ce = torch.logaddexp(torch.zeros_like(logit), logit) - label * logit
    p_t = p * label + (1 - p) * (1 - label)
    a_t = alpha * label + (1 - alpha) * (1 - label)
    loss = a_t * ((1 - p_t) ** gamma) * ce
    if normalizer is not None:
        loss = loss / normalizer
    return _reduce(loss, reduction)


@defop("multi_margin_loss")
def multi_margin_loss(input, label, p=1, margin=1.0, weight=None,  # noqa: A002
                      reduction="mean"):
    n, c = input.shape
    rows = torch.arange(n, device=input.device)
    target = input[rows, label]
    diff = torch.clamp(margin - target[:, None] + input, min=0.0) ** p
    if weight is not None:
        diff = diff * weight[label][:, None]
    own = tF.one_hot(label.long(), c).to(torch.bool)
    diff = torch.where(own, torch.zeros_like(diff), diff)
    return _reduce(torch.sum(diff, dim=1) / c, reduction)


def triplet_margin_with_distance_loss(input, positive, negative,  # noqa: A002
                                      distance_function=None, margin=1.0,
                                      swap=False, reduction="mean", name=None):
    """The distance callable runs on tensors (by default pairwise L2)."""
    from ...ops import math as _m

    dist = distance_function or (lambda a, b: pairwise_distance(a, b))
    d_pos = dist(input, positive)
    d_neg = dist(input, negative)
    if swap:
        d_neg = _m.minimum(d_neg, dist(positive, negative))
    loss = _m.clip(d_pos - d_neg + margin, min=0.0)
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


@defop("margin_cross_entropy")
def margin_cross_entropy(logits, label, margin1=1.0, margin2=0.5, margin3=0.0,
                         scale=64.0, return_softmax=False, reduction="mean"):
    """ArcFace-family margin softmax, single process."""
    cos = torch.clamp(logits, -1.0, 1.0)
    idx = label.long().reshape(-1, 1)
    theta = torch.arccos(torch.gather(cos, 1, idx))
    target = torch.cos(margin1 * theta + margin2) - margin3
    adj = torch.scatter(cos, 1, idx, target) * scale
    logp = torch.log_softmax(adj, dim=1)
    loss = -torch.gather(logp, 1, idx).reshape(-1)
    if reduction == "mean":
        loss = torch.mean(loss)
    elif reduction == "sum":
        loss = torch.sum(loss)
    if return_softmax:
        return loss, torch.softmax(adj, dim=1)
    return loss


# -- vision geometry ----------------------------------------------------------
@defop("affine_grid")
def affine_grid(theta, out_shape, align_corners=True):
    """(N, 2, 3) theta -> (N, H, W, 2) sampling grid, computed in float64 (the
    JAX package's ``linspace`` is float64) and cast to theta's dtype."""
    _, _, h, w = [int(s) for s in out_shape]

    def lin(size):
        if align_corners:
            return torch.linspace(-1.0, 1.0, size, dtype=torch.float64, device=theta.device)
        step = 2.0 / size
        return torch.linspace(-1.0 + step / 2, 1.0 - step / 2, size, dtype=torch.float64,
                              device=theta.device)

    ys, xs = torch.meshgrid(lin(h), lin(w), indexing="ij")
    base = torch.stack([xs, ys, torch.ones_like(xs)], dim=-1)  # (H, W, 3)
    return torch.einsum("hwk,nck->nhwc", base, theta.to(torch.float64)).to(theta.dtype)


@defop("grid_sample")
def grid_sample(x, grid, mode="bilinear", padding_mode="zeros", align_corners=True):
    """NCHW input, (N, Hg, Wg, 2) grid in [-1, 1]; out-of-range taps read 0."""
    n, c, h, w = x.shape

    def unnorm(coord, size):
        if align_corners:
            return (coord + 1.0) * (size - 1) / 2.0
        return ((coord + 1.0) * size - 1.0) / 2.0

    gx = unnorm(grid[..., 0], w)
    gy = unnorm(grid[..., 1], h)
    if padding_mode == "border":
        gx = torch.clamp(gx, 0, w - 1)
        gy = torch.clamp(gy, 0, h - 1)
    elif padding_mode == "reflection":
        span_x = (w - 1) if align_corners else w
        span_y = (h - 1) if align_corners else h
        gx = torch.abs(torch.remainder(gx + span_x, 2 * span_x) - span_x)
        gy = torch.abs(torch.remainder(gy + span_y, 2 * span_y) - span_y)
    batch = torch.arange(n, device=x.device)[:, None, None]

    def gather(ix, iy):
        ok = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
        vals = x[batch, :, torch.clamp(iy, 0, h - 1), torch.clamp(ix, 0, w - 1)]  # (N, Hg, Wg, C)
        return torch.where(ok[..., None], vals, torch.zeros_like(vals))

    if mode == "nearest":
        out = gather(torch.round(gx).to(torch.int32), torch.round(gy).to(torch.int32))
    else:
        x0 = torch.floor(gx).to(torch.int32)
        y0 = torch.floor(gy).to(torch.int32)
        wx = gx - x0
        wy = gy - y0
        out = (gather(x0, y0) * ((1 - wx) * (1 - wy))[..., None]
               + gather(x0 + 1, y0) * (wx * (1 - wy))[..., None]
               + gather(x0, y0 + 1) * ((1 - wx) * wy)[..., None]
               + gather(x0 + 1, y0 + 1) * (wx * wy)[..., None])
    return out.permute(0, 3, 1, 2)


@defop("temporal_shift")
def temporal_shift(x, seg_num, shift_ratio=0.25, data_format="NCHW"):
    """Shift ``c * shift_ratio`` channels one step back and as many one step
    forward along time."""
    if data_format != "NCHW":
        x = x.permute(0, 3, 1, 2)
    nt, c, h, w = x.shape
    xr = x.reshape(nt // seg_num, seg_num, c, h, w)
    fold = int(c * shift_ratio)
    back = torch.cat([xr[:, 1:, :fold], torch.zeros_like(xr[:, :1, :fold])], dim=1)
    fwd = torch.cat([torch.zeros_like(xr[:, :1, fold:2 * fold]), xr[:, :-1, fold:2 * fold]],
                    dim=1)
    out = torch.cat([back, fwd, xr[:, :, 2 * fold:]], dim=2).reshape(nt, c, h, w)
    if data_format != "NCHW":
        out = out.permute(0, 2, 3, 1)
    return out


# -- padding / beam search ----------------------------------------------------
def zeropad2d(x, padding, data_format="NCHW", name=None):
    """[left, right, top, bottom] zeros on H and W."""
    return _manip.pad(x, list(padding), mode="constant", value=0.0, data_format=data_format)


@defop("gather_tree", differentiable=False)
def gather_tree(ids, parents):
    """Backtrack beam-search parent pointers; ids and parents are
    (max_time, batch, beam)."""
    beams = torch.arange(ids.shape[2], device=ids.device).expand(ids.shape[1:]).to(ids.dtype)
    out = [None] * ids.shape[0]
    for t in range(ids.shape[0] - 1, -1, -1):
        idx = beams.long()
        out[t] = torch.gather(ids[t], 1, idx)
        beams = torch.gather(parents[t], 1, idx)
    return torch.stack(out)


# -- pooling variants ---------------------------------------------------------
def lp_pool1d(x, norm_type, kernel_size, stride=None, padding=0, ceil_mode=False, name=None):
    from .pooling import avg_pool1d

    p = float(norm_type)
    pooled = avg_pool1d(x.abs() ** p, kernel_size, stride=stride, padding=padding,
                        ceil_mode=ceil_mode, exclusive=False)
    k = kernel_size if isinstance(kernel_size, int) else int(np.prod(kernel_size))
    return (pooled * float(k)) ** (1.0 / p)


def lp_pool2d(x, norm_type, kernel_size, stride=None, padding=0, ceil_mode=False,
              data_format="NCHW", name=None):
    from .pooling import avg_pool2d

    p = float(norm_type)
    pooled = avg_pool2d(x.abs() ** p, kernel_size, stride=stride, padding=padding,
                        ceil_mode=ceil_mode, exclusive=False, data_format=data_format)
    ks = (kernel_size, kernel_size) if isinstance(kernel_size, int) else kernel_size
    return (pooled * float(np.prod(ks))) ** (1.0 / p)


@defop("max_unpool2d_inner")
def _max_unpool2d_inner(x, mask, out_h, out_w):
    n, c, h, w = x.shape
    out = torch.zeros((n, c, out_h * out_w), dtype=x.dtype, device=x.device)
    out = torch.scatter(out, 2, mask.reshape(n, c, h * w).long(), x.reshape(n, c, h * w))
    return out.reshape(n, c, out_h, out_w)


def max_unpool2d(x, indices, kernel_size, stride=None, padding=0, output_size=None,
                 data_format="NCHW", name=None):
    """Scatter pooled values to their argmax sites (the indices of
    ``max_pool2d(return_mask=True)``); NCHW whatever ``data_format`` says,
    as in JAX."""
    ks = (kernel_size, kernel_size) if isinstance(kernel_size, int) else tuple(kernel_size)
    st = ks if stride is None else ((stride, stride) if isinstance(stride, int)
                                    else tuple(stride))
    _, _, h, w = x.shape
    if output_size is None:
        out_h = (h - 1) * st[0] + ks[0] - 2 * (padding if isinstance(padding, int) else padding[0])
        out_w = (w - 1) * st[1] + ks[1] - 2 * (padding if isinstance(padding, int) else padding[1])
    else:
        out_h, out_w = [int(s) for s in output_size[-2:]]
    return _max_unpool2d_inner(x, indices, out_h, out_w)


def max_unpool1d(x, indices, kernel_size, stride=None, padding=0, output_size=None, name=None):
    out_size = None if output_size is None else list(output_size[-1:]) + [1]
    out = max_unpool2d(_manip.unsqueeze(x, -1), _manip.unsqueeze(indices, -1), (kernel_size, 1),
                       stride=(stride or kernel_size, 1),
                       padding=(padding, 0) if isinstance(padding, int) else padding,
                       output_size=out_size)
    return _manip.squeeze(out, -1)


def max_unpool3d(x, indices, kernel_size, stride=None, padding=0, output_size=None,
                 data_format="NCDHW", name=None):
    """Through the flat-index 2-D scatter over the D*H*W plane."""
    n, c, d, h, w = [int(s) for s in x.shape]
    ks = (kernel_size,) * 3 if isinstance(kernel_size, int) else tuple(kernel_size)
    st = ks if stride is None else ((stride,) * 3 if isinstance(stride, int) else tuple(stride))
    pd = (padding,) * 3 if isinstance(padding, int) else tuple(padding)
    if output_size is None:
        out_d, out_h, out_w = [(s - 1) * st[i] + ks[i] - 2 * pd[i]
                               for i, s in enumerate((d, h, w))]
    else:
        out_d, out_h, out_w = [int(s) for s in output_size[-3:]]
    flat = _max_unpool2d_inner(_manip.reshape(x, [n, c, d * h * w, 1]),
                               _manip.reshape(indices, [n, c, d * h * w, 1]),
                               out_d * out_h * out_w, 1)
    return _manip.reshape(flat, [n, c, out_d, out_h, out_w])


def _frac_bounds(in_size, out_size, u):
    """Fractional pooling windows [start, end) from the alpha * (i + u)
    sequence, each at least one element."""
    alpha = in_size / out_size
    starts = [max(0, math.ceil(alpha * (i + u) - 1)) for i in range(out_size)]
    ends = [min(in_size, math.ceil(alpha * (i + 1 + u) - 1)) for i in range(out_size)]
    return starts, [max(e, s + 1) for s, e in zip(starts, ends)]


def _window_index(starts, ends, device):
    """(out, K) source rows of each window, K its widest; a shorter window's
    row repeats its last element, which moves neither the max nor the first
    argmax in row-major order."""
    k = max(e - s for s, e in zip(starts, ends))
    idx = [[min(s + j, e - 1) for j in range(k)] for s, e in zip(starts, ends)]
    return torch.tensor(idx, dtype=torch.int64, device=device)


def _random_u(x, random_u):
    if random_u is not None:
        return random_u
    return float(torch.rand((), generator=_gen(x.device), device=x.device,
                            dtype=torch.float64))


def _fractional_max_pool(x, sizes, u, return_mask):
    """Max over each fractional window of the trailing ``len(sizes)`` dims
    (and the flat spatial index of its first maximum)."""
    nd = len(sizes)
    spatial = x.shape[2:]
    idx = [_window_index(*_frac_bounds(n, m, u), x.device) for n, m in zip(spatial, sizes)]
    win = x
    for i, ix in enumerate(idx):
        # (n, c, o_1, K_1, ..., o_i, K_i, n_{i+1}, ...)
        win = win.index_select(2 + 2 * i, ix.reshape(-1)).unflatten(2 + 2 * i, ix.shape)
    perm = ([0, 1] + [2 + 2 * i for i in range(nd)] + [3 + 2 * i for i in range(nd)])
    win = win.permute(perm).flatten(2 + nd)
    out = torch.amax(win, dim=-1)
    if not return_mask:
        return out
    local = torch.argmax(win.detach(), dim=-1)
    flat = 0
    for i in reversed(range(nd)):
        k = idx[i].shape[1]
        pos = local % k
        local = local // k
        shape = [1] * (2 + nd)
        shape[2 + i] = -1
        window = torch.arange(idx[i].shape[0], device=x.device).reshape(shape)
        flat = flat + idx[i][window, pos] * int(np.prod(spatial[i + 1:]))
    return out, flat.to(torch.int64)


def fractional_max_pool2d(x, output_size, kernel_size=None, random_u=None, return_mask=False,
                          name=None):
    """Fractional max pooling (Graham 2015): windows from the alpha * (i + u)
    sequence; ``kernel_size`` is ignored, as in JAX."""
    sizes = (output_size,) * 2 if isinstance(output_size, int) else tuple(output_size)
    return _fractional_max_pool(x, sizes, _random_u(x, random_u), return_mask)


def fractional_max_pool3d(x, output_size, kernel_size=None, random_u=None, return_mask=False,
                          name=None):
    sizes = (output_size,) * 3 if isinstance(output_size, int) else tuple(output_size)
    return _fractional_max_pool(x, sizes, _random_u(x, random_u), return_mask)


def feature_alpha_dropout(x, p=0.5, training=True, name=None):
    """Alpha dropout that drops whole channel maps (dim 1)."""
    if not training or p == 0.0:
        return x
    if p >= 1.0:
        return torch.zeros_like(x)
    shape = (x.shape[0], x.shape[1]) + (1,) * (x.dim() - 2) if x.dim() >= 2 else x.shape
    keep = torch.rand(shape, generator=_gen(x.device), device=x.device,
                      dtype=torch.float32) < 1.0 - p
    a, b, alpha_p = _alpha_affine(p)
    return a * torch.where(keep, x, torch.full_like(x, alpha_p)) + b


# -- attention ------------------------------------------------------------------
def flash_attn_qkvpacked(qkv, dropout=0.0, causal=False, return_softmax=False,
                         training=True, name=None):
    """(B, S, 3, H, D) packed q, k, v through ``flash_attention``."""
    return flash_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], dropout=dropout,
                           causal=causal, return_softmax=return_softmax, training=training)


def flash_attn_varlen_qkvpacked(qkv, cu_seqlens, max_seqlen, scale=None, dropout=0.0,
                                causal=False, return_softmax=False, training=True,
                                name=None):
    """(total, 3, H, D) packed ragged batches through ``flash_attn_unpadded``."""
    return flash_attn_unpadded(qkv[:, 0], qkv[:, 1], qkv[:, 2], cu_seqlens, cu_seqlens,
                               max_seqlen, max_seqlen, scale=scale, dropout=dropout,
                               causal=causal, return_softmax=return_softmax,
                               training=training)


def _flashmask_to_dense(sri, seq_len, causal):
    """FlashMask's start/end row indices (B, KH, S, k) as a boolean keep mask
    (True = attend): per key column j, rows [start, end) (or [start, S)) are
    masked; causal also masks i < j; the non-causal forms carry the upper
    triangle's bounds in the trailing slots."""
    k = sri.shape[-1]
    has_end = (causal and k == 2) or ((not causal) and k == 4)
    i = torch.arange(seq_len, device=sri.device)[None, None, :, None]
    j = torch.arange(seq_len, device=sri.device)[None, None, None, :]
    ds = sri[..., 0][:, :, None, :]
    if has_end:
        masked = (i >= ds) & (i < sri[..., 1][:, :, None, :])
    else:
        masked = i >= ds
    if causal:
        masked = masked | (i < j)
    elif has_end:
        masked = masked | ((i >= sri[..., 2][:, :, None, :]) & (i < sri[..., 3][:, :, None, :]))
    else:
        masked = masked | (i < sri[..., 1][:, :, None, :])
    return ~masked


def flashmask_attention(query, key, value, startend_row_indices=None, dropout=0.0,
                        causal=False, name=None):
    """Through ``scaled_dot_product_attention``: with no row indices, the
    kernel where it applies; with them, the math path on the dense boolean
    mask (O(S^2) memory, as in JAX)."""
    if startend_row_indices is None:
        return scaled_dot_product_attention(query, key, value, attn_mask=None,
                                            dropout_p=dropout, is_causal=causal)
    keep = _flashmask_to_dense(startend_row_indices, query.shape[1], causal)
    hq, kh = int(query.shape[2]), int(keep.shape[1])
    if kh not in (1, hq):  # GQA: a kv head's mask for each of its query heads
        keep = keep.repeat_interleave(hq // kh, dim=1)
    return scaled_dot_product_attention(query, key, value, attn_mask=keep, dropout_p=dropout,
                                        is_causal=False)


def sparse_attention(query, key, value, sparse_csr_offset, sparse_csr_columns,
                     key_padding_mask=None, attn_mask=None, name=None):
    """Block-sparse attention from a CSR layout on (B, H, S, D) tensors: the
    pattern, read on the host, as a dense boolean mask on the math path.
    ``key_padding_mask`` and ``attn_mask`` are ignored, as in JAX."""
    offs = np.asarray(torch.as_tensor(sparse_csr_offset).cpu())
    cols = np.asarray(torch.as_tensor(sparse_csr_columns).cpu())
    B, H, S, _ = query.shape
    keep = np.zeros((B, H, S, S), bool)
    for b in range(B):
        for h in range(H):
            rows = np.repeat(np.arange(S), np.diff(offs[b, h, :S + 1]))
            keep[b, h, rows, cols[b, h, offs[b, h, 0]:offs[b, h, S]]] = True
    q, k, v = (_manip.transpose(t, [0, 2, 1, 3]) for t in (query, key, value))
    out = scaled_dot_product_attention(q, k, v,
                                       attn_mask=torch.from_numpy(keep).to(query.device))
    return _manip.transpose(out, [0, 2, 1, 3])


# -- hierarchical sigmoid -----------------------------------------------------
def _default_huffman_paths(num_classes):
    """Path tables of the complete binary tree: internal nodes
    0..num_classes-2, leaf c at heap position num_classes-1+c; the path is
    the internal ancestors root to parent, the code the branch taken
    (1 = right child); -1 pads."""
    n_internal = num_classes - 1
    tables, codes = [], []
    for c in range(num_classes):
        pos = n_internal + c
        path, code = [], []
        while pos > 0:
            parent = (pos - 1) // 2
            path.append(parent)
            code.append((pos - 1) % 2)
            pos = parent
        tables.append(path[::-1])
        codes.append(code[::-1])
    max_len = max(len(p) for p in tables)
    pt = np.full((num_classes, max_len), -1, np.int64)
    pc = np.full((num_classes, max_len), -1, np.int64)
    for c in range(num_classes):
        pt[c, :len(tables[c])] = tables[c]
        pc[c, :len(codes[c])] = codes[c]
    return pt, pc


@defop("hsigmoid_loss")
def _hsigmoid_inner(x, w, bias, paths, codes):
    valid = paths >= 0
    safe = torch.clamp(paths, min=0)
    logits = torch.einsum("nld,nd->nl", w[safe], x)
    if bias is not None:
        logits = logits + bias[safe]
    # BCE against the code: -[c log s(z) + (1 - c) log(1 - s(z))]
    per_node = torch.logaddexp(torch.zeros_like(logits), logits) - codes.to(logits.dtype) * logits
    per_node = torch.where(valid, per_node, torch.zeros_like(per_node))
    return torch.sum(per_node, dim=1, keepdim=True)


def _host_array(v):
    return np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor) else v)


def hsigmoid_loss(input, label, num_classes, weight, bias=None, path_table=None,  # noqa: A002
                  path_code=None, is_sparse=False, name=None):
    """Hierarchical sigmoid over the complete binary tree, or over a custom
    ``path_table``/``path_code`` (per class, or per sample)."""
    label_np = _host_array(label).astype(np.int64).ravel()
    if path_table is None:
        pt, pc = _default_huffman_paths(int(num_classes))
        paths, codes = pt[label_np], pc[label_np]
    else:
        paths, codes = _host_array(path_table), _host_array(path_code)
        if paths.ndim == 2 and paths.shape[0] == int(num_classes):
            paths, codes = paths[label_np], codes[label_np]
    dev = input.device
    return _hsigmoid_inner(input, weight, bias, torch.from_numpy(paths).long().to(dev),
                           torch.from_numpy(codes).long().to(dev))


# -- RNN-T (transducer) loss --------------------------------------------------
@defop("rnnt_loss")
def _rnnt_inner(logits, labels, input_lengths, label_lengths, blank=0):
    """The transducer forward variables in log space, batched: alpha[t, u]
    is the log-probability of consuming t frames while emitting u labels;
    row 0 only emits, each later row comes from the row above (a blank) or
    from its left (an emission); the loss is -(alpha[T-1, U] + blank(T-1,
    U)). Float64, as the JAX lattice is."""
    logp = torch.log_softmax(logits, dim=-1)
    B, Tmax, U1, _ = logp.shape
    blankp = logp[..., blank].to(torch.float64)                        # (B, T, U+1)
    lab = labels.long()[:, None, :, None].expand(B, Tmax, U1 - 1, 1)
    emitp = torch.gather(logp[:, :, :-1, :], 3, lab)[..., 0].to(torch.float64)  # (B, T, U)
    row = torch.cat([torch.zeros(B, 1, dtype=torch.float64, device=logits.device),
                     torch.cumsum(emitp[:, 0], dim=1)], dim=1)
    rows = [row]
    for t in range(1, Tmax):
        from_top = row + blankp[:, t - 1]
        cells = [from_top[:, 0]]
        for u in range(1, U1):
            cells.append(torch.logaddexp(from_top[:, u], cells[-1] + emitp[:, t, u - 1]))
        row = torch.stack(cells, dim=1)
        rows.append(row)
    alphas = torch.stack(rows, dim=1)                                  # (B, T, U+1)
    b = torch.arange(B, device=logits.device)
    t_last = input_lengths.long() - 1
    u_last = label_lengths.long()
    return -(alphas[b, t_last, u_last] + blankp[b, t_last, u_last])


def rnnt_loss(logits, labels, input_lengths, label_lengths, blank=0, reduction="mean",
              fastemit_lambda=0.0, name=None):
    """RNN-T loss over the (T, U) lattice; ``fastemit_lambda`` is ignored,
    as in JAX."""
    out = _rnnt_inner(logits, labels, input_lengths, label_lengths, blank=blank)
    if reduction == "mean":
        return out.mean()
    if reduction == "sum":
        return out.sum()
    return out


# -- the rest -----------------------------------------------------------------
@defop("bilinear")
def _bilinear_op(x1, x2, weight, bias=None):
    out = torch.einsum("ni,oij,nj->no", x1, weight, x2)
    if bias is not None:
        out = out + bias
    return out


def bilinear(x1, x2, weight, bias=None, name=None):
    """out[:, k] = x1 W[k] x2^T (+ b), W of shape (out, in1, in2)."""
    return _bilinear_op(x1, x2, weight, bias)


def class_center_sample(label, num_classes, num_samples, group=None, name=None):
    """PartialFC sampling: every positive class, then random negatives up to
    ``num_samples``; returns the labels remapped into the sampled index space
    and the sampled class ids (never dropping a positive, so the set may
    exceed ``num_samples``)."""
    lab = _host_array(label)
    pos = np.unique(lab)
    if len(pos) >= num_samples:
        sampled = pos
    else:
        rest = np.setdiff1d(np.arange(num_classes), pos, assume_unique=True)
        perm = torch.randperm(len(rest), generator=_gen(torch.device("cpu"))).numpy()
        sampled = np.concatenate([pos, rest[perm[:num_samples - len(pos)]]])
    remap = {int(c): i for i, c in enumerate(sampled)}
    remapped = np.asarray([remap.get(int(c), -1) for c in lab.ravel()],
                          np.int64).reshape(lab.shape)
    dev = label.device if isinstance(label, torch.Tensor) else torch.device("cpu")
    return (torch.from_numpy(remapped).to(dev),
            torch.from_numpy(sampled.astype(np.int64)).to(dev))


def adaptive_log_softmax_with_loss(input, label, head_weight, tail_weights,  # noqa: A002
                                   cutoffs, head_bias=None, name=None):
    """The functional ``nn.AdaptiveLogSoftmaxWithLoss``: head_weight is (in,
    shortlist + n_clusters), tail_weights (proj (in, h_i), out (h_i,
    size_i)) pairs, cutoffs the ascending cluster bounds without n_classes.
    Returns (target log-prob, mean nll)."""
    from ..layer.extras import _adaptive_full_log_prob

    shortlist = int(head_weight.shape[1]) - len(tail_weights)
    if cutoffs and int(cutoffs[0]) != shortlist:
        raise ValueError(
            f"cutoffs[0]={cutoffs[0]} inconsistent with head_weight: the "
            f"head covers a shortlist of {shortlist} classes")
    full = _adaptive_full_log_prob(input, head_weight, head_bias, tail_weights, shortlist)
    target_lp = _manip.take_along_axis(full, label.reshape([-1, 1]), axis=1).reshape([-1])
    return target_lp, -target_lp.mean()
