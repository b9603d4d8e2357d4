"""ASP: automatic structured (n:m) sparsity, the port of
``paddle_tpu/incubate/asp.py``.

Reference analog: python/paddle/incubate/asp/ (utils.py mask algorithms
get_mask_1d :192 / get_mask_2d_greedy :334, asp.py prune_model/decorate —
masks computed once, then re-applied after every optimizer step so pruned
weights stay zero through training).

The mask algorithms are the JAX package's numpy (a one-off host pass over
each weight, read once from the device). ``prune_model`` multiplies each
prunable parameter by its mask in place, on the parameter's device and in its
dtype; ``decorate`` wraps ``optimizer.step`` so that every step ends with the
same in-place multiply, so pruned weights stay exactly zero.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch

_EXCLUDED = set()  # parameter names excluded from pruning
_MASKS = {}        # param name -> numpy mask


def calculate_density(x):
    """Fraction of nonzeros (utils.py:86)."""
    x = np.asarray(x)
    return float(np.count_nonzero(x)) / x.size


def _reshape_1d(mat, m):
    pad = (m - mat.shape[1] % m) % m
    padded = np.concatenate(
        [mat, np.zeros((mat.shape[0], pad), mat.dtype)], axis=1)
    return padded.reshape(-1, m), padded.shape


def get_mask_1d(mat, n, m):
    """Keep the n largest-|.| of every m consecutive values (utils.py:192)."""
    mat = np.asarray(mat)
    groups, padded_shape = _reshape_1d(mat, m)
    mask = np.zeros_like(groups, dtype=bool)
    order = np.argsort(np.abs(groups), axis=1)[:, m - n:]
    np.put_along_axis(mask, order, True, axis=1)
    mask = mask.reshape(padded_shape)[:, :mat.shape[1]]
    return mask.astype(mat.dtype)


def check_mask_1d(mat, n, m):
    """Every m-block has at most n nonzeros (utils.py:142)."""
    mat = np.asarray(mat)
    groups, _ = _reshape_1d(mat, m)
    return bool(np.all(np.count_nonzero(groups, axis=1) <= n))


def _valid_2d_patterns(n, m):
    # all mxm 0/1 matrices with n ones per row AND n ones per column
    rows = [p for p in itertools.product([0, 1], repeat=m) if sum(p) == n]
    pats = []
    for combo in itertools.product(rows, repeat=m):
        a = np.array(combo)
        if np.all(a.sum(axis=0) == n):
            pats.append(a)
    return np.stack(pats)


def get_mask_2d_best(mat, n, m):
    """Best mxm block pattern with n:m rows AND columns (utils.py:452)."""
    mat = np.asarray(mat)
    patterns = _valid_2d_patterns(n, m)
    pr = (m - mat.shape[0] % m) % m
    pc = (m - mat.shape[1] % m) % m
    padded = np.pad(np.abs(mat), ((0, pr), (0, pc)))
    R, C = padded.shape
    blocks = padded.reshape(R // m, m, C // m, m).transpose(0, 2, 1, 3)
    scores = np.einsum("rcij,pij->rcp", blocks, patterns)
    best = np.argmax(scores, axis=-1)
    mask_blocks = patterns[best]  # (R/m, C/m, m, m)
    mask = mask_blocks.transpose(0, 2, 1, 3).reshape(R, C)
    return mask[:mat.shape[0], :mat.shape[1]].astype(mat.dtype)


get_mask_2d_greedy = get_mask_2d_best  # greedy variant served by best search


def check_mask_2d(mat, n, m):
    mat = np.asarray(mat)
    pr = (m - mat.shape[0] % m) % m
    pc = (m - mat.shape[1] % m) % m
    padded = np.pad(mat, ((0, pr), (0, pc)))
    R, C = padded.shape
    blocks = padded.reshape(R // m, m, C // m, m).transpose(0, 2, 1, 3)
    nz = np.count_nonzero(blocks, axis=-1)       # rows
    nzc = np.count_nonzero(blocks, axis=-2)      # cols
    return bool(np.all(nz <= n) and np.all(nzc <= n))


def create_mask(tensor, func_name="mask_1d", n=2, m=4):
    """(utils.py:508) — mask for an arbitrary-rank weight (collapsed to 2-D)."""
    arr = np.asarray(tensor)
    shape = arr.shape
    mat = arr.reshape(shape[0], -1) if arr.ndim != 2 else arr
    if func_name in ("mask_1d", "MaskAlgo.MASK_1D"):
        mask = get_mask_1d(mat, n, m)
    else:
        mask = get_mask_2d_best(mat, n, m)
    return mask.reshape(shape)


def check_sparsity(tensor, func_name="check_1d", n=2, m=4):
    arr = np.asarray(tensor)
    mat = arr.reshape(arr.shape[0], -1) if arr.ndim != 2 else arr
    if "1d" in str(func_name):
        return check_mask_1d(mat, n, m)
    return check_mask_2d(mat, n, m)


# -- model-level API (asp.py) -------------------------------------------------
def set_excluded_layers(layers, main_program=None):
    """Parameter names (or Layers) to skip when pruning (asp.py)."""
    for item in layers:
        if isinstance(item, str):
            _EXCLUDED.add(item)
        else:
            for name, _ in item.named_parameters():
                _EXCLUDED.add(name)


def reset_excluded_layers(main_program=None):
    _EXCLUDED.clear()


def _host(p):
    """The parameter's values as a numpy array (bfloat16 read as float32)."""
    t = p.detach()
    if t.dtype in (torch.bfloat16, torch.float16):
        t = t.float()
    return t.cpu().numpy()


def _on(mask, p):
    """The mask as a tensor in the parameter's dtype, on its device."""
    return torch.from_numpy(np.ascontiguousarray(mask, np.float32)).to(p.device, p.dtype)


def _prunable(name, p):
    # reference prunes supported multiplying weights: >=2-D, not excluded,
    # and the last dim divisible by 4 so 2:4 groups are aligned
    return (name not in _EXCLUDED and len(p.shape) >= 2
            and int(p.shape[-1]) % 4 == 0 and "bias" not in name)


def prune_model(model, n=2, m=4, mask_algo="mask_1d", with_mask=True):
    """Compute + apply n:m masks to every prunable weight (asp.py prune_model).
    Returns {param_name: mask}. Masks are keyed by parameter identity so
    `decorate` finds them regardless of naming."""
    _MASKS.clear()
    out = {}
    for name, p in model.named_parameters():
        if not _prunable(name, p):
            continue
        mask = create_mask(_host(p), func_name=mask_algo, n=n, m=m)
        _MASKS[id(p)] = (mask, _on(mask, p))
        out[name] = mask
        with torch.no_grad():
            p.mul_(_MASKS[id(p)][1])
    return out


def decorate(optimizer):
    """Wrap optimizer.step to re-apply the masks after each update (asp.py
    decorate: the optimizer trains, ASP keeps pruned weights at zero)."""
    inner_step = optimizer.step

    def step():
        inner_step()
        with torch.no_grad():
            for grp in optimizer._param_groups:
                for p in grp["params"]:
                    mask = _MASKS.get(id(p))
                    if mask is not None:
                        p.mul_(mask[1])

    optimizer.step = step
    return optimizer


__all__ = [
    "calculate_density", "get_mask_1d", "get_mask_2d_best",
    "get_mask_2d_greedy", "check_mask_1d", "check_mask_2d", "create_mask",
    "check_sparsity", "set_excluded_layers", "reset_excluded_layers",
    "prune_model", "decorate",
]
