"""Datasets: the port of ``paddle_tpu/io/dataset.py`` (reference:
python/paddle/io/dataloader/dataset.py).

Host-side Python, as in the JAX package: a dataset returns numpy arrays,
Python numbers or torch tensors, and the ``DataLoader`` stages the batch onto
the device. ``TensorDataset`` indexes torch tensors (or numpy arrays) along
their first axis. ``random_split`` draws its permutation from numpy's global
stream, as the JAX function does, so ``np.random.seed(s)`` gives both
packages the same split.
"""
from __future__ import annotations

import bisect

import numpy as np


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset does not support indexing")

    def __len__(self):
        raise RuntimeError("IterableDataset has no len()")


class TensorDataset(Dataset):
    """Rows of equally long torch tensors (or numpy arrays): item ``i`` is
    ``tuple(t[i] for t in tensors)``."""

    def __init__(self, tensors):
        self.tensors = tensors
        n = tensors[0].shape[0]
        assert all(t.shape[0] == n for t in tensors), "size mismatch between tensors"

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return self.tensors[0].shape[0]


class ComposeDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)
        n = len(self.datasets[0])
        assert all(len(d) == n for d in self.datasets)

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            item = d[idx]
            out.extend(item if isinstance(item, (tuple, list)) else [item])
        return tuple(out)

    def __len__(self):
        return len(self.datasets[0])


class ConcatDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.cumulative_sizes = np.cumsum([len(d) for d in self.datasets]).tolist()

    def __getitem__(self, idx):
        if idx < 0:
            idx += len(self)
        ds_idx = bisect.bisect_right(self.cumulative_sizes, idx)
        base = 0 if ds_idx == 0 else self.cumulative_sizes[ds_idx - 1]
        return self.datasets[ds_idx][idx - base]

    def __len__(self):
        return self.cumulative_sizes[-1]


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __iter__(self):
        for d in self.datasets:
            yield from d


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    total = len(dataset)
    lengths = list(lengths)
    if all(isinstance(l, float) and 0 <= l <= 1 for l in lengths):
        counts = [int(np.floor(total * l)) for l in lengths]
        rem = total - sum(counts)
        for i in range(rem):
            counts[i % len(counts)] += 1
        lengths = counts
    assert sum(lengths) == total, "lengths must sum to dataset size"
    perm = np.random.permutation(total)
    out, off = [], 0
    for n in lengths:
        out.append(Subset(dataset, perm[off : off + n].tolist()))
        off += n
    return out
