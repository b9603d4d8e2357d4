"""Samplers: the port of ``paddle_tpu/io/sampler.py`` (reference:
python/paddle/io/dataloader/{sampler,batch_sampler}.py).

The draws are the JAX package's: ``RandomSampler`` and
``SubsetRandomSampler`` take their permutation (``replacement``: their
``randint``) and ``WeightedRandomSampler`` its ``choice`` from numpy's global
stream, and ignore ``generator``, so ``np.random.seed(s)`` gives both packages
the same order. ``DistributedBatchSampler`` shuffles with
``RandomState(epoch)``; its ``num_replicas`` and ``rank`` default, in one
process, to a world of 1 and rank 0 (what the JAX package's
``jax.process_count()``/``process_index()`` give there).
"""
from __future__ import annotations

import numpy as np


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        return len(self.data_source)


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))


class RandomSampler(Sampler):
    def __init__(self, data_source, replacement=False, num_samples=None, generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples
        self.generator = generator

    @property
    def num_samples(self):
        return self._num_samples if self._num_samples is not None else len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        if self.replacement:
            return iter(np.random.randint(0, n, self.num_samples).tolist())
        perm = np.random.permutation(n)[: self.num_samples]
        return iter(perm.tolist())

    def __len__(self):
        return self.num_samples


class SubsetRandomSampler(Sampler):
    def __init__(self, indices, generator=None):
        super().__init__(indices)
        self.indices = list(indices)

    def __iter__(self):
        return iter(np.random.permutation(len(self.indices)).tolist())

    def __len__(self):
        return len(self.indices)


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True):
        super().__init__(None)
        self.weights = np.asarray(weights, np.float64)
        self.num_samples = num_samples
        self.replacement = replacement

    def __iter__(self):
        p = self.weights / self.weights.sum()
        idx = np.random.choice(len(self.weights), self.num_samples, replace=self.replacement,
                               p=p)
        return iter(idx.tolist())

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler=None, shuffle=False, batch_size=1,
                 drop_last=False):
        super().__init__(dataset)
        if sampler is not None:
            self.sampler = sampler
        elif shuffle:
            self.sampler = RandomSampler(dataset)
        else:
            self.sampler = SequenceSampler(dataset)
        self.batch_size = batch_size
        self.drop_last = drop_last

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


class DistributedBatchSampler(BatchSampler):
    """Per-rank sharded batches (reference: io/dataloader/batch_sampler.py
    DistributedBatchSampler): the sample stream padded to a multiple of
    ``num_replicas`` and dealt out by rank, so each process feeds its own
    slice."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None, shuffle=False,
                 drop_last=False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        # one process: a world of 1, rank 0 (launching several processes with
        # their ranks is the distributed slice's, ROADMAP Queue A item 10)
        num_replicas = 1 if num_replicas is None else num_replicas
        rank = 0 if rank is None else rank
        self.nranks = num_replicas
        self.local_rank = rank
        self.epoch = 0
        self.num_samples = int(np.ceil(len(dataset) / self.nranks))
        self.total_size = self.num_samples * self.nranks

    def __iter__(self):
        n = len(self.dataset)
        indices = np.arange(n)
        if self.shuffle:
            rng = np.random.RandomState(self.epoch)
            rng.shuffle(indices)
        indices = np.concatenate([indices, indices[: self.total_size - n]])
        local = indices[self.local_rank : self.total_size : self.nranks]
        batch = []
        for idx in local.tolist():
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch):
        self.epoch = epoch
