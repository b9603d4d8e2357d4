"""paddle_tpu_torch.io — datasets, samplers, DataLoader: the port of
``paddle_tpu/io``.

Reference analog: python/paddle/io (Dataset/DataLoader with multiprocess
workers, shared memory and the C++ buffered_reader's double-buffering to the
device). Forked workers collate host batches and hand them over through a
native shared-memory ring (``native_shm.py``); a producer thread stages the
next batch onto the card (pinned memory, a copy stream and an event) while
the current step runs (``dataloader.py``).
"""
from .dataset import (  # noqa: F401
    ChainDataset, ComposeDataset, ConcatDataset, Dataset, IterableDataset, Subset,
    TensorDataset, random_split,
)
from .sampler import (  # noqa: F401
    BatchSampler, DistributedBatchSampler, RandomSampler, Sampler, SequenceSampler,
    SubsetRandomSampler, WeightedRandomSampler,
)
from .dataloader import (CursorLoader, DataLoader,  # noqa: F401
                         default_collate_fn, get_worker_info)
