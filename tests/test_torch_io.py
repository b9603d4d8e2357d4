"""The port's io (paddle_tpu_torch/io: datasets, samplers, the DataLoader with
its forked workers and native shared-memory ring, CursorLoader) and the
legacy reader combinators (paddle_tpu_torch/reader.py) against the JAX
package's.

Inputs are numpy from a seed; the port stages onto the CPU here (the tests
call ``set_device("cpu")``). Batches, orders and values are compared bit for
bit: the loader moves data and computes nothing. The shuffling samplers draw
from numpy's global stream in both packages (their ``generator`` is ignored),
so one ``np.random.seed`` gives both the same order. A CUDA tensor is faked
with a patched ``Tensor.is_cuda`` where the worker's rule for it is tested.
"""
import random

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.io as jio
import paddle_tpu.reader as jreader
import paddle_tpu_torch as T
import paddle_tpu_torch.io as tio
import paddle_tpu_torch.reader as treader
from paddle_tpu.analysis import faultinject as jfi
from paddle_tpu_torch.analysis import faultinject as tfi
from paddle_tpu_torch.io import native_shm
from paddle_tpu_torch.io.dataloader import default_collate_fn
from paddle_tpu_torch.io.worker import MultiprocessBatchLoader
from test_torch_ops import _np, _on_cpu  # noqa: F401


def _tree(x):
    """A batch as nested lists of numpy arrays (either package's tensors)."""
    if isinstance(x, dict):
        return {k: _tree(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_tree(v) for v in x]
    if isinstance(x, (str, bytes)):
        return x
    return _np(x)


def _same(a, b):
    a, b = _tree(a), _tree(b)
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def _drain(loader):
    return list(loader)


class SimpleDs:
    def __init__(self, n=32):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return np.full((4,), float(i), "float32"), np.int64(i)


class MixedDs:
    def __len__(self):
        return 6

    def __getitem__(self, i):
        return {"x": np.full((3, 2), i, "float32"), "meta": {"idx": np.int64(i)},
                "name": f"s{i}", "w": 0.5 * i}


def _pair(make, *args, **kw):
    """The same construction in both packages (``make`` names the class)."""
    return getattr(jio, make)(*args, **kw), getattr(tio, make)(*args, **kw)


# -- datasets ------------------------------------------------------------------
class TestDatasets:
    def test_tensor_dataset_torch_and_numpy(self):
        rng = np.random.RandomState(0)
        a, b = rng.randn(6, 3).astype("float32"), rng.randint(0, 9, (6,))
        jd = jio.TensorDataset([paddle.to_tensor(a), paddle.to_tensor(b)])
        td = tio.TensorDataset([torch.from_numpy(a), torch.from_numpy(b)])
        assert len(jd) == len(td) == 6
        for i in (0, 3, 5):
            _same(jd[i], td[i])
        assert isinstance(td[2][0], torch.Tensor)
        with pytest.raises(AssertionError):
            tio.TensorDataset([torch.zeros(3), torch.zeros(4)])

    def test_compose_concat_subset_chain(self):
        s1, s2 = SimpleDs(5), SimpleDs(3)
        for name, args in (("ComposeDataset", ([s1, SimpleDs(5)],)),
                           ("ConcatDataset", ([s1, s2],))):
            jd, td = _pair(name, *args)
            assert len(jd) == len(td)
            for i in list(range(len(td))) + ([-1, -4] if name == "ConcatDataset" else []):
                _same(jd[i], td[i])
        jd, td = _pair("Subset", s1, [4, 0, 2])
        assert [td[i][1] for i in range(3)] == [jd[i][1] for i in range(3)] == [4, 0, 2]

        class It(tio.IterableDataset):
            def __init__(self, n):
                self.n = n

            def __iter__(self):
                return iter(range(self.n))

        # list() would ask for a length hint, which an IterableDataset refuses
        assert [x for x in tio.ChainDataset([It(2), It(3)])] == [0, 1, 0, 1, 2]
        with pytest.raises(RuntimeError):
            It(2)[0]
        with pytest.raises(RuntimeError):
            len(It(2))

    @pytest.mark.parametrize("lengths", [[4, 3, 3], [0.5, 0.3, 0.2], [0.34, 0.33, 0.33]])
    def test_random_split_draws_numpy(self, lengths):
        ds = SimpleDs(10)
        np.random.seed(5)
        j = jio.random_split(ds, lengths)
        np.random.seed(5)
        t = tio.random_split(ds, lengths)
        assert [s.indices for s in t] == [s.indices for s in j]


# -- samplers -------------------------------------------------------------------
def _seeded(fn, seed=7):
    np.random.seed(seed)
    return fn()


SAMPLERS = {
    "sequence": lambda io: list(io.SequenceSampler(SimpleDs(7))),
    "random": lambda io: list(io.RandomSampler(SimpleDs(9))),
    "random_generator_ignored": lambda io: list(io.RandomSampler(SimpleDs(9),
                                                                 generator=object())),
    "random_replacement": lambda io: list(io.RandomSampler(SimpleDs(9), replacement=True,
                                                           num_samples=20)),
    "random_num_samples": lambda io: list(io.RandomSampler(SimpleDs(9), num_samples=4)),
    "subset_random": lambda io: list(io.SubsetRandomSampler([3, 8, 1, 5])),
    "weighted": lambda io: list(io.WeightedRandomSampler([0.1, 2.0, 0.5, 1.0], 12)),
    "weighted_no_replacement": lambda io: list(io.WeightedRandomSampler(
        [0.1, 2.0, 0.5, 1.0], 3, replacement=False)),
    "batch": lambda io: list(io.BatchSampler(SimpleDs(10), batch_size=3)),
    "batch_shuffle_drop_last": lambda io: list(io.BatchSampler(
        SimpleDs(10), shuffle=True, batch_size=3, drop_last=True)),
    "batch_over_sampler": lambda io: list(io.BatchSampler(
        sampler=io.RandomSampler(SimpleDs(8)), batch_size=3)),
    "distributed": lambda io: [list(io.DistributedBatchSampler(
        SimpleDs(11), 2, num_replicas=3, rank=r)) for r in range(3)],
    "distributed_shuffle_epochs": lambda io: _epochs(io),
    "distributed_default_world": lambda io: list(io.DistributedBatchSampler(
        SimpleDs(5), 2, shuffle=True, drop_last=True)),
}


def _epochs(io):
    s = io.DistributedBatchSampler(SimpleDs(13), 2, num_replicas=2, rank=1, shuffle=True)
    out = []
    for e in range(3):
        s.set_epoch(e)
        out.append((list(s), len(s)))
    return out


@pytest.mark.parametrize("name", sorted(SAMPLERS))
def test_sampler_order_equals_jax(name):
    fn = SAMPLERS[name]
    assert _seeded(lambda: fn(tio)) == _seeded(lambda: fn(jio))


def test_sampler_lengths_equal_jax():
    for kw in (dict(batch_size=3), dict(batch_size=3, drop_last=True)):
        assert len(tio.BatchSampler(SimpleDs(10), **kw)) == len(jio.BatchSampler(SimpleDs(10),
                                                                                 **kw))
    d = dict(num_replicas=3, rank=2)
    assert len(tio.DistributedBatchSampler(SimpleDs(11), 2, **d)) == \
        len(jio.DistributedBatchSampler(SimpleDs(11), 2, **d))


# -- the loader in one process --------------------------------------------------
class It(tio.IterableDataset):
    def __iter__(self):
        return iter(np.full((2,), i, "float32") for i in range(7))


class JIt(jio.IterableDataset):
    def __iter__(self):
        return iter(np.full((2,), i, "float32") for i in range(7))


LOADERS = {
    "plain": (lambda: SimpleDs(10), dict(batch_size=4)),
    "drop_last": (lambda: SimpleDs(10), dict(batch_size=4, drop_last=True)),
    "shuffle": (lambda: SimpleDs(17), dict(batch_size=4, shuffle=True)),
    "unbuffered": (lambda: SimpleDs(10), dict(batch_size=3, use_buffer_reader=False)),
    "mixed_types": (MixedDs, dict(batch_size=4)),
    "batch_size_none": (lambda: SimpleDs(3), dict(batch_size=None)),
    "threads": (lambda: SimpleDs(17), dict(batch_size=4, shuffle=True, num_workers=3,
                                           use_shared_memory=False)),
    "collate_fn": (lambda: SimpleDs(8), dict(batch_size=4, collate_fn=lambda b: np.stack(
        [x for x, _ in b]) * 2)),
}


@pytest.mark.parametrize("name", sorted(LOADERS))
def test_loader_batches_equal_jax(name):
    make, kw = LOADERS[name]
    np.random.seed(3)
    j = _drain(jio.DataLoader(make(), **kw))
    np.random.seed(3)
    t = _drain(tio.DataLoader(make(), **kw))
    assert len(t) == len(j)
    for a, b in zip(t, j):
        _same(a, b)
    leaves = [x for b in t for x in (b.values() if isinstance(b, dict) else
                                     b if isinstance(b, list) else [b])]
    assert any(isinstance(x, torch.Tensor) and x.device.type == "cpu" for x in leaves)


def test_iterable_dataset_batches_equal_jax():
    for kw in (dict(batch_size=3), dict(batch_size=3, drop_last=True)):
        j = _drain(jio.DataLoader(JIt(), **kw))
        t = _drain(tio.DataLoader(It(), **kw))
        assert len(t) == len(j)
        for a, b in zip(t, j):
            _same(a, b)
    with pytest.raises(TypeError):
        len(tio.DataLoader(It(), batch_size=2))


def test_places_and_device_choose_the_cpu():
    for kw in (dict(places=T.CPUPlace()), dict(places=["cpu"]), dict(device="cpu")):
        (x, _), = _drain(tio.DataLoader(SimpleDs(2), batch_size=2, **kw))
        assert x.device.type == "cpu"


def test_default_collate_stacks_torch_tensors():
    out = default_collate_fn([(torch.ones(2), 1), (torch.zeros(2), 2)])
    assert isinstance(out[0], torch.Tensor) and out[0].shape == (2, 2)
    np.testing.assert_array_equal(out[1], np.array([1, 2], np.int64))


# -- forked workers (the JAX package's tests/test_mp_dataloader.py cases) -------
class FailingDs:
    def __len__(self):
        return 8

    def __getitem__(self, i):
        if i == 5:
            raise ValueError("boom at index 5")
        return np.zeros(2, "float32")


class TorchCpuDs:
    """CPU torch tensors in the sample: host data, through the workers."""

    def __len__(self):
        return 12

    def __getitem__(self, i):
        g = torch.Generator().manual_seed(i)
        return torch.randn(3, 2, generator=g), torch.tensor(i)


@pytest.fixture
def fake_cuda(monkeypatch):
    """Every tensor reads as a CUDA tensor (inherited by forked workers)."""
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))


class TestWorkers:
    def test_order_and_values_match_sequential_and_jax(self):
        ds = SimpleDs(32)
        seq = _drain(tio.DataLoader(ds, batch_size=4, num_workers=0, use_buffer_reader=False))
        mp = _drain(tio.DataLoader(ds, batch_size=4, num_workers=3, use_buffer_reader=False))
        jax = _drain(jio.DataLoader(ds, batch_size=4, num_workers=3, use_buffer_reader=False))
        assert len(seq) == len(mp) == len(jax) == 8
        for a, b, c in zip(seq, mp, jax):
            _same(a, b)
            _same(b, c)

    def test_worker_error_propagates(self):
        loader = tio.DataLoader(FailingDs(), batch_size=2, num_workers=2,
                                use_buffer_reader=False)
        with pytest.raises(RuntimeError, match="boom at index 5"):
            _drain(loader)

    def test_worker_init_fn_and_info(self):
        class InfoDs:
            def __len__(self):
                return 4

            def __getitem__(self, i):
                info = tio.get_worker_info()
                return np.asarray([i, -1 if info is None else info.id], "int64")

        seen = []
        loader = tio.DataLoader(InfoDs(), batch_size=1, num_workers=2,
                                use_buffer_reader=False, worker_init_fn=seen.append)
        rows = np.concatenate([_np(b) for b in _drain(loader)])
        assert set(rows[:, 1].tolist()) <= {0, 1}
        assert tio.get_worker_info() is None and seen == []   # init ran in the workers

    def test_shared_memory_roundtrip_types(self):
        for kw in (dict(), dict(use_buffer_reader=False)):
            batches = _drain(tio.DataLoader(MixedDs(), batch_size=3, num_workers=2, **kw))
            ref = _drain(jio.DataLoader(MixedDs(), batch_size=3, num_workers=2, **kw))
            assert len(batches) == 2
            assert list(batches[0]["x"].shape) == [3, 3, 2]
            assert batches[0]["name"] == ["s0", "s1", "s2"]
            for a, b in zip(batches, ref):
                _same(a, b)

    def test_cpu_torch_tensor_sample_through_workers(self):
        ds = TorchCpuDs()
        seq = _drain(tio.DataLoader(ds, batch_size=4, num_workers=0))
        loader = tio.DataLoader(ds, batch_size=4, num_workers=2)
        assert loader._use_subprocess_workers()
        mp = _drain(loader)
        for a, b in zip(seq, mp):
            assert isinstance(b[0], torch.Tensor) and b[0].dtype == torch.float32
            _same(a, b)
        assert sum(loader.transport_stats()[k] for k in ("ring", "shm")) == 3

    def test_persistent_workers_reused_across_epochs(self):
        loader = tio.DataLoader(SimpleDs(16), batch_size=4, num_workers=2,
                                use_buffer_reader=False, persistent_workers=True)
        e1 = _drain(loader)
        pool = loader._persistent_pool
        assert pool is not None and not pool._closed
        e2 = _drain(loader)
        assert loader._persistent_pool is pool
        assert len(e1) == len(e2) == 4
        pool.shutdown()

    def test_probe_does_not_consume_sampler(self):
        """A seeded shuffle gives one order for 0 and N workers, and the JAX
        loader's."""
        orders = []
        for io, n in ((tio, 0), (tio, 2), (jio, 2)):
            np.random.seed(123)
            orders.append([_np(b[1]).tolist() for b in io.DataLoader(
                SimpleDs(32), batch_size=4, shuffle=True, num_workers=n,
                use_buffer_reader=False)])
        assert orders[0] == orders[1] == orders[2]

    def test_cuda_sample_sends_the_loader_to_threads(self, fake_cuda):
        class TensorDs:
            def __len__(self):
                return 8

            def __getitem__(self, i):
                return torch.full((2,), float(i))

        loader = tio.DataLoader(TensorDs(), batch_size=2, num_workers=2,
                                use_buffer_reader=False)
        assert not loader._use_subprocess_workers()

    def test_late_cuda_tensor_in_worker_raises_clearly(self, fake_cuda):
        class LateTensorDs:
            def __len__(self):
                return 8

            def __getitem__(self, i):
                if i >= 4:  # the probe sees numpy; workers later meet tensors
                    return torch.zeros(2)
                return np.zeros(2, "float32")

        loader = tio.DataLoader(LateTensorDs(), batch_size=2, num_workers=2,
                                use_buffer_reader=False)
        with pytest.raises(RuntimeError, match="must not touch CUDA"):
            _drain(loader)

    def test_collate_fn_producing_cuda_tensors_raises(self, fake_cuda):
        loader = tio.DataLoader(
            SimpleDs(8), batch_size=2, num_workers=2, use_buffer_reader=False,
            collate_fn=lambda b: torch.from_numpy(np.stack([x for x, _ in b])))
        with pytest.raises(RuntimeError, match="must not touch CUDA"):
            _drain(loader)

    def test_early_break_shuts_down_pool(self):
        loader = tio.DataLoader(SimpleDs(32), batch_size=2, num_workers=2,
                                use_buffer_reader=False)
        for _ in loader:
            break
        assert loader._last_pool._closed

    def test_concurrent_epochs_on_persistent_pool_rejected(self):
        loader = tio.DataLoader(SimpleDs(16), batch_size=2, num_workers=2,
                                use_buffer_reader=False, persistent_workers=True)
        it1 = iter(loader)
        next(it1)
        it2 = iter(loader)
        with pytest.raises(RuntimeError, match="still active"):
            next(it2)
        it1.close()
        loader._persistent_pool and loader._persistent_pool.shutdown()

    def test_probe_decision_cached(self):
        calls = []

        class CountingDs:
            def __len__(self):
                return 8

            def __getitem__(self, i):
                calls.append(i)
                return np.zeros(2, "float32")

        loader = tio.DataLoader(CountingDs(), batch_size=2, num_workers=2,
                                use_buffer_reader=False)
        _drain(loader)
        probes = calls.count(0)
        _drain(loader)
        assert calls.count(0) == probes


class TestNativeRing:
    def test_ring_builds_into_the_port(self):
        if not native_shm.available():
            pytest.skip("no C++ compiler here; the segment fallback is covered below")
        assert native_shm._SO.startswith(str(native_shm._BUILD_DIR))
        assert "paddle_tpu_torch" in native_shm._SRC and "_build" in native_shm._BUILD_DIR

    def test_native_ring_available_and_used(self):
        if not native_shm.available():
            pytest.skip("no C++ compiler here; the segment fallback is covered below")
        pool = MultiprocessBatchLoader(SimpleDs(16), default_collate_fn, num_workers=2)
        assert len(pool._rings) == 2
        out = list(pool.epoch(iter([[0, 1], [2, 3], [4, 5], [6, 7]])))
        assert len(out) == 4
        np.testing.assert_array_equal(out[0][0], [[0.0] * 4, [1.0] * 4])
        assert pool.stats["ring"] == 4 and pool.stats["shm"] == 0
        assert pool.stats["ring_bytes"] > 4 * 2 * 4 * 4
        pool.shutdown()

    def test_oversized_batch_falls_back_to_segments(self):
        class BigDs:
            def __len__(self):
                return 4

            def __getitem__(self, i):
                return np.full((1 << 18,), float(i), "float32")  # 1 MB each

        pool = MultiprocessBatchLoader(BigDs(), default_collate_fn, num_workers=1,
                                       ring_capacity=1 << 20)
        out = list(pool.epoch(iter([[0, 1], [2, 3]])))
        assert len(out) == 2
        np.testing.assert_array_equal(out[1][:, 0], [2.0, 3.0])
        assert pool.stats["shm"] == 2 and pool.stats["ring"] == 0
        pool.shutdown()


# -- CursorLoader -------------------------------------------------------------------
class SeqDs:
    def __len__(self):
        return 8

    def __getitem__(self, i):
        r = np.random.RandomState(i)
        return r.randn(4).astype("float32"), r.randn(2).astype("float32")


class TestCursorLoader:
    def _loaders(self, **kw):
        return (jio.CursorLoader(jio.DataLoader(SeqDs(), batch_size=2, **kw)),
                tio.CursorLoader(tio.DataLoader(SeqDs(), batch_size=2, **kw)))

    def test_cursor_round_trip_across_epochs(self):
        jl, tl = self._loaders()
        for _ in range(6):                    # 4 per epoch: into epoch 2
            _same(next(jl), next(tl))
        st = tl.state_dict()
        assert st == jl.state_dict() == {"cursor": 6, "epoch": 1}
        nxt = next(tl)
        _, tl2 = self._loaders()
        tl2.set_state_dict(st)
        assert tl2.cursor == 6
        _same(next(tl2), nxt)

    def test_shuffled_resume_under_one_numpy_seed(self):
        np.random.seed(9)
        _, tl = self._loaders(shuffle=True, num_workers=2)
        ref = [next(tl) for _ in range(7)]
        np.random.seed(9)
        _, tl2 = self._loaders(shuffle=True, num_workers=2)
        tl2.set_state_dict({"cursor": 3})
        for want in ref[3:]:
            _same(next(tl2), want)

    def test_data_next_fault_point(self):
        assert tfi.POINTS["data.next"] == jfi.POINTS["data.next"]
        jl, tl = self._loaders()
        try:
            for cl, fi in ((jl, jfi), (tl, tfi)):
                next(cl)
                fi.arm("data.next", action="raise", nth=1)
                with pytest.raises(Exception, match="injected fault"):
                    next(cl)
                assert ("data.next", "raise") in fi.trips()
                assert cl.cursor == 1             # the failed fetch moved nothing
        finally:
            jfi.reset()
            tfi.reset()


# -- telemetry -----------------------------------------------------------------------
@pytest.mark.parametrize("kw", [dict(), dict(use_buffer_reader=False),
                                dict(num_workers=2)], ids=["buffered", "unbuffered", "workers"])
def test_monitor_metrics_and_spans_equal_jax(kw):
    import paddle_tpu.monitor as jmon
    import paddle_tpu_torch.monitor as tmon

    got = []
    for mon, io in ((jmon, jio), (tmon, tio)):
        mon.reset()
        mon.trace.reset()
        mon.enable()
        mon.trace.enable()
        try:
            n = len(_drain(io.DataLoader(SimpleDs(12), batch_size=4, **kw)))
            c = mon.registry.get("paddle_tpu_dataloader_batches_total")
            h = mon.registry.get("paddle_tpu_dataloader_fetch_latency_ns")
            spans = [s for s in mon.trace.spans() if s.name == "dataloader.batch"]
            got.append((n, c.value, h.count, len(spans),
                        all(s.t1_ns >= s.t0_ns for s in spans)))
        finally:
            mon.disable()
            mon.trace.disable()
            mon.reset()
            mon.trace.reset()
    assert got[0] == got[1] == (3, 3, 3, 3, True)


def test_profiler_timer_reader_hooks():
    from paddle_tpu_torch.profiler.timer import benchmark

    bm = benchmark()
    bm.begin()
    timed = []
    record = bm.current_event.record_reader
    bm.current_event.record_reader = lambda s: (timed.append(s), record(s))
    try:
        for _ in tio.DataLoader(SimpleDs(8), batch_size=2):
            bm.step(2)
        assert len(timed) == 4 and all(s >= 0 for s in timed)
        assert bm._recording_reader is None          # released at the epoch's end
    finally:
        bm.end()


# -- the legacy reader combinators (tests/test_misc_kits.py on both) ---------------
def r1():
    return iter(range(5))


def r2():
    return iter(range(10, 15))


READERS = {
    "compose": lambda R: list(R.compose(r1, r2)()),
    "compose_tuples": lambda R: list(R.compose(R.compose(r1, r2), r1)()),
    "firstn": lambda R: list(R.firstn(r1, 3)()),
    "chain": lambda R: list(R.chain(r1, r1)()),
    "map_readers": lambda R: list(R.map_readers(lambda a, b: a + b, r1, r2)()),
    "shuffle": lambda R: (random.seed(4), list(R.shuffle(r1, 3)()))[1],
    "buffered": lambda R: list(R.buffered(r1, 2)()),
    "cache": lambda R: (lambda c: [list(c()), list(c())])(R.cache(r1)),
    "xmap_ordered": lambda R: list(R.xmap_readers(lambda x: x * 2, r1, 2, 4, order=True)()),
    "xmap_unordered": lambda R: sorted(R.xmap_readers(lambda x: x * 2, r1, 2, 4)()),
    "multiprocess_reader": lambda R: sorted(R.multiprocess_reader([r1, r2])()),
    "batch": lambda R: list((T if R is treader else paddle).batch(r1, 2)()),
}


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_combinator_equals_jax(name):
    assert READERS[name](treader) == READERS[name](jreader)


def test_reader_cache_reads_once_and_compose_checks_alignment():
    calls = []

    def once():
        calls.append(1)
        return iter(range(3))

    cached = treader.cache(once)
    assert list(cached()) == [0, 1, 2] and list(cached()) == [0, 1, 2]
    assert len(calls) == 1
    with pytest.raises(treader.ComposeNotAligned):
        list(treader.compose(r1, lambda: iter(range(3)))())
    assert list(treader.compose(r1, lambda: iter(range(3)), check_alignment=False)())[-1] \
        == (4, None)
