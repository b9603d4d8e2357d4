"""paddle.device of the port (streams, events, memory statistics, the
queries and ``device.cuda``) against the JAX package's on the CPU, where
both are shims: a ``Stream`` and an ``Event`` order nothing and ``query()``
is True. On the card the port's map onto ``torch.cuda`` (checked by
``chip_smoke.py`` phase 17 (d)).

Known differences, held here: on the CPU the port's memory statistics are 0
(the JAX package sums the live jax arrays), and ``device.cuda.device_count``
is 0 (the JAX shim counts its CPU device).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as T
from paddle_tpu_torch.device import _CURRENT

PACKAGES = [pytest.param(paddle, id="jax"), pytest.param(T, id="torch")]


@pytest.fixture(autouse=True)
def _on_cpu():
    before = _CURRENT[0]
    T.set_device("cpu")
    yield
    _CURRENT[0] = before


def _public(mod):
    return {n for n in dir(mod) if not n.startswith("_")} - {
        "annotations", "jax", "np", "torch", "contextlib", "gc"}


def test_every_jax_name_exists():
    for jmod, tmod in ((paddle.device, T.device), (paddle.device.cuda, T.device.cuda)):
        missing = _public(jmod) - _public(tmod)
        assert not missing, missing


def test_queries_equal_jax_on_the_cpu():
    for name in ("get_all_device_type", "cuda_device_count", "is_compiled_with_xpu",
                 "is_compiled_with_ipu", "is_compiled_with_cinn", "is_compiled_with_rocm",
                 "get_available_custom_device", "get_cudnn_version"):
        assert getattr(T.device, name)() == getattr(paddle.device, name)(), name
    # the JAX package lists and counts every CPU device the tests' XLA flags
    # make; the port has the one CPU
    assert T.device.get_available_device() == paddle.device.get_available_device()[:1]
    assert T.device.device_count() == 1
    assert T.device.is_compiled_with_distribute() is True
    assert T.device.is_compiled_with_custom_device("gpu") is False
    assert T.device.get_all_custom_device_type() == []  # the JAX package's TPU is one
    assert T.device.is_compiled_with_cuda() == (torch.version.cuda is not None)
    jc, tc = paddle.device.cuda, T.device.cuda
    assert tc.get_device_name() == jc.get_device_name() == "cpu"
    assert tc.get_device_capability() == jc.get_device_capability() == (0, 0)
    jp, tp = jc.get_device_properties(), tc.get_device_properties()
    for attr in ("name", "major", "minor", "multi_processor_count"):
        assert getattr(tp, attr) == getattr(jp, attr), attr
    for dev in (3, "gpu:2", "cpu"):
        assert tc.extract_cuda_device_id(dev) == jc.extract_cuda_device_id(dev)
    assert tc.device_count() == 0 and jc.device_count() >= 1  # the known difference
    assert repr(T.device.XPUPlace(1)) == repr(paddle.device.XPUPlace(1))
    assert repr(T.device.IPUPlace()) == repr(paddle.device.IPUPlace())


@pytest.mark.parametrize("P", PACKAGES)
def test_stream_and_event_shims(P):
    d = P.device
    s = d.Stream()
    e = d.Event(enable_timing=True)
    assert s.query() and e.query()
    assert s.record_event(e) is e
    e.record()
    e.synchronize()
    s.wait_event(e)
    s.wait_stream(d.current_stream())
    s.synchronize()
    assert isinstance(s.record_event(), d.Event)
    assert d.set_stream(s) is not None
    with d.stream_guard(s):
        x = P.to_tensor(np.arange(4.0, dtype=np.float32), place="cpu")
        y = P.multiply(x, x)
    d.synchronize()
    np.testing.assert_array_equal(np.asarray(y.numpy()), np.arange(4.0) ** 2)
    for c in (d.cuda.Stream(), d.cuda.current_stream()):
        assert c.query()
    d.cuda.synchronize()


def test_cpu_streams_compare_equal():
    assert T.device.current_stream() == T.device.current_stream()
    assert T.device.Stream().cuda_stream is None


def test_memory_statistics_on_the_cpu():
    d = T.device
    for fn in (d.memory_allocated, d.max_memory_allocated, d.memory_reserved,
               d.max_memory_reserved, d.cuda.memory_allocated, d.cuda.max_memory_reserved):
        assert fn() == 0 and fn("cpu") == 0
    assert d.memory_stats() == {} == paddle.device.memory_stats()
    d.cuda.reset_max_memory_allocated()
    d.cuda.reset_max_memory_reserved()
    d.empty_cache()
    paddle.device.empty_cache()
    for name in ("memory_allocated", "max_memory_allocated", "memory_reserved",
                 "max_memory_reserved"):
        assert isinstance(getattr(paddle.device, name)(), int)


def test_set_device_still_selects():
    assert T.device.get_device() == "cpu"
    with pytest.raises(ValueError):
        T.device.set_device("tpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            T.device.set_device("gpu:0")
