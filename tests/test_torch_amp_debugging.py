"""The ten cases of tests/test_amp_debugging.py, each run on the JAX package
and on the port with the same inputs, with the same outcome asked of both.
A Python operator on a torch tensor is torch's own and bypasses the port's
dispatch, so where the JAX test writes ``x / y`` both sides here call the
op (``P.divide``)."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as T
from paddle_tpu.amp import debugging as jdbg
from paddle_tpu_torch.amp import debugging as tdbg
from paddle_tpu_torch.device import _CURRENT

PKGS = {"jax": (paddle, jdbg), "port": (T, tdbg)}


@pytest.fixture(autouse=True)
def _clean():
    before = _CURRENT[0]
    T.set_device("cpu")
    yield
    _CURRENT[0] = before
    for dbg in (jdbg, tdbg):
        dbg.disable_tensor_checker()
        dbg._OP_STATS[0] = None


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(
        t.numpy())


@pytest.fixture(params=list(PKGS))
def pkg(request):
    return PKGS[request.param]


class TestNanInfScan:
    def test_injected_nan_reports_op_name(self, pkg):
        P, dbg = pkg
        dbg.enable_tensor_checker(dbg.TensorCheckerConfig(enable=True))
        x = P.to_tensor(np.array([1.0, 0.0], "float32"))
        with pytest.raises(FloatingPointError, match="divide"):
            P.divide(x, P.to_tensor(np.array([0.0, 0.0], "float32")))

    def test_print_mode_does_not_raise(self, pkg, capsys):
        P, dbg = pkg
        dbg.enable_tensor_checker(dbg.TensorCheckerConfig(
            enable=True, debug_mode=dbg.DebugMode.CHECK_NAN_INF))
        x = P.to_tensor(np.array([1.0], "float32"))
        y = P.divide(x, P.to_tensor(np.array([0.0], "float32")))
        assert "nan/inf" in capsys.readouterr().out
        assert np.isinf(_np(y)).any()

    def test_skipped_op_list(self, pkg):
        P, dbg = pkg
        dbg.enable_tensor_checker(dbg.TensorCheckerConfig(enable=True,
                                                          skipped_op_list=["divide"]))
        x = P.to_tensor(np.array([1.0], "float32"))
        y = P.divide(x, P.to_tensor(np.array([0.0], "float32")))  # not scanned
        assert np.isinf(_np(y)).any()

    def test_checked_op_list_restricts(self, pkg):
        P, dbg = pkg
        dbg.enable_tensor_checker(dbg.TensorCheckerConfig(enable=True,
                                                          checked_op_list=["matmul"]))
        x = P.to_tensor(np.array([1.0], "float32"))
        P.divide(x, P.to_tensor(np.array([0.0], "float32")))  # divide unchecked

    def test_disable(self, pkg):
        P, dbg = pkg
        dbg.enable_tensor_checker(dbg.TensorCheckerConfig(enable=True))
        dbg.disable_tensor_checker()
        x = P.to_tensor(np.array([1.0], "float32"))
        y = P.divide(x, P.to_tensor(np.array([0.0], "float32")))
        assert np.isinf(_np(y)).any()


class TestCheckNumerics:
    def test_clean_tensor_stats(self, pkg):
        P, dbg = pkg
        stats = dbg.check_numerics(P.to_tensor(np.array([1.0, -2.0, 0.0], "float32")),
                                   "op", "x")
        assert stats["num_nan"] == 0 and stats["num_zero"] == 1
        assert stats["min"] == -2.0 and stats["max"] == 1.0

    def test_stats_equal_across_packages(self):
        arr = np.array([1.0, np.nan, np.inf, -3.0, 0.0, 0.5], "float32")
        assert tdbg.tensor_stats(T.to_tensor(arr)) == jdbg.tensor_stats(paddle.to_tensor(arr))

    def test_nan_aborts(self, pkg):
        P, dbg = pkg
        with pytest.raises(FloatingPointError, match="myop"):
            dbg.check_numerics(P.to_tensor(np.array([np.nan], "float32")), "myop", "x")

    def test_layer_decorator(self, pkg):
        P, dbg = pkg
        base = paddle.nn.Layer if P is paddle else torch.nn.Module

        class Net(base):
            @dbg.check_layer_numerics
            def forward(self, x):
                return P.multiply(x, P.to_tensor(np.float32(2.0)))

        net = Net()
        out = net(P.to_tensor(np.ones(3, "float32")))
        np.testing.assert_array_equal(_np(out), [2, 2, 2])
        with pytest.raises(FloatingPointError):
            net(P.to_tensor(np.array([np.inf], "float32")))


class TestOperatorStats:
    def test_collect_counts_by_dtype(self, capsys):
        tables = []
        for P, dbg in PKGS.values():
            with dbg.collect_operator_stats():
                a = P.to_tensor(np.ones((2, 2), "float32"))
                b = P.cast(a, "bfloat16")
                _ = P.matmul(a, a)
                _ = P.add(b, b)
                tables.append(dict(dbg.operator_stats()))
            out = capsys.readouterr().out
            assert "matmul" in tables[-1] and "Op Name" in out
            assert tables[-1]["matmul"][2] >= 1  # fp32 column
            add_rows = [v for k, v in tables[-1].items() if "add" in k]
            assert any(r[1] >= 1 for r in add_rows)  # bf16 column
        assert tables[0] == tables[1]

    def test_disabled_by_default(self, pkg):
        P, dbg = pkg
        assert dbg.operator_stats() is None
        _ = P.multiply(P.to_tensor(np.ones(2, "float32")), 2.0)
        assert dbg.operator_stats() is None

    def test_compare_accuracy_raises(self, pkg):
        _, dbg = pkg
        with pytest.raises(NotImplementedError):
            dbg.compare_accuracy("a", "b", "c")
