"""The port's op dispatch (``paddle_tpu_torch/ops/_apply.py``) against the JAX
package's (``paddle_tpu/ops/_apply.py``): the op table, the NaN/Inf scan,
the operator stats and the AMP cast of a custom op's category."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as T
from paddle_tpu.amp import debugging as jdbg
from paddle_tpu.ops._apply import get_registry as jax_registry
from paddle_tpu.utils import register_custom_op as jax_register
from paddle_tpu_torch.amp import debugging as tdbg
from paddle_tpu_torch.device import _CURRENT
from paddle_tpu_torch.ops import _apply
from paddle_tpu_torch.ops.optable import generate_op_docs, op_table
from paddle_tpu_torch.utils import register_custom_op

PORT_OPS = [r["name"] for r in op_table()]


@pytest.fixture(autouse=True)
def _clean():
    before = _CURRENT[0]
    T.set_device("cpu")
    yield
    _CURRENT[0] = before
    for dbg in (jdbg, tdbg):
        dbg.disable_tensor_checker()
        dbg._OP_STATS[0] = None


@pytest.mark.parametrize("name", PORT_OPS)
def test_op_has_the_jax_name_and_flags(name):
    """Every op the port registers is a JAX op of that name, with its
    ``differentiable`` flag and ``amp_category``."""
    ours = _apply.get_registry()[name]
    theirs = jax_registry().get(name)
    assert theirs is not None, f"{name} is not a JAX op"
    assert ours.differentiable == theirs.differentiable
    assert ours.amp_category == theirs.amp_category


def test_op_table_rows_and_docs(tmp_path):
    rows = op_table()
    assert len(rows) >= 180
    assert rows == sorted(rows, key=lambda r: r["name"])
    by_name = {r["name"]: r for r in rows}
    assert by_name["matmul"]["amp_category"] == "white"
    assert by_name["rms_norm"]["amp_category"] == "black"
    assert by_name["argmax"]["differentiable"] is False
    assert by_name["flash_attention"]["module"] == (
        "paddle_tpu_torch.nn.functional.flash_attention")
    path = generate_op_docs(str(tmp_path / "ops.md"))
    text = open(path).read()
    assert "| `matmul` |" in text and f"{len(rows)} ops" in text


def test_custom_ops_are_left_out_of_the_table():
    register_custom_op("torch_test_dispatch_table", lambda x: x * 2)
    assert "torch_test_dispatch_table" not in {r["name"] for r in op_table()}
    assert "torch_test_dispatch_table" in {
        r["name"] for r in op_table(include_custom=True)}


class TestNanInf:
    @pytest.mark.parametrize("pkg", ["jax", "port"])
    def test_scan_names_the_op(self, pkg):
        P, dbg = (paddle, jdbg) if pkg == "jax" else (T, tdbg)
        dbg.enable_tensor_checker(dbg.TensorCheckerConfig(enable=True))
        x = P.to_tensor(np.array([1.0, 0.0], "float32"), place="cpu")
        zero = P.to_tensor(np.array([0.0, 0.0], "float32"), place="cpu")
        with pytest.raises(FloatingPointError, match="divide"):
            P.divide(x, zero)
        # an integer output is not scanned, a finite one passes
        P.add(P.to_tensor(np.array([1, 2]), place="cpu"), 1)
        P.multiply(x, x)

    def test_flag_drives_the_port_scan(self):
        T.set_flags({"check_nan_inf": True})
        try:
            x = T.to_tensor([1.0, -1.0])
            with pytest.raises(FloatingPointError, match="log"):
                T.log(x)
        finally:
            T.set_flags({"check_nan_inf": False})
        assert torch.isnan(T.log(T.to_tensor([-1.0]))).all()


class TestOperatorStats:
    @staticmethod
    def _program(P):
        a = P.to_tensor(np.ones((2, 2), "float32"), place="cpu")
        b = P.cast(a, "bfloat16")
        h = P.cast(a, "float16")
        P.matmul(a, a)
        P.add(b, b)
        P.multiply(h, h)
        P.argmax(a, axis=1)
        P.sum(b)
        P.concat([a, a])
        P.split(a, 2)

    def test_tables_equal(self):
        tables = []
        for P, dbg in ((paddle, jdbg), (T, tdbg)):
            with dbg.collect_operator_stats():
                self._program(P)
                tables.append(dict(dbg.operator_stats()))
        assert tables[0] == tables[1]
        assert tables[1]["matmul"] == [0, 0, 1, 0]
        assert tables[1]["add"] == [0, 1, 0, 0]
        assert tables[1]["multiply"] == [1, 0, 0, 0]
        assert tables[1]["argmax"] == [0, 0, 0, 1]

    def test_off_by_default(self):
        assert tdbg.operator_stats() is None
        T.add(T.to_tensor([1.0]), 1.0)
        assert tdbg.operator_stats() is None


class TestAmpCategoryOfCustomOps:
    def test_white_custom_op_gets_bf16_in_both(self):
        seen = {}

        def jax_fn(x):
            seen["jax"] = str(x.dtype)
            return x * 2

        def port_fn(x):
            seen["port"] = str(x.dtype).removeprefix("torch.")
            return x * 2

        jop = jax_register("torch_parity_dispatch_white", jax_fn, amp_category="white")
        top = register_custom_op("torch_test_dispatch_white", port_fn, amp_category="white")
        x = np.ones((2, 2), "float32")
        with paddle.amp.auto_cast(level="O1", dtype="bfloat16"):
            jout = jop(paddle.to_tensor(x))
        with T.amp.auto_cast(level="O1", dtype="bfloat16"):
            tout = top(T.to_tensor(x))
        assert seen == {"jax": "bfloat16", "port": "bfloat16"}
        assert str(jout.dtype) == "bfloat16" and tout.dtype == torch.bfloat16

    def test_uncategorised_custom_op_is_left_alone_at_o1(self):
        top = register_custom_op("torch_test_dispatch_plain", lambda x: x + 1)
        with T.amp.auto_cast(level="O1", dtype="bfloat16"):
            assert top(T.to_tensor([1.0])).dtype == torch.float32
        with T.amp.auto_cast(level="O2", dtype="bfloat16"):
            assert top(T.to_tensor([1.0])).dtype == torch.bfloat16


def test_cast_gradient_flows_back_in_the_input_dtype():
    x = T.to_tensor(np.arange(4, dtype="float32").reshape(2, 2), stop_gradient=False)
    with T.amp.auto_cast(level="O1", dtype="bfloat16"):
        y = T.matmul(x, x)
    assert y.dtype == torch.bfloat16
    T.sum(T.cast(y, "float32")).backward()
    assert x.grad.dtype == torch.float32


def test_non_differentiable_op_output_needs_no_grad():
    x = T.to_tensor([3.0, 1.0, 2.0], stop_gradient=False)
    assert not T.argsort(x).requires_grad
    assert not T.equal(x, x).requires_grad
    assert T.sort(x).requires_grad


def test_apply_raw_returns_a_tuple():
    x = T.to_tensor([1.0, 2.0], stop_gradient=False)
    out = _apply.apply_raw("double", lambda t: t * 2, [x])
    assert isinstance(out, tuple) and len(out) == 1
    out[0].sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), [2.0, 2.0])


def test_name_keyword_is_dropped():
    x = T.to_tensor([1.0])
    assert T.exp(x, name="e").item() == pytest.approx(np.e)
