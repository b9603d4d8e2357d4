"""The port's tensor core (``to_tensor``, dtypes, ``set_default_dtype``,
``seed``, flags and the device rule) against the JAX package's, with the
cases of tests/test_tensor.py that apply to a package whose tensor is
``torch.Tensor`` (indexing and the random samplers wait for their modules,
ROADMAP Queue A item 6)."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as T
from paddle_tpu_torch.device import _CURRENT
from paddle_tpu_torch.framework import dtype as tdtype


def _name(t):
    if isinstance(t, torch.Tensor):
        return str(t.dtype).removeprefix("torch.")
    return np.dtype(t.dtype).name


@pytest.fixture(autouse=True)
def _on_cpu():
    before, default = _CURRENT[0], tdtype.get_default_dtype()
    T.set_device("cpu")
    yield
    _CURRENT[0] = before
    T.set_default_dtype(default)
    paddle.set_default_dtype("float32")


@pytest.mark.parametrize("data,dtype", [
    (1.5, None), (3, None), (True, None), ([1.0, 2.0], None), ([1, 2, 3], None),
    ([[1, 2], [3, 4]], None), (np.arange(3, dtype=np.float64), None),
    (np.arange(3, dtype=np.int32), None), (np.ones(2, np.float16), None),
    ([1.0, 2.0], "float64"), ([1, 2], "float32"), (2.5, "bfloat16"), (1 + 2j, None),
], ids=lambda v: repr(v))
def test_to_tensor_dtype_defaults(data, dtype):
    j = paddle.to_tensor(data, dtype=dtype)
    t = T.to_tensor(data, dtype=dtype)
    assert _name(t) == _name(j)
    assert list(t.shape) == list(j.shape)
    want = np.asarray(j.numpy())
    if _name(j) == "bfloat16":
        want, t = want.astype(np.float32), t.float()
    np.testing.assert_array_equal(t.numpy(), want)


def test_to_tensor_stop_gradient_and_copy():
    x = T.to_tensor([1.0, 2.0], stop_gradient=False)
    assert x.requires_grad and x.is_leaf
    assert not T.to_tensor([1.0]).requires_grad
    # integers stay out of autograd
    assert not T.to_tensor([1, 2], stop_gradient=False).requires_grad
    src = torch.ones(3)
    y = T.to_tensor(src)
    src.add_(1)
    assert y.tolist() == [1.0, 1.0, 1.0]
    arr = np.zeros(2, np.float32)
    z = T.to_tensor(arr)
    arr[0] = 5
    assert z.tolist() == [0.0, 0.0]


def test_to_tensor_of_a_tensor_keeps_its_dtype_unless_asked():
    for P in (paddle, T):
        x = P.to_tensor(np.ones(2, np.float16))
        assert _name(P.to_tensor(x)) == "float16"
        assert _name(P.to_tensor(x, dtype="float32")) == "float32"


def test_set_default_dtype():
    for P in (paddle, T):
        P.set_default_dtype("float64")
        assert _name(P.to_tensor(1.0)) == "float64"
        assert _name(P.zeros([2])) == "float64"
        assert _name(P.arange(0, 1, 0.5)) == "float64"
        assert _name(P.full([1], 0.5)) == "float64"
        assert _name(P.to_tensor(1)) == "int64"
        P.set_default_dtype("float32")
        assert _name(P.to_tensor(1.0)) == "float32"
    assert T.get_default_dtype() == torch.float32


@pytest.mark.parametrize("name", ["bfloat16", "bf16", "float16", "half", "float32", "fp32",
                                  "float", "float64", "double", "int8", "int16", "int32",
                                  "int64", "uint8", "bool", "complex64", "complex128"])
def test_dtype_names(name):
    from paddle_tpu.framework import dtype as jdtype

    assert tdtype.dtype_name(tdtype.convert_dtype(name)) == jdtype.dtype_name(
        jdtype.convert_dtype(name))
    assert tdtype.is_floating(name) == jdtype.is_floating(jdtype.convert_dtype(name))
    assert tdtype.is_integer(name) == jdtype.is_integer(jdtype.convert_dtype(name))


def test_dtype_conversions():
    assert tdtype.convert_dtype(np.float32) == torch.float32
    assert tdtype.convert_dtype(torch.bfloat16) == torch.bfloat16
    assert tdtype.convert_dtype(None) is None
    assert T.dtype("int32") == torch.int32
    assert T.bool == torch.bool and T.bfloat16 == torch.bfloat16
    assert tdtype.promote_types("bfloat16", "float16") == torch.float32
    with pytest.raises(ValueError):
        tdtype.convert_dtype("float128")


def test_seed_reproducible_within_the_port():
    T.seed(42)
    a = torch.randn(4, 4)
    T.seed(42)
    b = torch.randn(4, 4)
    assert torch.equal(a, b)
    assert T.initial_seed() == 42
    state = T.get_rng_state()
    c = torch.rand(3)
    T.set_rng_state(state)
    assert torch.equal(torch.rand(3), c)


def test_flags():
    for P in (paddle, T):
        assert P.get_flags("check_nan_inf") == {"check_nan_inf": False}
        assert P.get_flags(["FLAGS_eager_cached_vjp"]) == {"FLAGS_eager_cached_vjp": True}
        P.set_flags({"FLAGS_some_new_flag": 3})
        assert P.get_flags("some_new_flag") == {"some_new_flag": 3}
        with pytest.raises(KeyError):
            P.get_flags("no_such_flag_anywhere")
    from paddle_tpu.framework import flags as jflags
    from paddle_tpu_torch.framework import flags as tflags

    # every flag of the port's table is the JAX package's, with its default
    # (other tests may define more flags in either process-wide table)
    jtable, ttable = jflags.exported_flags(), tflags.exported_flags()
    assert len(ttable) >= 70
    for k, v in ttable.items():
        assert k in jtable and jtable[k]["default"] == v["default"], k


class TestDeviceRule:
    def test_set_device_cpu_builds_on_the_cpu(self):
        assert T.get_device() == "cpu"
        assert T.to_tensor([1.0]).device.type == "cpu"
        assert T.zeros([2]).device.type == "cpu"
        assert T.to_tensor([1.0], place="cpu").device.type == "cpu"

    def test_no_card_and_no_request_raises(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        _CURRENT[0] = None
        for call in (lambda: T.to_tensor([1.0]), lambda: T.zeros([2]), lambda: T.seed(0),
                     lambda: T.arange(3)):
            with pytest.raises(RuntimeError, match="no card"):
                call()
        assert T.to_tensor([1.0], place="cpu").device.type == "cpu"
        with pytest.raises(RuntimeError, match="no such card"):
            T.set_device("gpu:0")
        with pytest.raises(ValueError):
            T.set_device("tpu")

    def test_a_model_follows_set_device(self):
        from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

        cfg = LlamaConfig(vocab_size=16, hidden_size=16, intermediate_size=32,
                          num_hidden_layers=1, num_attention_heads=2)
        assert LlamaForCausalLM(cfg).device.type == "cpu"


# ---- tests/test_tensor.py's cases, on both packages -----------------------
def test_to_tensor_basic():
    for P in (paddle, T):
        t = P.to_tensor([1.0, 2.0, 3.0])
        assert list(t.shape) == [3] and _name(t) == "float32"


def test_arith_and_broadcast():
    a_np = np.arange(6, dtype=np.float32).reshape(2, 3)
    for P in (paddle, T):
        a = P.to_tensor(a_np)
        b = P.to_tensor(np.ones((3,), dtype=np.float32))
        c = P.subtract(P.add(a, P.multiply(b, 2)), 1)
        np.testing.assert_allclose(np.asarray(c.numpy()), a_np + 1)
        assert _name(P.multiply(a, 2.0)) == "float32"  # a Python scalar does not upcast


def test_reshape_transpose_concat():
    for P in (paddle, T):
        a = P.reshape(P.arange(12), [3, 4])
        assert list(P.transpose(a, [1, 0]).shape) == [4, 3]
        c = P.concat([a, a], axis=0)
        assert list(c.shape) == [6, 4]
        s = P.split(c, 2, axis=0)
        assert len(s) == 2 and list(s[0].shape) == [3, 4]


def test_reductions():
    x_np = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    for P in (paddle, T):
        x = P.to_tensor(x_np)
        np.testing.assert_allclose(np.asarray(P.sum(x, axis=1).numpy()), x_np.sum(1))
        np.testing.assert_allclose(np.asarray(P.mean(x).numpy()), x_np.mean())
        np.testing.assert_allclose(np.asarray(P.max(x, axis=-1).numpy()), x_np.max(-1))
        assert _name(P.argmax(x, axis=2)) == "int64"


def test_where_sort_topk():
    for P in (paddle, T):
        x = P.to_tensor([3.0, 1.0, 2.0])
        v, i = P.topk(x, 2)
        np.testing.assert_allclose(np.asarray(v.numpy()), [3, 2])
        np.testing.assert_array_equal(np.asarray(i.numpy()), [0, 2])
        np.testing.assert_allclose(np.asarray(P.sort(x).numpy()), [1, 2, 3])
        w = P.where(P.greater_than(x, P.full([3], 1.5)), x, P.zeros_like(x))
        np.testing.assert_allclose(np.asarray(w.numpy()), [3, 0, 2])


def test_cast():
    for P in (paddle, T):
        x = P.to_tensor([1.7, 2.3])
        assert _name(P.cast(x, "int32")) == "int32"
        assert _name(P.cast(x, "bfloat16")) == "bfloat16"


def test_dynamic_ops_eager():
    for P in (paddle, T):
        x = P.to_tensor([0.0, 1.0, 0.0, 2.0])
        assert list(P.nonzero(x).shape) == [2, 1]
        m = P.masked_select(x, P.greater_than(x, P.zeros_like(x)))
        np.testing.assert_allclose(np.asarray(m.numpy()), [1, 2])
        u = P.unique(P.to_tensor([3, 1, 3, 2]))
        np.testing.assert_array_equal(np.asarray(u.numpy()), [1, 2, 3])


def test_einsum():
    a = np.random.RandomState(0).rand(3, 4).astype(np.float32)
    b = np.random.RandomState(1).rand(4, 5).astype(np.float32)
    for P in (paddle, T):
        out = P.einsum("ij,jk->ik", P.to_tensor(a), P.to_tensor(b))
        np.testing.assert_allclose(np.asarray(out.numpy()), a @ b, rtol=1e-5)


def test_grad_helpers():
    x = T.to_tensor([1.0, 2.0], stop_gradient=False)
    y = T.sum(T.multiply(x, x))
    (g,) = T.grad(y, x)
    np.testing.assert_array_equal(g.numpy(), [2.0, 4.0])
    with T.no_grad():
        assert not T.is_grad_enabled()
        assert not T.multiply(x, 2.0).requires_grad
    assert T.is_grad_enabled()
    jx = paddle.to_tensor([1.0, 2.0], stop_gradient=False)
    (jg,) = paddle.grad(paddle.sum(paddle.multiply(jx, jx)), jx)
    np.testing.assert_array_equal(jg.numpy(), g.numpy())
    assert T.Tensor is torch.Tensor
