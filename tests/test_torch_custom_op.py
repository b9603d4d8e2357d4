"""The custom-op extension point of the PyTorch port against the JAX package's
(``paddle_tpu.utils.register_custom_op``), case for case after
tests/test_extension_points.py::TestCustomOp, with the same numpy inputs on
both sides.

The Pallas axpy runs in interpret mode, as the JAX test runs it on the CPU;
the port's op, on CPU tensors, runs the kernel's plain version (the CUDA
kernel itself is held to that version on the card by chip_smoke.py phase 8).
Registries are process-global, so every op registered here has a name of its
own: ``torch_test_*`` in the port, ``torch_parity_*`` in the JAX package.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.experimental import pallas as pl

import paddle_tpu as paddle
from paddle_tpu.utils import register_custom_op as jax_register
from paddle_tpu.utils.custom_op import CustomOpError as JaxCustomOpError
from paddle_tpu_torch.ops._builtin_names import BUILTIN_OP_NAMES
from paddle_tpu_torch.ops.cuda import axpy as port_axpy
from paddle_tpu_torch.utils import get_custom_op, register_custom_op
from paddle_tpu_torch.utils.custom_op import CustomOpError

ROOT = Path(__file__).resolve().parents[1]


def _swish_jax(x):
    return x * jnp.tanh(jnp.log1p(jnp.exp(x)))


def _swish_torch(x):
    return x * torch.tanh(torch.log1p(torch.exp(x)))


class TestRegisterAndAutodiff:
    def test_values_and_grad_match_jax(self):
        xs = np.array([0.5, -1.0, 2.0, -3.0], "float32")
        jop = jax_register("torch_parity_swish", _swish_jax)
        jx = paddle.to_tensor(xs, stop_gradient=False)
        jy = jop(jx)
        jy.sum().backward()

        op = register_custom_op("torch_test_swish", _swish_torch)
        x = torch.from_numpy(xs.copy()).requires_grad_()
        y = op(x)
        y.sum().backward()

        expect = xs * np.tanh(np.log1p(np.exp(xs)))
        np.testing.assert_allclose(y.detach().numpy(), expect, rtol=1e-5)
        np.testing.assert_allclose(y.detach().numpy(), jy.numpy(), rtol=1e-5)
        np.testing.assert_allclose(x.grad.numpy(), jx.grad.numpy(), rtol=1e-5)

    def test_name_kwarg_dropped(self):
        jop = jax_register("torch_parity_named", lambda x: x * 2.0)
        op = register_custom_op("torch_test_named", lambda x: x * 2.0)
        xs = np.arange(3, dtype="float32")
        np.testing.assert_array_equal(
            op(torch.from_numpy(xs), name="y").numpy(),
            jop(paddle.to_tensor(xs), name="y").numpy())


class TestCustomBackward:
    def test_custom_backward_used(self):
        def bwd(residuals, g):
            (x,) = residuals
            return (g * 100.0,)  # deliberately wrong to prove it is used

        jop = jax_register("torch_parity_custom_bwd", lambda x: x * 2.0,
                           backward=bwd)
        jx = paddle.to_tensor(np.ones(3, "float32"), stop_gradient=False)
        jop(jx).sum().backward()

        op = register_custom_op("torch_test_custom_bwd", lambda x: x * 2.0,
                                backward=bwd)
        x = torch.ones(3, requires_grad=True)
        op(x).sum().backward()
        np.testing.assert_allclose(x.grad.numpy(), np.full(3, 100.0))
        np.testing.assert_allclose(jx.grad.numpy(), np.full(3, 100.0))

    @pytest.mark.parametrize("by_keyword", [False, True])
    def test_multi_output_residuals_and_unused_output(self, by_keyword):
        """Residuals are all primal arguments (a Python scalar reaches
        backward unchanged); the cotangent has the output's structure, and an
        output that does not reach the loss contributes zeros."""
        seen = {}

        def bwd(residuals, g):
            x, s = residuals
            ga, gb = g
            seen.setdefault("scale", []).append(s)
            return (ga * s + gb * 7.0, None)  # gb must be zeros

        def fwd(x, s=1.0):
            return x * s, x + 1.0

        jop = jax_register(f"torch_parity_two_out_{by_keyword}", fwd, backward=bwd)
        op = register_custom_op(f"torch_test_two_out_{by_keyword}", fwd,
                                backward=bwd)
        xs = np.array([1.0, -2.0, 0.5], "float32")
        jx = paddle.to_tensor(xs, stop_gradient=False)
        x = torch.from_numpy(xs.copy()).requires_grad_()
        kw = dict(s=3.0) if by_keyword else {}
        args = () if by_keyword else (3.0,)
        ja, jb = jop(jx, *args, **kw)
        a, b = op(x, *args, **kw)
        ja.sum().backward()
        a.sum().backward()
        np.testing.assert_array_equal(a.detach().numpy(), ja.numpy())
        np.testing.assert_array_equal(b.detach().numpy(), jb.numpy())
        np.testing.assert_array_equal(x.grad.numpy(), jx.grad.numpy())
        np.testing.assert_array_equal(x.grad.numpy(), np.full(3, 3.0))
        assert [float(s) for s in seen["scale"]] == [3.0, 3.0]
        assert all(isinstance(s, float) for s in seen["scale"])

    def test_wrong_gradient_count_raises(self):
        op = register_custom_op("torch_test_bad_bwd_count", lambda x, y: x * y,
                                backward=lambda res, g: (g,))
        x = torch.ones(2, requires_grad=True)
        with pytest.raises(CustomOpError, match="1 gradients for 2 inputs"):
            op(x, torch.ones(2)).sum().backward()


class TestRegistry:
    @pytest.mark.parametrize("kind", ["custom", "builtin"])
    def test_duplicate_rejected(self, kind):
        if kind == "custom":
            jname, name = "torch_parity_dup_op", "torch_test_dup_op"
            jax_register(jname, lambda x: x)
            register_custom_op(name, lambda x: x)
        else:
            jname = name = "matmul"
        with pytest.raises(JaxCustomOpError):
            jax_register(jname, lambda x: x)
        with pytest.raises(CustomOpError, match="already registered"):
            register_custom_op(name, lambda x: x)

    def test_builtin_names_equal_jax_registry(self):
        # a fresh interpreter: the names `import paddle_tpu` registers, not
        # what other tests of this worker added to the registry since
        code = ("import json, paddle_tpu\n"
                "from paddle_tpu.ops._apply import get_registry\n"
                "from paddle_tpu.utils.custom_op import _CUSTOM_OPS\n"
                "print(json.dumps(sorted(set(get_registry()) - set(_CUSTOM_OPS))))\n")
        env = dict(os.environ, PADDLE_TPU_PLATFORM="cpu", JAX_PLATFORMS="cpu")
        out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr
        jax_builtin = set(json.loads(out.stdout.strip().splitlines()[-1]))
        assert len(BUILTIN_OP_NAMES) == len(set(BUILTIN_OP_NAMES))
        assert set(BUILTIN_OP_NAMES) == jax_builtin, (
            f"only in the port's copy: {sorted(set(BUILTIN_OP_NAMES) - jax_builtin)}; "
            f"only in the JAX registry: {sorted(jax_builtin - set(BUILTIN_OP_NAMES))}")

    def test_decorator_and_get_custom_op(self):
        @jax_register("torch_parity_deco")
        def jop(x):
            return x + 1.0

        @register_custom_op("torch_test_deco")
        def op(x):
            return x + 1.0

        xs = np.arange(4, dtype="float32")
        np.testing.assert_array_equal(op(torch.from_numpy(xs)).numpy(),
                                      jop(paddle.to_tensor(xs)).numpy())
        assert get_custom_op("torch_test_deco") is op
        with pytest.raises(CustomOpError, match="no custom op"):
            get_custom_op("torch_test_never_registered")

    @pytest.mark.parametrize("category", ["white", "black", None])
    def test_amp_category_kept(self, category):
        suffix = category or "none"
        jop = jax_register(f"torch_parity_amp_{suffix}", lambda x: x,
                           amp_category=category)
        op = register_custom_op(f"torch_test_amp_{suffix}", lambda x: x,
                                amp_category=category)
        assert op.opdef.amp_category == jop.opdef.amp_category == category
        assert op.opdef.name == f"torch_test_amp_{suffix}"


class TestGradientGuard:
    def test_detached_output_raises(self):
        # what a forward that launches a ctypes kernel returns: no grad_fn.
        # The call gives the value, and the gradient raises, as the JAX
        # package's host callback does (tests/test_torch_cpp_extension.py)
        op = register_custom_op("torch_test_detached", lambda x: x.detach() * 2.0)
        x = torch.ones(3, requires_grad=True)
        y = op(x)
        np.testing.assert_array_equal(y.detach().numpy(), np.full(3, 2.0))
        with pytest.raises(CustomOpError) as err:
            y.sum().backward()
        msg = str(err.value)
        assert "torch_test_detached" in msg
        assert "backward=" in msg and "differentiable=False" in msg
        assert x.grad is None

    def test_output_off_the_loss_does_not_raise(self):
        # only a gradient that reaches the cut output raises
        op = register_custom_op("torch_test_detached_pair",
                                lambda x: (x * 3.0, x.detach() * 2.0))
        x = torch.ones(3, requires_grad=True)
        a, b = op(x)
        a.sum().backward()
        np.testing.assert_array_equal(x.grad.numpy(), np.full(3, 3.0))
        with pytest.raises(CustomOpError, match="torch_test_detached_pair"):
            b.sum().backward()

    @pytest.mark.parametrize("case", ["no_input_requires_grad", "no_grad_mode",
                                      "integer_output", "float_and_integer"])
    def test_guard_stays_quiet(self, case):
        fwd = {"integer_output": lambda x: torch.argmax(x),
               "float_and_integer": lambda x: (x * 2.0, torch.argmax(x))}.get(
                   case, lambda x: x.detach() * 2.0)
        op = register_custom_op(f"torch_test_quiet_{case}", fwd)
        x = torch.ones(3, requires_grad=case != "no_input_requires_grad")
        if case == "no_grad_mode":
            with torch.no_grad():
                out = op(x)
        else:
            out = op(x)
        if case == "float_and_integer":
            assert out[0].grad_fn is not None and out[1].grad_fn is None


def _pallas_axpy_op(name):
    """The JAX test's registration, kernel and all, under another name."""
    def kernel(x_ref, o_ref):
        o_ref[...] = x_ref[...] * 2.0 + 1.0

    def fwd(x):
        return pl.pallas_call(
            kernel,
            out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype),
            interpret=jax.devices()[0].platform != "tpu",
        )(x)

    return jax_register(name, fwd, differentiable=False)


_SPECIALS = np.array([np.inf, -np.inf, np.nan, 3.3895314e38, -3.3895314e38,
                      1.6e38, 1e-45, 1.17549435e-38, -0.0, -0.5, 65504.0,
                      32752.0, 32768.0, -32768.0, 6e-8, 1.0], "float32")


def _inputs(shape, seed):
    x = np.random.RandomState(seed).randn(*shape).astype("float32") * 100
    flat = x.reshape(-1)
    k = min(flat.size, _SPECIALS.size)
    flat[:k] = _SPECIALS[:k]
    return x


def _torch_bits(t):
    """(bit pattern, NaN mask) of a float32, float16 or bfloat16 tensor."""
    t = t.detach()
    if t.element_size() == 2:
        return t.view(torch.int16).numpy().view(np.uint16), t.isnan().numpy()
    return t.numpy().view(np.uint32), t.isnan().numpy()


def _assert_same_bits(port, ref):
    """NaN where ``ref`` is NaN (a NaN's payload is not part of the
    function), the same bits everywhere else."""
    (pbits, pnan), (rbits, rnan) = port, ref
    np.testing.assert_array_equal(pnan, rnan)
    np.testing.assert_array_equal(pbits[~pnan], rbits[~rnan])


def _jax_bits(a):
    """(bit pattern, NaN mask) of a float32 or bfloat16 array."""
    a = np.asarray(a)
    return (a.view(np.uint16 if a.itemsize == 2 else np.uint32),
            np.isnan(a.astype(np.float32)))


class TestPallasAxpy:
    @pytest.mark.parametrize("shape,dtype", [
        ((8,), "float32"),         # the JAX test's input shape
        ((3, 1001), "float32"),    # ragged
        ((3, 1001), "bfloat16"),
    ])
    def test_bit_exact_against_pallas(self, shape, dtype):
        jop = _pallas_axpy_op(f"torch_parity_pallas_axpy_{len(shape)}_{dtype}")
        op = port_axpy.register_example(
            name=f"torch_test_pallas_axpy_{len(shape)}_{dtype}")
        xs = np.arange(8, dtype="float32") if shape == (8,) else _inputs(shape, 0)
        jx = paddle.to_tensor(xs).astype(dtype)
        x = torch.from_numpy(xs.copy()).to(getattr(torch, dtype))
        _assert_same_bits(_torch_bits(x), _jax_bits(jx.numpy()))  # same inputs

        before = port_axpy.launches
        y = op(x)
        assert port_axpy.launches == before  # the CPU takes the plain version
        assert y.dtype == x.dtype and tuple(y.shape) == shape
        _assert_same_bits(_torch_bits(y), _jax_bits(jop(jx).numpy()))
        if shape == (8,):
            np.testing.assert_array_equal(y.numpy(), np.arange(8) * 2.0 + 1.0)

    def test_not_differentiable(self):
        jop = _pallas_axpy_op("torch_parity_pallas_axpy_nograd")
        op = port_axpy.register_example(name="torch_test_pallas_axpy_nograd")
        xs = np.arange(8, dtype="float32")
        jy = jop(paddle.to_tensor(xs, stop_gradient=False))
        y = op(torch.from_numpy(xs.copy()).requires_grad_())
        assert jy.stop_gradient
        assert not y.requires_grad and y.grad_fn is None
        assert op.opdef.differentiable is False

    @pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
    def test_kernel_arithmetic_equals_plain_version(self, dtype):
        """The kernel computes fmaf(x, 2, 1) in fp32 and rounds once to the
        dtype. 2x is exact, so that equals the plain version's two rounded
        steps bit for bit, specials included. fp64 stands in for the fma:
        2x + 1 is exact there wherever the fp32 rounding can see the 1."""
        x = torch.from_numpy(_inputs((257,), 1)).to(dtype)
        kernel_arith = (x.double() * 2 + 1).float().to(dtype)
        _assert_same_bits(_torch_bits(port_axpy.axpy(x)), _torch_bits(kernel_arith))

    @pytest.mark.parametrize("bad", ["int32", "float64", "strided"])
    def test_refusals(self, bad):
        x = {"int32": torch.arange(8, dtype=torch.int32),
             "float64": torch.zeros(8, dtype=torch.float64),
             "strided": torch.zeros(8, 2)[:, 0]}[bad]
        with pytest.raises(ValueError if bad == "strided" else TypeError):
            port_axpy.axpy(x)

    def test_empty(self):
        before = port_axpy.launches
        y = port_axpy.axpy(torch.zeros(0, 5, dtype=torch.bfloat16))
        assert y.shape == (0, 5) and y.dtype == torch.bfloat16
        assert port_axpy.launches == before


class TestUtilsNamespace:
    def test_exports_match_jax(self):
        import paddle_tpu.utils as jax_utils
        import paddle_tpu_torch.utils as port_utils

        for name in ("cpp_extension", "custom_op", "register_custom_op",
                     "get_custom_op", "try_import", "deprecated", "run_check",
                     "unique_name"):
            assert hasattr(jax_utils, name) and hasattr(port_utils, name), name

    def test_run_check(self, monkeypatch, capsys):
        from paddle_tpu_torch.utils import run_check

        run_check(device="cpu")
        assert "works on cpu" in capsys.readouterr().out
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no card"):
            run_check()

    def test_try_import_deprecated_unique_name(self):
        import paddle_tpu.utils as jax_utils
        import paddle_tpu_torch.utils as port_utils

        assert port_utils.try_import("math").sqrt(4.0) == 2.0
        with pytest.raises(ImportError, match="hint"):
            port_utils.try_import("torch_test_no_such_module", err_msg="hint")

        @port_utils.deprecated(update_to="new_api", since="2.0")
        def old(x):
            return x + 1

        with pytest.warns(DeprecationWarning, match="use new_api"):
            assert old(1) == 2
        port_names, jax_names = (type(m.unique_name)() for m in (port_utils, jax_utils))
        seq = ["fc", "fc", "tmp", "fc"]
        assert ([port_names.generate(k) for k in seq]
                == [jax_names.generate(k) for k in seq] == ["fc_0", "fc_1", "tmp_0", "fc_2"])
