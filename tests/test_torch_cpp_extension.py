"""paddle_tpu_torch.utils.cpp_extension against the JAX package's, case for
case after tests/test_cpp_extension.py::TestCppExtension, with the same C
source built by the system C++ compiler for both.

The JAX test's ``jit.to_static`` half of ``test_binary_op_and_jit`` is
``test_binary_op_under_to_static``, with ``full_graph=True``: the C call is a
``torch.library`` op, so Dynamo traces the registered op without a graph
break. Registries are process-global, so every op registered here has a name of its
own: ``torch_test_*`` in the port, ``torch_parity_*`` in the JAX package.
"""
import ctypes
import os

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.utils import cpp_extension as jax_cpp
from paddle_tpu_torch.utils.cpp_extension import (BuildError, CppExtension,
                                                  CUDAExtension, load, setup)
from paddle_tpu_torch.utils.custom_op import CustomOpError

SRC = r"""
#include <cstdint>
#include <cmath>
extern "C" void softsign_fwd(const float* x, float* y, int64_t n) {
  for (int64_t i = 0; i < n; ++i) y[i] = x[i] / (1.0f + std::fabs(x[i]));
}
extern "C" void softsign_bwd(const float* x, const float* gy, float* gx,
                             int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    float d = 1.0f + std::fabs(x[i]);
    gx[i] = gy[i] / (d * d);
  }
}
extern "C" void scaled_add(const float* a, const float* b, float* y,
                           int64_t n) {
  for (int64_t i = 0; i < n; ++i) y[i] = a[i] + 2.0f * b[i];
}
"""


@pytest.fixture(scope="module")
def exts(tmp_path_factory):
    """(port extension, JAX extension) of one source, built apart."""
    d = tmp_path_factory.mktemp("torch_cppext")
    src = d / "ops.cc"
    src.write_text(SRC)
    return (load("torch_t_cppext", [str(src)], build_directory=str(d / "port")),
            jax_cpp.load("torch_t_cppext", [str(src)], build_directory=str(d / "jax")))


class TestCppExtension:
    def test_unary_op_with_custom_backward(self, exts):
        ext, jext = exts
        op = ext.def_op("torch_test_softsign", "softsign_fwd",
                        backward_symbol="softsign_bwd")
        jop = jext.def_op("torch_parity_softsign", "softsign_fwd",
                          backward_symbol="softsign_bwd")
        xs = np.array([-2.0, 0.0, 3.0, 0.25], "float32")
        x = torch.from_numpy(xs.copy()).requires_grad_()
        jx = paddle.to_tensor(xs, stop_gradient=False)
        y, jy = op(x), jop(jx)
        y.sum().backward()
        jy.sum().backward()
        np.testing.assert_allclose(y.detach().numpy(), [-2 / 3, 0.0, 0.75, 0.2],
                                   rtol=1e-6)
        np.testing.assert_allclose(x.grad.numpy(), [1 / 9, 1.0, 1 / 16, 0.64],
                                   rtol=1e-6)
        # one C function on the same float32 inputs: equal to the last bit
        np.testing.assert_array_equal(y.detach().numpy(), jy.numpy())
        np.testing.assert_array_equal(x.grad.numpy(), jx.grad.numpy())

    def test_binary_op(self, exts):
        ext, jext = exts
        op = ext.def_op("torch_test_scaled_add", "scaled_add", n_inputs=2)
        jop = jext.def_op("torch_parity_scaled_add", "scaled_add", n_inputs=2)
        a, b = np.ones((2, 3), "float32"), np.full((2, 3), 3.0, "float32")
        out = op(torch.from_numpy(a), torch.from_numpy(b))
        np.testing.assert_allclose(out.numpy(), np.full((2, 3), 7.0))
        np.testing.assert_array_equal(
            out.numpy(), jop(paddle.to_tensor(a), paddle.to_tensor(b)).numpy())

    def test_binary_op_under_to_static(self, exts):
        """The ``jit.to_static`` half of the JAX test_binary_op_and_jit, with
        ``full_graph=True``: no graph break, one compiled signature, the JAX
        package's to_static result to the last bit."""
        import torch._dynamo

        from paddle_tpu import jit as jax_jit
        from paddle_tpu_torch import jit

        ext, jext = exts
        op = ext.def_op("torch_test_scaled_add_jit", "scaled_add", n_inputs=2)
        jop = jext.def_op("torch_parity_scaled_add_jit", "scaled_add", n_inputs=2)
        a, b = np.ones((2, 3), "float32"), np.full((2, 3), 3.0, "float32")
        torch._dynamo.reset()
        f = jit.to_static(lambda u, v: op(u, v) + 1.0, full_graph=True, backend="aot_eager")
        out = f(torch.from_numpy(a), torch.from_numpy(b))
        np.testing.assert_allclose(out.numpy(), np.full((2, 3), 8.0))
        jf = jax_jit.to_static(lambda u, v: jop(u, v) + 1.0)
        np.testing.assert_array_equal(
            out.numpy(), np.asarray(jf(paddle.to_tensor(a), paddle.to_tensor(b)).numpy()))
        assert len(f._cache) == 1 and not f._fallback
        torch._dynamo.reset()

    @pytest.mark.parametrize("dtype", ["float64", "float16"])
    def test_inputs_cast_to_float32(self, exts, dtype):
        ext, jext = exts
        op = ext.def_op(f"torch_test_softsign_{dtype}", "softsign_fwd")
        jop = jext.def_op(f"torch_parity_softsign_{dtype}", "softsign_fwd")
        xs = np.array([-1.5, 0.5, 7.0], dtype)
        y = op(torch.from_numpy(xs))
        jy = jop(paddle.to_tensor(xs))
        assert y.dtype == torch.float32 and str(jy.dtype) == "float32"
        np.testing.assert_array_equal(y.numpy(), jy.numpy())

    def test_gradient_without_backward_symbol_raises(self, exts):
        ext, jext = exts
        op = ext.def_op("torch_test_softsign_nobwd", "softsign_fwd")
        jop = jext.def_op("torch_parity_softsign_nobwd", "softsign_fwd")
        xs = np.array([1.0, -1.0], "float32")
        # the JAX package cannot differentiate its host callback either
        with pytest.raises(ValueError, match="do not support JVP"):
            jop(paddle.to_tensor(xs, stop_gradient=False)).sum().backward()
        with pytest.raises(CustomOpError, match="torch_test_softsign_nobwd"):
            op(torch.from_numpy(xs.copy()).requires_grad_()).sum().backward()
        np.testing.assert_allclose(op(torch.from_numpy(xs)).numpy(), [0.5, -0.5])

    def test_raw_ctypes_binding_available(self, exts):
        fn = exts[0].lib.scaled_add
        a = np.ones(3, np.float32)
        b = np.ones(3, np.float32)
        out = np.empty(3, np.float32)
        fn(a.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
           b.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
           out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
           ctypes.c_int64(3))
        np.testing.assert_allclose(out, [3.0, 3.0, 3.0])

    def test_setup_aot_build(self, tmp_path, monkeypatch):
        src = tmp_path / "aot.cc"
        src.write_text(SRC)
        monkeypatch.setenv("PADDLE_EXTENSION_DIR", str(tmp_path))
        built = setup(name="torch_t_aot", ext_modules=[
            CppExtension([str(src)], name="torch_t_aot")])
        assert built == [str(tmp_path / "libtorch_t_aot.so")]
        assert os.path.exists(built[0])

    def test_cuda_extension_skips_cu_sources(self, tmp_path, monkeypatch):
        src = tmp_path / "host.cc"
        src.write_text(SRC)
        cu = tmp_path / "k.cu"
        cu.write_text("__global__ void k() {}")
        monkeypatch.setenv("PADDLE_EXTENSION_DIR", str(tmp_path))
        built = setup(ext_modules=[CUDAExtension([str(src), str(cu)],
                                                 name="torch_t_mixed")])
        assert built == [str(tmp_path / "libtorch_t_mixed.so")]
        assert hasattr(ctypes.CDLL(built[0]), "softsign_fwd")

    def test_cuda_only_extension_rejected(self, tmp_path):
        cu = tmp_path / "k.cu"
        cu.write_text("__global__ void k() {}")
        with pytest.raises(BuildError, match="CUDA-only"):
            load("torch_t_cuda", [str(cu)], build_directory=str(tmp_path))
        with pytest.raises(jax_cpp.BuildError, match="CUDA-only"):
            jax_cpp.load("torch_t_cuda", [str(cu)], build_directory=str(tmp_path))

    def test_bad_source_reports_compiler_error(self, tmp_path):
        bad = tmp_path / "bad.cc"
        bad.write_text("this is not C++")
        with pytest.raises(BuildError, match="compilation failed"):
            load("torch_t_bad", [str(bad)], build_directory=str(tmp_path))

    def test_reload_after_edit_gets_new_code(self, tmp_path):
        """load() versions the .so by source hash: editing the source and
        re-loading must run the NEW code (no stale dlopen cache)."""
        src = tmp_path / "v.cc"
        src.write_text('#include <cstdint>\nextern "C" void get_v('
                       'const float* x, float* y, int64_t n) '
                       '{ for (int64_t i=0;i<n;++i) y[i] = 1.0f; }')
        m1 = load("torch_t_ver", [str(src)], build_directory=str(tmp_path))
        op1 = m1.def_op("torch_test_ver_op1", "get_v")
        src.write_text('#include <cstdint>\nextern "C" void get_v('
                       'const float* x, float* y, int64_t n) '
                       '{ for (int64_t i=0;i<n;++i) y[i] = 2.0f; }')
        m2 = load("torch_t_ver", [str(src)], build_directory=str(tmp_path))
        op2 = m2.def_op("torch_test_ver_op2", "get_v")
        assert m1.path != m2.path  # distinct versioned artifacts
        x = torch.zeros(3)
        np.testing.assert_allclose(op1(x).numpy(), 1.0)
        np.testing.assert_allclose(op2(x).numpy(), 2.0)

    @pytest.mark.parametrize("case", ["shapes", "arity"])
    def test_mismatched_inputs_rejected(self, exts, case):
        op = exts[0].def_op(f"torch_test_scaled_add_{case}", "scaled_add",
                            n_inputs=2)
        args = (torch.ones(2, 3), torch.ones(3)) if case == "shapes" else (torch.ones(2, 3),)
        with pytest.raises(TypeError, match="share one shape" if case == "shapes"
                           else "takes 2 input"):
            op(*args)
