"""The port's framework odds and ends against the JAX package's:
``framework/enforce.py`` (the typed errors: classes, builtin bases, codes,
messages and the "[Hint: ...]" format; tests/test_extension_points.py
TestEnforce), ``framework/containers.py`` (SelectedRows, StringTensor),
``tensor_array.py`` (tests/test_export_surface.py TestTensorArray), the top
level (``shape``, ``rank``, ``check_shape``'s order, ``reduce_as``, ``batch``,
the places, the sentinels, ``tensor`` as a module), ``version``,
``sysconfig``, ``regularizer``, ``_C_ops``/``_legacy_C_ops``
(tests/test_c_ops_compat.py), and the local-file readers ``utils.weights``,
``utils.download`` and ``hub`` on fixtures each test writes (nothing is
downloaded; tests/test_pretrained.py and tests/test_export_surface.py
TestUtilsAndHub). Values are compared exactly, the LLaMA logits at 1e-5.
"""
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as T
from paddle_tpu.framework import enforce as JE
from paddle_tpu_torch.device import _CURRENT
from paddle_tpu_torch.framework import enforce as TE

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _on_cpu():
    before = _CURRENT[0]
    T.set_device("cpu")
    yield
    _CURRENT[0] = before


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t.numpy())


# -- enforce -------------------------------------------------------------------
def _error_classes(mod):
    return {n: c for n, c in vars(mod).items()
            if isinstance(c, type) and issubclass(c, Exception)}


def test_enforce_taxonomy_matches_jax():
    jc, tc = _error_classes(JE), _error_classes(TE)
    assert sorted(jc) == sorted(tc)
    for name, j in jc.items():
        t = tc[name]
        assert t.code == j.code, name
        # the same builtin bases, in the same order
        assert [b.__name__ for b in t.__mro__] == [b.__name__ for b in j.__mro__], name
    assert issubclass(TE.InvalidArgumentError, ValueError)
    assert issubclass(TE.NotFoundError, LookupError)
    assert issubclass(TE.OutOfRangeError, IndexError)
    assert issubclass(TE.ResourceExhaustedError, MemoryError)
    assert issubclass(TE.PermissionDeniedError, PermissionError)
    assert issubclass(TE.ExecutionTimeoutError, TimeoutError)
    assert issubclass(TE.UnimplementedError, NotImplementedError)
    for cls in tc.values():
        assert issubclass(cls, TE.EnforceNotMet) and issubclass(cls, RuntimeError)
    assert TE.__all__ == JE.__all__


@pytest.mark.parametrize("call", [
    lambda E: E.enforce(False, "bad arg", hint="pass a positive value"),
    lambda E: E.enforce(0, "zero", exc=E.NotFoundError),
    lambda E: E.enforce_eq(3, 4),
    lambda E: E.enforce_ne(5, 5, hint="h"),
    lambda E: E.enforce_gt(1, 2),
    lambda E: E.enforce_ge(1, 2, msg="custom"),
    lambda E: E.enforce_lt(5, 5),
    lambda E: E.enforce_le(6, 5, exc=E.OutOfRangeError),
    lambda E: E.enforce_shape(np.zeros((2, 3)), (2, 4), name="w"),
], ids=["enforce", "exc", "eq", "ne_hint", "gt", "ge_msg", "lt", "le_exc", "shape"])
def test_enforce_messages_match_jax(call):
    with pytest.raises(JE.EnforceNotMet) as j:
        call(JE)
    with pytest.raises(TE.EnforceNotMet) as t:
        call(TE)
    assert type(t.value).__name__ == type(j.value).__name__
    assert str(t.value) == str(j.value)


def test_enforce_passing_checks_and_tensor_checks():
    for E in (JE, TE):
        E.enforce(True)
        E.enforce_eq(3, 3)
        E.enforce_gt(4, 3)
        E.enforce_le(3, 3)
    x = torch.zeros(2, 3)
    assert TE.enforce_shape(x, (2, 3)) == (2, 3)
    assert TE.enforce_shape(x, (None, -1)) == (2, 3)
    with pytest.raises(TE.InvalidArgumentError, match=r"\[Hint: None/-1 dims match"):
        TE.enforce_shape(x, (2, 4))
    TE.enforce_dtype(x, ["float32", "bfloat16"])
    with pytest.raises(TE.InvalidArgumentError, match="expected one of"):
        TE.enforce_dtype(x, "int64")


@pytest.mark.parametrize("P", [paddle, T], ids=["jax", "port"])
def test_optimizer_without_parameters_raises_typed_error(P):
    E = JE if P is paddle else TE
    with pytest.raises(E.InvalidArgumentError):
        P.optimizer.SGD(learning_rate=0.1)


# -- SelectedRows / StringTensor -------------------------------------------------
def test_selected_rows_densify_matches_jax():
    from paddle_tpu.framework.containers import SelectedRows as JSR
    from paddle_tpu_torch.framework.containers import SelectedRows as TSR

    rows = np.array([4, 0, 4, 2])
    value = np.random.RandomState(0).randn(4, 3).astype("float32")
    j = JSR(rows, height=6, value=paddle.to_tensor(value))
    t = TSR(rows, height=6, value=torch.from_numpy(value))
    np.testing.assert_allclose(_np(t.to_dense()), _np(j.to_dense()), rtol=1e-6)
    assert t.rows() == j.rows() == [4, 0, 4, 2] and t.height() == j.height() == 6
    t.set_rows([1, 1]), j.set_rows([1, 1])
    t.set_height(2), j.set_height(2)
    t.set_tensor(torch.ones(2, 3)), j.set_tensor(paddle.to_tensor(np.ones((2, 3), "float32")))
    np.testing.assert_array_equal(_np(t.to_dense()), _np(j.to_dense()))
    assert _np(t.to_dense())[1].tolist() == [2.0, 2.0, 2.0]
    assert t.get_tensor().shape == (2, 3)
    # numpy values densify too, on the host
    np.testing.assert_array_equal(_np(TSR([0], 1, np.ones((1, 2))).to_dense()), [[1.0, 1.0]])
    for cls, val in ((JSR, paddle.to_tensor(value)), (TSR, torch.from_numpy(value))):
        with pytest.raises(ValueError, match="out of range"):
            cls([0, 6, 1, 2], height=6, value=val).to_dense()
        with pytest.raises(ValueError, match="out of range"):
            cls([-1, 0, 1, 2], height=6, value=val).to_dense()
        with pytest.raises(ValueError, match="no value"):
            cls([0], height=1).to_dense()
    assert repr(t).startswith("SelectedRows(height=2")


def test_string_tensor_matches_jax():
    from paddle_tpu.framework.containers import StringTensor as JST
    from paddle_tpu_torch.framework.containers import StringTensor as TST

    data = [["ab", "c"], ["def", ""]]
    j, t = JST(data, name="s"), TST(data, name="s")
    assert t.shape == j.shape == [2, 2]
    assert len(t) == len(j) == 2
    assert list(t) == list(j) == ["ab", "c", "def", ""]
    assert t[1, 0] == j[1, 0] == "def"
    assert isinstance(t[0], TST) and t[0].shape == [2] and t[0].name == "s"
    assert t.numpy().dtype == object
    assert TST().shape == JST().shape == [0]


# -- TensorArray (tests/test_export_surface.py TestTensorArray) ---------------------
@pytest.mark.parametrize("P", [paddle, T], ids=["jax", "port"])
def test_tensor_array_write_read_length(P):
    arr = P.create_array(dtype="float32")
    x = P.to_tensor(np.full((3, 3), 5.0, "float32"), place="cpu")
    i = P.to_tensor(np.zeros((1,), "int32"), place="cpu")
    arr = P.array_write(x, i, array=arr)
    assert P.array_length(arr) == 1
    np.testing.assert_allclose(_np(P.array_read(arr, i)), _np(x))
    # a 0-d index too, and a negative one reads from the end
    assert P.array_read(arr, P.to_tensor(np.array(0), place="cpu")) is x
    assert P.array_read(arr, -1) is x


@pytest.mark.parametrize("P", [paddle, T], ids=["jax", "port"])
def test_tensor_array_overwrite_append_and_errors(P):
    arr = P.create_array()
    a = P.to_tensor(np.ones(2, "float32"), place="cpu")
    b = P.to_tensor(np.zeros(2, "float32"), place="cpu")
    P.array_write(a, 0, arr)
    P.array_write(b, 1, arr)
    P.array_write(b, 0, arr)  # overwrite
    assert P.array_length(arr) == 2
    np.testing.assert_allclose(_np(P.array_read(arr, 0)), _np(b))
    with pytest.raises(ValueError):
        P.array_write(a, 5, arr)
    assert P.array_write(a, 0) == [a]
    assert P.create_array("float32", [a, b]) == [a, b]
    with pytest.raises(TypeError):
        P.create_array("float32", [np.ones(2)])
    with pytest.raises(TypeError):
        P.array_length((a,))
    with pytest.raises(TypeError):
        P.array_read((a,), 0)


def test_tensor_namespace_is_a_module():
    import importlib

    assert T.tensor.create_array is T.create_array
    assert callable(T.tensor.matmul) and T.tensor.sin_ is T.sin_
    assert importlib.import_module("paddle_tpu_torch.tensor") is T.tensor
    from paddle_tpu_torch.tensor import matmul  # noqa: F401


# -- the top level ------------------------------------------------------------------
def test_shape_rank_reduce_as_match_jax():
    x = np.random.RandomState(0).randn(2, 1, 3).astype("float32")
    j, t = paddle.to_tensor(x), T.to_tensor(x, place="cpu")
    assert T.rank(t) == paddle.rank(j) == 3
    js, ts = paddle.shape(j), T.shape(t)
    assert ts.dtype == torch.int64 and np.asarray(js.numpy()).dtype == np.int64
    np.testing.assert_array_equal(_np(ts), _np(js))
    big = np.random.RandomState(1).randn(4, 2, 5, 3).astype("float32")
    tgt = np.zeros((2, 1, 3), "float32")
    jr = paddle.reduce_as(paddle.to_tensor(big), paddle.to_tensor(tgt))
    tr = T.reduce_as(T.to_tensor(big, place="cpu"), T.to_tensor(tgt, place="cpu"))
    assert tuple(tr.shape) == tuple(jr.shape) == (2, 1, 3)
    np.testing.assert_allclose(_np(tr), _np(jr), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("P", [paddle, T], ids=["jax", "port"])
def test_check_shape_order(P):
    P.check_shape([2, 3])
    P.check_shape((True, 4))
    P.check_shape(P.to_tensor(np.array([2, 3]), place="cpu"))
    with pytest.raises(ValueError):
        P.check_shape([-2])
    with pytest.raises(ValueError):  # negative floats: ValueError first
        P.check_shape([-2.5])
    with pytest.raises(TypeError):
        P.check_shape([2.5])


@pytest.mark.parametrize("P", [paddle, T], ids=["jax", "port"])
def test_batch_and_lazy_guard(P):
    def reader():
        yield from range(7)

    assert list(P.batch(reader, 3)()) == [[0, 1, 2], [3, 4, 5], [6]]
    assert list(P.batch(reader, 3, drop_last=True)()) == [[0, 1, 2], [3, 4, 5]]
    with P.LazyGuard() as g:
        assert isinstance(g, P.LazyGuard)


def test_places_and_sentinels():
    assert repr(T.CPUPlace()) == repr(paddle.CPUPlace()) == "Place(cpu)"
    assert repr(T.CUDAPlace(1)) == "Place(gpu:1)"
    assert T.CUDAPlace(1).device == torch.device("cuda", 1)
    assert T.CPUPlace().device == torch.device("cpu")
    assert T.TPUPlace is T.CUDAPlace and T.CustomPlace is T.CUDAPlace
    assert T.CUDAPinnedPlace is T.CPUPlace
    assert T.CUDAPlace(0) == T.CUDAPlace(0) != T.CUDAPlace(1)
    t = T.to_tensor([1.0, 2.0], place=T.CPUPlace())
    assert t.device.type == "cpu"
    T.set_device(T.CPUPlace())
    assert T.get_device() == "cpu"
    assert (T.pstring, T.raw) == (paddle.pstring, paddle.raw)
    assert T.float8_e4m3fn is torch.float8_e4m3fn and T.float8_e5m2 is torch.float8_e5m2
    assert T.bool_ is torch.bool and T.__version__ == paddle.__version__
    assert T.disable_signal_handler() is None
    assert T.in_dynamic_mode() is True
    assert torch.compile(lambda: T.in_dynamic_mode(), backend="eager", fullgraph=True)() \
        is False
    torch._dynamo.reset()
    for name in ("cuda", "rocm", "xpu", "cinn", "distribute"):
        fn = f"is_compiled_with_{name}"
        assert getattr(T, fn) is getattr(T.device, fn)
    assert T.is_compiled_with_custom_device("tpu") is False


def test_subpackages_bound_and_import_loads_no_cuda_library():
    for name in ("jit", "inference", "models", "framework_io", "incubate", "utils", "profiler",
                 "hub", "version", "sysconfig", "regularizer", "distributed", "tensor_array"):
        assert hasattr(T, name), name
    code = ("import sys, torch, paddle_tpu_torch\n"
            "from paddle_tpu_torch.ops.cuda import _build\n"
            "print(len(_build._libs), torch.cuda.is_initialized(),"
            " any(m.split('.')[0] in ('jax', 'paddle_tpu') for m in sys.modules))")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["0", "False", "False"]


# -- version, sysconfig, regularizer, utils.require_version ---------------------------
def test_version_reports_torch_build(capsys):
    from paddle_tpu_torch import version as V

    for name in ("full_version", "major", "minor", "patch", "rc", "istaged", "commit"):
        assert getattr(V, name) == getattr(paddle.version, name), name
    assert V.cuda() == (torch.version.cuda or "False") == V.cuda_version
    assert V.tpu() == "False" and V.xpu() == "False"
    if torch.backends.cudnn.is_available():
        assert V.cudnn() == str(torch.backends.cudnn.version())
    else:
        assert V.cudnn() == "False" == V.cudnn_version
    if not torch.cuda.is_available():
        assert V.nccl() == "0" == V.nccl_version
    V.show()
    out = capsys.readouterr().out
    assert "cuda:" in out and "cudnn:" in out and "tpu: False" in out
    with pytest.raises(AttributeError):
        V.not_a_version_field  # noqa: B018


@pytest.mark.parametrize("P", [paddle, T], ids=["jax", "port"])
def test_require_version(P):
    P.utils.require_version("0.1.0")
    P.utils.require_version("0.3.0rc1", "0.3.0")
    with pytest.raises(Exception, match="min_version"):
        P.utils.require_version("9.0")
    with pytest.raises(Exception, match="max_version"):
        P.utils.require_version("0.1", "0.2.9")


def test_sysconfig_and_regularizer():
    assert os.path.isfile(os.path.join(T.sysconfig.get_include(), "hopper.cuh"))
    assert T.sysconfig.get_lib().endswith(os.path.join("paddle_tpu_torch", "_build"))
    assert T.regularizer.L1Decay is T.optimizer.L1Decay
    assert T.regularizer.L2Decay is T.optimizer.L2Decay
    assert T.regularizer.__all__ == paddle.regularizer.__all__


# -- _C_ops (tests/test_c_ops_compat.py) ---------------------------------------------
def test_c_ops_resolution():
    from paddle_tpu_torch import _C_ops, _legacy_C_ops

    x, y = torch.ones(2, 3), torch.ones(3, 4)
    assert float(_C_ops.matmul(x, y).sum()) == 24.0
    assert float(_C_ops.final_state_add(x, x).sum()) == 12.0
    assert float(_legacy_C_ops.add(x, x).sum()) == 12.0
    t = torch.tensor([-1.0, 0.5])
    assert _C_ops.abs_(t) is t and t.tolist() == [1.0, 0.5]
    # a registered op without a public binding dispatches through the registry
    parts = _C_ops.split_op(torch.arange(6.0), [2], 0)
    assert [p.tolist() for p in parts] == [[0.0, 1.0], [2.0, 3.0, 4.0, 5.0]]
    with pytest.raises(AttributeError, match="no op 'definitely_not_an_op'"):
        _C_ops.definitely_not_an_op  # noqa: B018
    names = dir(_C_ops)
    assert len(names) > 200 and "matmul" in names and "split_op" in names
    w = torch.ones(2, 2, requires_grad=True)
    _C_ops.matmul(w, w).sum().backward()
    assert torch.isfinite(w.grad).all()


# -- utils.weights, utils.download and hub ----------------------------------------------
def _pickle(path, sd):
    with open(path, "wb") as f:
        pickle.dump(sd, f)
    return str(path)


def test_conversions_match_jax():
    from paddle_tpu.utils import weights as JW
    from paddle_tpu_torch.utils import weights as TW

    rng = np.random.RandomState(0)
    torch_sd = {"fc.weight": rng.randn(10, 4), "embeddings.word_embeddings.weight":
                rng.randn(50, 8), "bn.running_mean": rng.randn(4), "bn.running_var":
                rng.randn(4), "bn.num_batches_tracked": np.zeros((), "int64"),
                "module.head.bias": rng.randn(4)}
    bert_sd = {"embeddings.LayerNorm.weight": rng.randn(8),
               "encoder.layer.0.attention.self.query.weight": rng.randn(8, 8),
               "encoder.layer.0.output.LayerNorm.bias": rng.randn(8),
               "embeddings.position_ids": np.arange(4)}
    mha_sd = {"attn.in_proj_weight": rng.randn(12, 4), "attn.in_proj_bias": rng.randn(12),
              "attn.out_proj.weight": rng.randn(4, 4)}
    for fn, sd in (("convert_torch_state_dict", torch_sd),
                   ("convert_hf_bert_state_dict", bert_sd),
                   ("convert_torch_mha_state_dict", mha_sd)):
        j, t = getattr(JW, fn)(sd), getattr(TW, fn)(sd)
        assert sorted(t) == sorted(j), fn
        for k in j:
            np.testing.assert_array_equal(t[k], j[k])
    for W in (JW, TW):
        with pytest.raises(NotImplementedError, match="unpacked-projection"):
            W.convert_torch_mha_state_dict({"attn.q_proj_weight": np.zeros((2, 2))})


def test_load_checkpoint_formats(tmp_path):
    from paddle_tpu.utils import weights as JW
    from paddle_tpu_torch.utils import weights as TW

    rng = np.random.RandomState(1)
    plain = {"a": rng.randn(2, 3).astype("float32"), "b": np.arange(4),
             "StructuredToParameterName@@": {}}
    path = _pickle(tmp_path / "plain.pdparams", plain)
    j, t = JW.load_checkpoint(path), TW.load_checkpoint(path)
    assert sorted(t) == sorted(j) == ["a", "b"]
    for k in j:
        np.testing.assert_array_equal(t[k], j[k])
    # each package's paddle.save format, bf16 included, read by the other
    sd = {"w": T.to_tensor(rng.randn(3, 2).astype("float32"), place="cpu").to(torch.bfloat16),
          "s": T.to_tensor(np.arange(3), place="cpu")}
    T.save(sd, str(tmp_path / "port.pdparams"))
    paddle.save({"w": paddle.cast(paddle.to_tensor(_np(sd["w"].float())), "bfloat16"),
                 "s": paddle.to_tensor(np.arange(3))}, str(tmp_path / "jax.pdparams"))
    for f in ("port.pdparams", "jax.pdparams"):
        j, t = JW.load_checkpoint(str(tmp_path / f)), TW.load_checkpoint(str(tmp_path / f))
        for k in ("w", "s"):
            np.testing.assert_array_equal(t[k], j[k])
        np.testing.assert_array_equal(t["w"], sd["w"].float().numpy())
    junk = _pickle(tmp_path / "junk.pdparams", [1, 2, 3])
    for W in (JW, TW):
        with pytest.raises(ValueError, match="state dict"):
            W.load_checkpoint(junk)


def test_load_checkpoint_safetensors(tmp_path):
    """The ``.safetensors`` reader, where the safetensors package is
    installed (neither machine is assumed to have it)."""
    st = pytest.importorskip("safetensors.numpy")
    from paddle_tpu_torch.utils.weights import load_checkpoint

    arrs = {"x": np.arange(6, dtype="float32").reshape(2, 3)}
    st.save_file(arrs, str(tmp_path / "w.safetensors"))
    np.testing.assert_array_equal(load_checkpoint(str(tmp_path / "w.safetensors"))["x"],
                                  arrs["x"])


@pytest.mark.parametrize("source", ["paddle", "torch", "auto"])
def test_load_pretrained_linear_matches_jax(tmp_path, source):
    """A paddle-layout (in, out) or torch-layout (out, in) checkpoint loads
    into the JAX Linear and into the port's Linear (paddle's layout, as
    JAX's) with equal outputs and JAX's weight."""
    rng = np.random.RandomState(2)
    w, b = rng.randn(4, 3).astype("float32"), rng.randn(3).astype("float32")
    sd = {"weight": w if source == "paddle" else w.T.copy(), "bias": b}
    path = _pickle(tmp_path / "lin.pdparams", sd)
    src = "torch" if source == "auto" else source
    jl = paddle.nn.Linear(4, 3)
    from paddle_tpu.utils.weights import load_pretrained as jload

    from paddle_tpu_torch.utils.weights import load_pretrained as tload

    jload(jl, path, source=src)
    tl = tload(T.nn.Linear(4, 3, device="cpu"), path, source=src)
    x = rng.randn(5, 4).astype("float32")
    np.testing.assert_allclose(_np(tl(torch.from_numpy(x))), _np(jl(paddle.to_tensor(x))),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(tl.weight.detach().numpy(), w)


def test_load_pretrained_llama_matches_jax_logits(tmp_path):
    """The JAX LLaMA's state dict, saved with the JAX ``paddle.save``, loaded
    into the port's LLaMA by ``load_pretrained``: logits equal the JAX
    model's at 1e-5, and a file with a missing key or a wrong shape raises
    with the names."""
    from paddle_tpu.models import LlamaConfig as JaxConfig
    from paddle_tpu.models import LlamaForCausalLM as JaxLlama
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.utils.weights import load_pretrained

    cfg = dict(vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
               num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=32)
    paddle.seed(0)
    jm = JaxLlama(JaxConfig(**cfg))
    jm.eval()
    path = str(tmp_path / "llama.pdparams")
    paddle.save(jm.state_dict(), path)
    tm = load_pretrained(LlamaForCausalLM(LlamaConfig(**cfg), device="cpu", seed=1), path)
    ids = np.random.RandomState(3).randint(0, 64, (2, 7)).astype("int64")
    ref = _np(jm(paddle.to_tensor(ids)))
    with torch.no_grad():
        got = tm(torch.from_numpy(ids))
    got = got[1] if isinstance(got, tuple) else got
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)

    sd = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    short = dict(sd)
    short.pop("llama.norm.weight")
    with pytest.raises(ValueError, match="missing=.*llama.norm.weight"):
        load_pretrained(tm, _pickle(tmp_path / "short.pdparams", short))
    wrong = dict(sd)
    wrong["lm_head.weight"] = wrong["lm_head.weight"].T.copy()
    with pytest.raises(ValueError, match="shape mismatch for lm_head.weight"):
        load_pretrained(tm, _pickle(tmp_path / "wrong.pdparams", wrong))
    load_pretrained(tm, _pickle(tmp_path / "short2.pdparams", short), strict=False)


def test_download_reads_the_cache_only(tmp_path, monkeypatch):
    from paddle_tpu.utils import download as JD
    from paddle_tpu_torch.utils import download as TD

    url = "https://example.invalid/models/w.pdparams"
    for D in (JD, TD):
        monkeypatch.setattr(D, "WEIGHTS_HOME", str(tmp_path / "weights"))
        with pytest.raises(RuntimeError, match="place the file at .*w.pdparams"):
            D.get_weights_path_from_url(url)
        with pytest.raises(RuntimeError, match="no network egress"):
            D.get_path_from_url(url, root_dir=str(tmp_path / "data"))
    (tmp_path / "weights" / "w.pdparams").write_bytes(b"x")
    (tmp_path / "data" / "w.pdparams").write_bytes(b"y")
    for D in (JD, TD):
        assert D.get_weights_path_from_url(url) == str(tmp_path / "weights" / "w.pdparams")
        assert D.get_path_from_url(url, root_dir=str(tmp_path / "data")) == \
            str(tmp_path / "data" / "w.pdparams")


def test_hub_local_roundtrip(tmp_path):
    (tmp_path / "hubconf.py").write_text(
        "def tiny_model(scale=1):\n"
        "    '''A tiny model.'''\n"
        "    import paddle_tpu_torch as paddle\n"
        "    return paddle.nn.Linear(2 * scale, 2, device='cpu')\n"
        "def _private():\n"
        "    pass\n"
        "NOT_CALLABLE = 3\n")
    assert T.hub.list(str(tmp_path), source="local") == ["tiny_model"]
    assert "tiny" in T.hub.help(str(tmp_path), "tiny_model", source="local")
    m = T.hub.load(str(tmp_path), "tiny_model", source="local", scale=2)
    assert tuple(m.weight.shape) == (4, 2)  # paddle's (in, out), as JAX's
    with pytest.raises(RuntimeError, match="no callable entrypoint"):
        T.hub.load(str(tmp_path), "NOT_CALLABLE", source="local")
    with pytest.raises(RuntimeError, match="network"):
        T.hub.list("user/repo", source="github")
    with pytest.raises(ValueError, match="unknown source"):
        T.hub.list(str(tmp_path), source="s3")
    with pytest.raises(FileNotFoundError):
        T.hub.list(str(tmp_path / "nothing"), source="local")


def test_hub_state_dict_from_cache_matches_jax(tmp_path):
    arr = np.random.RandomState(4).randn(2, 2).astype("float32")
    paddle.save({"w": paddle.to_tensor(arr)}, str(tmp_path / "sd.pdparams"))
    url = "https://example.invalid/x/sd.pdparams"
    j = paddle.hub.load_state_dict_from_url(url, model_dir=str(tmp_path))
    t = T.hub.load_state_dict_from_url(url, model_dir=str(tmp_path), map_location="cpu")
    np.testing.assert_array_equal(t["w"].numpy(), _np(j["w"]))
    t2 = T.hub.load_state_dict_from_url(url, model_dir=str(tmp_path), file_name="sd.pdparams",
                                        map_location="cpu")
    np.testing.assert_array_equal(t2["w"].numpy(), arr)
    for P in (paddle, T):
        with pytest.raises(RuntimeError, match="not cached"):
            P.hub.load_state_dict_from_url(url, model_dir=str(tmp_path), file_name="none.bin")
