"""jit.save / jit.load / TranslatedLayer of the PyTorch port against the JAX
package's (``tests/test_jit.py``'s serialization cases, ported).

The same numpy weights and inputs go through ``paddle_tpu.jit.save`` ->
``load`` and ``paddle_tpu_torch.jit.save`` -> ``load`` (the port exports on
the CPU, where it runs the plain versions). Also: the artifact's version
contract and fixture, dynamic batch, the 2-layer LLaMA at a static shape, the
kernel op kept in a saved program and found again in a fresh interpreter,
and the refusals (a JAX artifact, another device, a missing extension op, a
dim the trace would fix).
"""
import importlib
import os
import pickle
import subprocess
import sys
import tempfile
import zipfile
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch import jit
from paddle_tpu_torch.jit import InputSpec
from paddle_tpu_torch.jit.serialization import FORMAT_VERSION
from paddle_tpu_torch.models import LlamaConfig, llama_from_numpy

ROOT = Path(__file__).resolve().parents[1]
FIXTURE = ROOT / "tests" / "fixtures" / "torch_jit_save_v1"
port_F = importlib.import_module("paddle_tpu_torch.nn.functional.flash_attention")


class JaxSmallNet(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.fc1 = jnn.Linear(4, 8)
        self.fc2 = jnn.Linear(8, 2)

    def forward(self, x):
        return self.fc2(paddle.nn.functional.relu(self.fc1(x)))


class SmallNet(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.fc1 = torch.nn.Linear(4, 8)
        self.fc2 = torch.nn.Linear(8, 2)

    def forward(self, x):
        return self.fc2(torch.relu(self.fc1(x)))


def _pair(seed=0):
    """(JAX SmallNet, port SmallNet) with the same weights (paddle's Linear
    weight is (in, out), torch's (out, in))."""
    paddle.seed(seed)
    jm = JaxSmallNet()
    jm.eval()
    tm = SmallNet().eval()
    with torch.no_grad():
        for name in ("fc1", "fc2"):
            jl, tl = getattr(jm, name), getattr(tm, name)
            tl.weight.copy_(torch.from_numpy(np.asarray(jl.weight.numpy()).T.copy()))
            tl.bias.copy_(torch.from_numpy(np.array(jl.bias.numpy())))
    return jm, tm


def _x(batch, seed=0):
    return np.random.RandomState(seed).randn(batch, 4).astype(np.float32)


def _meta(path):
    with open(path + ".pdiparams", "rb") as f:
        return pickle.load(f)


def _write_meta(path, meta):
    with open(path + ".pdiparams", "wb") as f:
        pickle.dump(meta, f)


def _jax_saved(jm, path, spec):
    paddle.jit.save(jm, path, input_spec=[paddle.jit.InputSpec(spec, "float32")])
    return paddle.jit.load(path)


def test_jit_save_load(tmp_path):
    """tests/test_jit.py::test_jit_save_load on both packages: each loaded
    program equals its eager net, and the two loaded programs agree."""
    jm, tm = _pair()
    xn = _x(2)
    jl = _jax_saved(jm, str(tmp_path / "jax"), [2, 4])
    jit.save(tm, str(tmp_path / "port"), input_spec=[InputSpec([2, 4], "float32")])
    loaded = jit.load(str(tmp_path / "port"), device="cpu")
    out = loaded(torch.from_numpy(xn))
    assert isinstance(loaded, torch.nn.Module) and isinstance(out, torch.Tensor)
    assert out.requires_grad is False
    np.testing.assert_allclose(out.numpy(), tm(torch.from_numpy(xn)).detach().numpy(),
                               rtol=1e-5)
    np.testing.assert_allclose(out.numpy(), jl(paddle.to_tensor(xn)).numpy(), rtol=1e-5)
    # numpy inputs too
    np.testing.assert_array_equal(loaded(xn).numpy(), out.numpy())


class TestSerializationVersioning:
    """tests/test_jit.py::TestSerializationVersioning on the port."""

    def test_save_embeds_version_fields(self, tmp_path):
        _, tm = _pair()
        path = str(tmp_path / "model")
        jit.save(tm, path, input_spec=[InputSpec([2, 4], "float32")])
        meta = _meta(path)
        assert meta["format_version"] == FORMAT_VERSION == 1
        assert len(meta["op_registry_hash"]) == 16
        assert meta["producer"] == "paddle_tpu_torch"
        assert meta["platform"] == "cpu"
        assert meta["state_names"] == ["P:fc1.weight", "P:fc1.bias", "P:fc2.weight",
                                       "P:fc2.bias"]
        assert meta["input_names"] == ["input_0"]
        for n, p in zip(meta["state_names"], tm.parameters()):
            np.testing.assert_array_equal(meta["state"][n], p.detach().numpy())

    def test_keys_equal_the_jax_artifacts(self, tmp_path):
        """The port's .pdiparams holds every key the JAX package writes."""
        jm, tm = _pair()
        jax_path, port_path = str(tmp_path / "jax"), str(tmp_path / "port")
        _jax_saved(jm, jax_path, [2, 4])
        jit.save(tm, port_path, input_spec=[InputSpec([2, 4], "float32")])
        jax_meta, port_meta = _meta(jax_path), _meta(port_path)
        assert set(jax_meta) <= set(port_meta)
        assert port_meta["op_registry_hash"] == jax_meta["op_registry_hash"]
        assert port_meta["input_names"] == jax_meta["input_names"]

    def test_newer_version_refused_with_clear_error(self, tmp_path):
        _, tm = _pair()
        path = str(tmp_path / "model")
        jit.save(tm, path, input_spec=[InputSpec([2, 4], "float32")])
        meta = _meta(path)
        meta["format_version"] = 999
        _write_meta(path, meta)
        with pytest.raises(RuntimeError, match="format version 999"):
            jit.load(path, device="cpu")

    def test_pre_versioning_artifact_accepted(self, tmp_path):
        """An artifact without the version fields is read as v0."""
        _, tm = _pair()
        xn = _x(2)
        ref = tm(torch.from_numpy(xn)).detach().numpy()
        path = str(tmp_path / "model")
        jit.save(tm, path, input_spec=[InputSpec([2, 4], "float32")])
        meta = _meta(path)
        for k in ("format_version", "op_registry_hash", "producer", "platform"):
            meta.pop(k)
        _write_meta(path, meta)
        out = jit.load(path, device="cpu")(torch.from_numpy(xn)).numpy()
        np.testing.assert_allclose(out, ref, rtol=1e-5)
        # without "platform" the program's own inputs say where it runs
        with pytest.raises(RuntimeError, match="exported for cpu"):
            jit.load(path, device="cuda")

    def test_v1_fixture_still_loads(self):
        """Back-compat pin: the committed v1 artifact opens and reproduces its
        golden outputs. The .pdmodel payload is torch.export's archive, whose
        readability across torch versions is torch's contract, not ours (as
        StableHLO's is jaxlib's in tests/test_jit.py): if torch cannot
        deserialize the committed blob, a fresh v1 artifact is written and
        our format contract (save -> v1 metadata -> load -> golden) is pinned
        on it instead. Any other failure fails."""
        path = str(FIXTURE / "model")
        data = np.load(FIXTURE / "golden.npz")
        assert _meta(path)["format_version"] == 1
        try:
            out = jit.load(path, device="cpu")(data["x"]).numpy()
        except RuntimeError as e:
            if "deserialize" not in str(e).lower():
                raise
            with tempfile.TemporaryDirectory() as td:
                net, x, golden = _fixture_net()
                p = os.path.join(td, "model")
                jit.save(net, p, input_spec=[InputSpec([2, 4], "float32")])
                assert _meta(p)["format_version"] == 1
                out = jit.load(p, device="cpu")(x).numpy()
                np.testing.assert_allclose(out, golden, rtol=1e-5, atol=1e-6)
            return
        np.testing.assert_allclose(out, data["y"], rtol=1e-5, atol=1e-6)


def _fixture_net():
    """The fixture's 2x4 net (4 -> 3 -> 2), its input and its output."""
    torch.manual_seed(3)
    net = torch.nn.Sequential(torch.nn.Linear(4, 3), torch.nn.Tanh(),
                              torch.nn.Linear(3, 2)).eval()
    x = np.random.RandomState(3).randn(2, 4).astype("float32")
    return net, x, net(torch.from_numpy(x)).detach().numpy()


def write_fixture(directory=FIXTURE):
    """Writes tests/fixtures/torch_jit_save_v1 (model.pdmodel,
    model.pdiparams, golden.npz): ``python -c "import tests.test_torch_jit_save
    as t; t.write_fixture()"`` from the repository root."""
    os.makedirs(directory, exist_ok=True)
    net, x, y = _fixture_net()
    jit.save(net, os.path.join(directory, "model"), input_spec=[InputSpec([2, 4], "float32")])
    np.savez(os.path.join(directory, "golden.npz"), x=x, y=y)


class TestDynamicDims:
    def test_dynamic_batch_at_three_sizes(self, tmp_path):
        """InputSpec([None, 4]): one artifact runs batch 1, 3 and 6, equal
        to the JAX package's loaded program at each."""
        jm, tm = _pair(seed=1)
        jl = _jax_saved(jm, str(tmp_path / "jax"), [None, 4])
        jit.save(tm, str(tmp_path / "port"), input_spec=[InputSpec([None, 4], "float32")])
        loaded = jit.load(str(tmp_path / "port"), device="cpu")
        for b in (1, 3, 6):
            xn = _x(b, seed=b)
            out = loaded(xn).numpy()
            assert out.shape == (b, 2)
            np.testing.assert_allclose(out, jl(paddle.to_tensor(xn)).numpy(), rtol=1e-5,
                                       atol=1e-6)

    @pytest.mark.parametrize("dim", [None, -1])
    def test_dim_the_trace_fixes_raises(self, tmp_path, dim):
        """A forward that branches on its batch size would run one shape:
        save raises instead of writing it."""
        class Branchy(torch.nn.Module):
            def forward(self, x):
                return x * 2 if x.shape[0] > 3 else x

        path = str(tmp_path / "m")
        with pytest.raises(Exception, match="dyn1"):
            jit.save(Branchy(), path, input_spec=[InputSpec([dim, 4], "float32")],
                     device="cpu")
        assert not os.path.exists(path + ".pdmodel")

    def test_static_spec_refuses_another_shape(self, tmp_path):
        _, tm = _pair()
        jit.save(tm, str(tmp_path / "m"), input_spec=[InputSpec([2, 4], "float32")])
        with pytest.raises(Exception):
            jit.load(str(tmp_path / "m"), device="cpu")(_x(3))


def _llama_pair(kv=2, hidden=32):
    kw = dict(vocab_size=64, hidden_size=hidden, intermediate_size=64,
              num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=kv,
              max_position_embeddings=32)
    paddle.seed(0)
    jm = JaxLlama(JaxConfig(**kw))
    jm.eval()
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    return jm, llama_from_numpy(state, LlamaConfig(**kw), device="cpu")


class TestLlama:
    def test_static_shape_against_jax(self, tmp_path):
        """The 2-layer LLaMA saved at (2, 7) by both packages: the loaded
        programs' logits agree (test_torch_llama.py's tolerance), and the
        port's loaded program equals its eager model."""
        jm, tm = _llama_pair()
        ids = np.random.RandomState(4).randint(0, 64, (2, 7)).astype("int64")
        paddle.jit.save(jm, str(tmp_path / "jax"),
                        input_spec=[paddle.jit.InputSpec([2, 7], "int64")])
        ref = np.asarray(paddle.jit.load(str(tmp_path / "jax"))(paddle.to_tensor(ids)).numpy())
        jit.save(tm, str(tmp_path / "port"), input_spec=[InputSpec([2, 7], "int64", "ids")])
        loaded = jit.load(str(tmp_path / "port"), device="cpu")
        out = loaded(ids).numpy()
        np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)
        with torch.no_grad():
            eager = tm(torch.from_numpy(ids)).numpy()
        np.testing.assert_allclose(out, eager, rtol=1e-6, atol=1e-6)
        assert loaded._input_names == ["ids"]
        # every node the program computes gives tensors (or nothing, as an
        # assertion): the trace's dtype arithmetic (aten.promote_types, a
        # dtype), which Dynamo cannot compile, is not kept
        for node in loaded._program.graph.nodes:
            if node.op == "call_function":
                vals = node.meta.get("val")
                vals = vals if isinstance(vals, (tuple, list)) else [vals]
                assert all(v is None or isinstance(v, torch.Tensor) for v in vals), node.target

    def test_weights_stored_once(self, tmp_path):
        """The program holds no weight and no example input: the weights are
        only in .pdiparams."""
        _, tm = _llama_pair(hidden=64)
        path = str(tmp_path / "m")
        jit.save(tm, path, input_spec=[InputSpec([2, 7], "int64")])
        n_bytes = sum(p.numel() * p.element_size() for p in tm.parameters())
        with zipfile.ZipFile(path + ".pdmodel") as z:
            sizes = {i.filename: i.file_size for i in z.infolist()}
        weights = sum(s for n, s in sizes.items() if "/data/weights/" in n
                      or "/data/constants/" in n or "sample_inputs" in n)
        assert weights < 4096, sizes
        meta = _meta(path)
        assert sum(v.nbytes for v in meta["state"].values()) == n_bytes
        program = jit.load(path, device="cpu")._program
        assert program.state_dict == {} and program.constants == {}

    def test_kernel_op_kept_and_found_in_a_fresh_interpreter(self, tmp_path, monkeypatch):
        """On the card the attention path is the kernel op; here the CPU is
        made to take it at 4 rows and more: the saved graph holds one
        ``paddle_tpu_torch::flash_attention_fwd`` a layer and no softmax, and
        an interpreter that imports only ``paddle_tpu_torch.jit`` loads it and
        gives the eager logits."""
        _, tm = _llama_pair()
        monkeypatch.setattr(port_F, "_use_kernel", lambda q: q.shape[1] >= 4)
        path = str(tmp_path / "m")
        jit.save(tm, path, input_spec=[InputSpec([2, 8], "int64")])
        ids = np.random.RandomState(2).randint(0, 64, (2, 8)).astype("int64")
        with torch.no_grad():
            eager = tm(torch.from_numpy(ids)).numpy()
        np.save(tmp_path / "ids.npy", ids)
        code = (
            "import sys, numpy as np\n"
            "from paddle_tpu_torch import jit\n"
            f"m = jit.load({path!r}, device='cpu')\n"
            "targets = [str(n.target) for n in m._program.graph.nodes if n.op == 'call_function']\n"
            "print(sum(t.startswith('paddle_tpu_torch.flash_attention_fwd') for t in targets),\n"
            "      sum('softmax' in t for t in targets))\n"
            f"np.save({str(tmp_path / 'out.npy')!r}, m(np.load({str(tmp_path / 'ids.npy')!r})).numpy())\n")
        out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                             env=dict(os.environ, PYTHONPATH=str(ROOT)),
                             capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr[-3000:]
        assert out.stdout.split() == ["2", "0"]
        np.testing.assert_allclose(np.load(tmp_path / "out.npy"), eager, rtol=1e-6, atol=1e-6)


class TestRefusals:
    def test_jax_artifact_refused_naming_its_producer(self, tmp_path):
        jm, _ = _pair()
        path = str(tmp_path / "jax")
        _jax_saved(jm, path, [2, 4])
        with pytest.raises(RuntimeError, match="producer 'paddle_tpu'"):
            jit.load(path, device="cpu")
        # a pre-versioning JAX artifact has no producer: its StableHLO is
        # refused all the same
        meta = _meta(path)
        for k in ("format_version", "op_registry_hash", "producer"):
            meta.pop(k)
        _write_meta(path, meta)
        with pytest.raises(RuntimeError, match="not a torch.export archive"):
            jit.load(path, device="cpu")

    def test_cpu_program_refused_on_the_card(self, tmp_path):
        _, tm = _pair()
        path = str(tmp_path / "m")
        jit.save(tm, path, input_spec=[InputSpec([2, 4], "float32")])
        with pytest.raises(RuntimeError, match="exported for cpu"):
            jit.load(path, device="cuda")

    def test_default_device_is_the_card(self, tmp_path, monkeypatch):
        _, tm = _pair()
        path = str(tmp_path / "m")
        jit.save(tm, path, input_spec=[InputSpec([2, 4], "float32")])
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no card"):
            jit.load(path)

    def test_missing_spec_raises(self, tmp_path):
        _, tm = _pair()
        with pytest.raises(ValueError, match="requires input_spec"):
            jit.save(tm, str(tmp_path / "m"))

    def test_to_static_spec_used_without_one(self, tmp_path):
        _, tm = _pair()
        jit.to_static(tm, input_spec=[InputSpec([None, 4], "float32", "feats")])
        tm.train()
        path = str(tmp_path / "m")
        jit.save(tm, path)
        assert tm.training and all(m.training for m in tm.modules())
        assert _meta(path)["input_names"] == ["feats"]
        xn = _x(3)
        ref = tm._orig_forward(torch.from_numpy(xn)).detach().numpy()
        np.testing.assert_allclose(jit.load(path, device="cpu")(xn).numpy(), ref, rtol=1e-6)

    def test_registry_hash_equals_jax(self):
        from paddle_tpu.jit.serialization import _op_registry_hash as jax_hash
        from paddle_tpu_torch.jit.serialization import _op_registry_hash

        assert _op_registry_hash() == jax_hash()


class TestStateAndOutputs:
    def test_buffers_eval_mode_and_outputs(self, tmp_path):
        """BatchNorm's running statistics are "B:" state and the program is
        the eval forward; several outputs come back as a tuple."""
        class Net(torch.nn.Module):
            def __init__(self):
                super().__init__()
                self.lin = torch.nn.Linear(4, 3)
                self.bn = torch.nn.BatchNorm1d(3)

            def forward(self, x):
                h = self.bn(self.lin(x))
                return {"h": h, "s": h.sum(-1)}

        torch.manual_seed(0)
        net = Net()
        net.train()
        for _ in range(3):
            net(torch.randn(8, 4))
        path = str(tmp_path / "m")
        jit.save(net, path, input_spec=[InputSpec([None, 4], "float32")])
        assert net.training
        meta = _meta(path)
        assert "B:bn.running_mean" in meta["state_names"]
        assert "B:bn.num_batches_tracked" in meta["state_names"]
        net.eval()
        xn = _x(5)
        ref = net(torch.from_numpy(xn))
        out = jit.load(path, device="cpu")(xn)
        assert isinstance(out, tuple) and len(out) == 2
        np.testing.assert_allclose(out[0].numpy(), ref["h"].detach().numpy(), rtol=1e-6)
        np.testing.assert_allclose(out[1].numpy(), ref["s"].detach().numpy(), rtol=1e-6)

    def test_bf16_state_stored_as_uint16_bits(self, tmp_path):
        lin = torch.nn.Linear(4, 4).to(torch.bfloat16)
        path = str(tmp_path / "m")
        jit.save(lin, path, input_spec=[InputSpec([2, 4], "bfloat16")])
        w = _meta(path)["state"]["P:weight"]
        assert w["dtype"] == "__bf16_as_uint16__" and w["data"].dtype == np.uint16
        np.testing.assert_array_equal(
            w["data"], lin.weight.detach().view(torch.int16).numpy().view(np.uint16))
        x = torch.randn(2, 4).to(torch.bfloat16)
        assert torch.equal(jit.load(path, device="cpu")(x), lin(x))


AXPY_CODE = """
import sys, numpy as np, torch
from paddle_tpu_torch import jit
f = jit.load({path!r}, device="cpu")
targets = [str(n.target) for n in f._program.graph.nodes if n.op == "call_function"]
x = torch.from_numpy(np.load({x!r}))
y = f(x)
assert torch.equal(y, x * 2.0 + 1.0), (y, x)
print(targets.count("paddle_tpu_torch.axpy.default"))
"""


def test_saved_axpy_function_reloads_in_a_fresh_interpreter(tmp_path):
    """A function that calls the registered axpy op, saved and reloaded where
    only ``paddle_tpu_torch.jit`` is imported: the graph calls the op and the
    result is 2x + 1 bit for bit."""
    from paddle_tpu_torch.ops.cuda import axpy

    op = axpy.register_example(name="torch_test_jit_save_axpy")
    path = str(tmp_path / "axpy")
    jit.save(lambda x: op(x), path, input_spec=[InputSpec([None], "float32")], device="cpu")
    x = np.random.RandomState(0).randn(1000).astype("float32")
    np.save(tmp_path / "x.npy", x)
    out = subprocess.run([sys.executable, "-c", AXPY_CODE.format(path=path,
                                                                 x=str(tmp_path / "x.npy"))],
                         cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT)),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split() == ["1"]


CPP_SRC = r"""
#include <cstdint>
extern "C" void torch_jit_twice(const float* x, float* y, int64_t n) {
  for (int64_t i = 0; i < n; ++i) y[i] = 2.0f * x[i];
}
"""

EXT_CODE = """
import torch
from paddle_tpu_torch import jit
try:
    jit.load({path!r}, device="cpu")
except RuntimeError as e:
    print("refused:", e)
from paddle_tpu_torch.utils import cpp_extension
ext = cpp_extension.load("torch_jit_twice_ext", [{src!r}], build_directory={build!r})
ext.def_op("torch_jit_twice_op", symbol="torch_jit_twice")
f = jit.load({path!r}, device="cpu")
print(f(torch.arange(4.0)).tolist())
"""


def test_missing_extension_op_named(tmp_path):
    """A program that calls a cpp_extension op loads only once the extension
    is: before that, load names the op it cannot find."""
    import shutil

    if not (shutil.which("c++") or shutil.which("g++")):
        pytest.skip("needs a C++ compiler")
    from paddle_tpu_torch.utils import cpp_extension

    src = tmp_path / "twice.cc"
    src.write_text(CPP_SRC)
    build = str(tmp_path / "build")
    ext = cpp_extension.load("torch_jit_twice_ext", [str(src)], build_directory=build)
    op = ext.def_op("torch_jit_twice_op", symbol="torch_jit_twice")
    path = str(tmp_path / "ext")
    jit.save(lambda x: op(x) + 1.0, path, input_spec=[InputSpec([4], "float32")],
             device="cpu")
    code = EXT_CODE.format(path=path, src=str(src), build=build)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=str(ROOT)),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert lines[0].startswith("refused:")
    assert "paddle_tpu_torch_ext::torch_jit_twice_op" in lines[0]
    assert lines[-1] == "[1.0, 3.0, 5.0, 7.0]"
