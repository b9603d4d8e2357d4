"""paddle.save / paddle.load of the PyTorch port against the JAX package's.

One pickle format for both: a file either package writes loads in the other
bit for bit (fp32, bf16 as uint16 bits, int64, 0-d tensors, parameters with
their names, nested dicts, lists and tuples, Python scalars). A JAX LLaMA's
state dict crosses through the file and ``llama_from_numpy`` to the same
logits.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as pt
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch.framework import Parameter
from paddle_tpu_torch.models import LlamaConfig, llama_from_numpy

ROOT = Path(__file__).resolve().parents[1]


def _bits(a):
    """The bytes of an array or tensor (bf16 as its uint16 bits)."""
    if isinstance(a, torch.Tensor):
        a = a.detach()
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16).tobytes(), "bf16", tuple(a.shape)
        return a.numpy().tobytes(), str(a.numpy().dtype), tuple(a.shape)
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        return arr.view(np.uint16).tobytes(), "bf16", arr.shape
    return arr.tobytes(), str(arr.dtype), arr.shape


def _arrays():
    r = np.random.RandomState(0)
    return dict(w=r.randn(3, 4).astype("float32"), b16=r.randn(5).astype("float32"),
                ids=np.arange(6, dtype="int64").reshape(2, 3),
                scalar=np.float32(2.5), extra=r.randn(2).astype("float32"))


def _jax_payload():
    a = _arrays()
    lin = paddle.nn.Linear(2, 3)
    return {"w": paddle.to_tensor(a["w"]),
            "param": lin.weight,
            "nested": {"b16": paddle.to_tensor(a["b16"]).astype("bfloat16"),
                       "ids": paddle.to_tensor(a["ids"]),
                       "deeper": {"t": (paddle.to_tensor(a["extra"]), 4)}},
            "list": [paddle.to_tensor(a["scalar"]), 7, "name", 1.5, None],
            "raw": a["extra"], "step": 3}


def _port_payload():
    a = _arrays()
    return {"w": torch.from_numpy(a["w"]),
            "param": Parameter(torch.from_numpy(a["w"][:2].copy()), name="param_77"),
            "nested": {"b16": torch.from_numpy(a["b16"]).to(torch.bfloat16),
                       "ids": torch.from_numpy(a["ids"]),
                       "deeper": {"t": (torch.from_numpy(a["extra"]), 4)}},
            "list": [torch.tensor(a["scalar"]), 7, "name", 1.5, None],
            "raw": a["extra"], "step": 3}


def _leaves(obj, path=()):
    """(path, leaf) pairs in a fixed order."""
    if isinstance(obj, dict):
        for k in sorted(obj):
            yield from _leaves(obj[k], path + (k,))
    elif isinstance(obj, (list, tuple)):
        yield path + ("#" + type(obj).__name__,), len(obj)
        for i, v in enumerate(obj):
            yield from _leaves(v, path + (i,))
    else:
        yield path, obj


def _same(port_obj, jax_obj):
    """Every leaf of a port object equals the JAX object's, tensors bit for bit."""
    pl, jl = list(_leaves(port_obj)), list(_leaves(jax_obj))
    assert [p for p, _ in pl] == [p for p, _ in jl]
    for (path, a), (_, b) in zip(pl, jl):
        if isinstance(a, (torch.Tensor, np.ndarray)) or hasattr(b, "numpy"):
            bb = b.numpy() if hasattr(b, "numpy") and not isinstance(b, np.ndarray) else b
            assert _bits(a) == _bits(bb), path
        else:
            assert a == b, path


class TestAcrossPackages:
    def test_jax_writes_port_reads_bit_for_bit(self, tmp_path):
        path = str(tmp_path / "jax.pdparams")
        src = _jax_payload()
        paddle.save(src, path)
        got = pt.load(path, device="cpu")
        _same(got, src)
        assert isinstance(got["list"], list) and isinstance(got["nested"]["deeper"]["t"], tuple)
        assert got["nested"]["b16"].dtype == torch.bfloat16
        assert got["nested"]["ids"].dtype == torch.int64
        assert got["list"][0].shape == () and got["step"] == 3
        # a JAX parameter comes back a named, trainable Parameter; a tensor
        # with stop_gradient=True without grad
        assert isinstance(got["param"], Parameter) and got["param"].name == src["param"].name
        assert got["param"].requires_grad and not got["w"].requires_grad

    def test_port_writes_jax_reads_bit_for_bit(self, tmp_path):
        path = str(tmp_path / "port.pdparams")
        src = _port_payload()
        pt.save(src, path)
        got = paddle.load(path)
        _same(src, got)
        assert str(got["nested"]["b16"].dtype) == "bfloat16"
        assert isinstance(got["param"], paddle.framework.core.Parameter)
        assert got["param"].name == "param_77" and not got["param"].stop_gradient
        assert got["w"].stop_gradient

    def test_round_trip_through_both(self, tmp_path):
        """JAX -> port -> JAX: the file the port writes back holds the same
        bits, names and flags the JAX file held."""
        a, b = str(tmp_path / "a.pdparams"), str(tmp_path / "b.pdparams")
        paddle.save(_jax_payload(), a)
        pt.save(pt.load(a, device="cpu"), b)
        ja, jb = paddle.load(a, return_numpy=True), paddle.load(b, return_numpy=True)
        pl, jl = list(_leaves(jb)), list(_leaves(ja))
        assert [p for p, _ in pl] == [p for p, _ in jl]
        for (path, x), (_, y) in zip(pl, jl):
            if isinstance(x, np.ndarray):
                assert _bits(x) == _bits(y), path
            else:
                assert x == y, path
        import pickle

        with open(a, "rb") as f:
            raw_a = pickle.load(f)
        with open(b, "rb") as f:
            raw_b = pickle.load(f)
        assert raw_a["param"]["name"] == raw_b["param"]["name"]
        assert raw_a["nested"]["b16"]["dtype"] == raw_b["nested"]["b16"]["dtype"]

    def test_return_numpy_matches_jax(self, tmp_path):
        path = str(tmp_path / "jax.pdparams")
        paddle.save(_jax_payload(), path)
        got = pt.load(path, return_numpy=True)
        ref = paddle.load(path, return_numpy=True)
        for (p, x), (_, y) in zip(_leaves(got), _leaves(ref)):
            if isinstance(y, np.ndarray) and y.dtype.name == "bfloat16":
                # numpy has no bfloat16 without ml_dtypes: float32, same values
                assert x.dtype == np.float32
                assert _bits(x) == _bits(y.astype(np.float32)), p
            elif isinstance(y, np.ndarray):
                assert _bits(x) == _bits(y), p
            else:
                assert x == y, p

    def test_llama_state_dict_crosses_to_equal_logits(self, tmp_path):
        paddle.seed(0)
        kw = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
                  num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                  max_position_embeddings=32)
        jm = JaxLlama(JaxConfig(**kw))
        jm.eval()
        path = str(tmp_path / "llama.pdparams")
        paddle.save(jm.state_dict(), path)
        state = pt.load(path, return_numpy=True)
        tm = llama_from_numpy(state, LlamaConfig(**kw), device="cpu")
        ids = np.random.RandomState(1).randint(0, 64, (2, 7)).astype("int64")
        ref = np.asarray(jm(paddle.to_tensor(ids)).numpy())
        with torch.no_grad():
            got = tm(torch.from_numpy(ids)).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)
        # and the tensor form of the same file, through the port's own save
        tensors = pt.load(path, device="cpu")
        assert all(isinstance(v, Parameter) for v in tensors.values())
        again = str(tmp_path / "again.pdparams")
        pt.save(tensors, again)
        back = paddle.load(again, return_numpy=True)
        assert all(_bits(back[k]) == _bits(state[k]) for k in state)


class TestDevice:
    def test_tensors_go_to_the_card_by_default(self, tmp_path, monkeypatch):
        path = str(tmp_path / "p.pdparams")
        pt.save({"w": torch.ones(2), "n": 1}, path)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no card"):
            pt.load(path)
        # numpy needs no device
        assert pt.load(path, return_numpy=True)["n"] == 1

    def test_file_without_tensors_needs_no_card(self, tmp_path, monkeypatch):
        path = str(tmp_path / "p.pdparams")
        pt.save({"epoch": 3, "lr": [0.1, 0.01]}, path)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        assert pt.load(path) == {"epoch": 3, "lr": [0.1, 0.01]}


def test_bf16_without_ml_dtypes(tmp_path):
    """In an interpreter where ml_dtypes cannot be imported, the port reads
    the JAX package's bf16 file and writes one back, and saves and reloads a
    bf16 program."""
    src = str(tmp_path / "jax.pdparams")
    vals = np.random.RandomState(5).randn(9).astype("float32")
    paddle.save({"b": paddle.to_tensor(vals).astype("bfloat16")}, src)
    code = (
        "import sys; sys.modules['ml_dtypes'] = None\n"
        "import numpy as np, torch, paddle_tpu_torch as pt\n"
        "from paddle_tpu_torch import jit, inference\n"
        f"d = pt.load({src!r}, device='cpu')\n"
        f"pt.save(d, {str(tmp_path / 'port.pdparams')!r})\n"
        "lin = torch.nn.Linear(4, 4).to(torch.bfloat16)\n"
        f"jit.save(lin, {str(tmp_path / 'lin')!r}, "
        "input_spec=[jit.InputSpec([2, 4], 'bfloat16')])\n"
        f"out = jit.load({str(tmp_path / 'lin')!r}, device='cpu')(torch.ones(2, 4, "
        "dtype=torch.bfloat16))\n"
        "assert torch.equal(out, lin(torch.ones(2, 4, dtype=torch.bfloat16)))\n"
        "print(d['b'].dtype, 'ml_dtypes' in sys.modules and sys.modules['ml_dtypes'] is not None)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "torch.bfloat16 False"
    back = paddle.load(str(tmp_path / "port.pdparams"))
    assert _bits(back["b"].numpy()) == _bits(paddle.load(src)["b"].numpy())
