"""Rules the PyTorch port keeps: no JAX, no paddle_tpu and no bench_common
inside it, no quiet CPU or eager fallback, and its kernel sources in the repo
with the build git-ignored."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "paddle_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "paddle_tpu", "bench_common")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_paddle_tpu_import(path):
    bad = [m for m in _imported_roots(path) if m.split(".")[0] in FORBIDDEN]
    assert bad == [], f"{path.relative_to(ROOT)} imports {bad}"


def test_import_leaves_jax_and_paddle_tpu_unloaded():
    code = ("import sys, paddle_tpu_torch, paddle_tpu_torch.models, "
            "paddle_tpu_torch.ops.cuda.flash_attention, paddle_tpu_torch.nn.functional, "
            "paddle_tpu_torch.optimizer, paddle_tpu_torch.distributed.fleet, "
            "paddle_tpu_torch.utils, paddle_tpu_torch.ops.cuda.axpy, "
            "paddle_tpu_torch.serving, paddle_tpu_torch.analysis, "
            "paddle_tpu_torch.distributed.watchdog, paddle_tpu_torch.checkpoint, "
            "paddle_tpu_torch.optimizer.lr, paddle_tpu_torch.nn.clip, "
            "paddle_tpu_torch.incubate, paddle_tpu_torch.incubate.nn.functional, "
            "paddle_tpu_torch.jit, paddle_tpu_torch.jit.serialization, "
            "paddle_tpu_torch.inference, paddle_tpu_torch.framework_io, "
            "paddle_tpu_torch.monitor, paddle_tpu_torch.monitor.server, "
            "paddle_tpu_torch.analysis.sanitizers, paddle_tpu_torch.analysis.numerics; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}))")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_default_device_raises_without_cuda(monkeypatch):
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = LlamaConfig(vocab_size=16, hidden_size=16, intermediate_size=32,
                      num_hidden_layers=1, num_attention_heads=2)
    with pytest.raises(RuntimeError, match="no card"):
        LlamaForCausalLM(cfg)
    assert LlamaForCausalLM(cfg, device="cpu").device.type == "cpu"


def test_cuda_tensor_never_takes_the_plain_version(monkeypatch):
    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    def launched(*a):
        raise RuntimeError("kernel launch")

    def plain(*a):
        raise AssertionError("plain version taken for a CUDA tensor")

    monkeypatch.setattr(fa, "_launch", launched)
    monkeypatch.setattr(fa, "flash_attention_fwd_plain", plain)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    q = torch.zeros(1, 4, 2, 64)
    with pytest.raises(RuntimeError, match="kernel launch"):
        fa.flash_attention_fwd(q, q, q, causal=True)


def test_cuda_backward_never_takes_the_plain_version(monkeypatch):
    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    def launched(*a):
        raise RuntimeError("kernel launch")

    def plain(*a):
        raise AssertionError("plain version taken for a CUDA tensor")

    monkeypatch.setattr(fa, "_launch_bwd_dq", launched)
    monkeypatch.setattr(fa, "flash_attention_bwd_plain", plain)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    q = torch.zeros(1, 4, 2, 64)
    lse = torch.zeros(1, 2, 4)
    with pytest.raises(RuntimeError, match="kernel launch"):
        fa.flash_attention_bwd(q, q, q, q, lse, q, causal=True)


def test_axpy_on_cuda_never_takes_the_plain_version(monkeypatch):
    from paddle_tpu_torch.ops.cuda import axpy

    def launched(*a):
        raise RuntimeError("kernel launch")

    def plain(*a):
        raise AssertionError("plain version taken for a CUDA tensor")

    monkeypatch.setattr(axpy, "_launch", launched)
    monkeypatch.setattr(axpy, "axpy_plain", plain)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    with pytest.raises(RuntimeError, match="kernel launch"):
        axpy.axpy(torch.zeros(8))
    op = axpy.register_example(name="torch_test_hygiene_axpy")
    with pytest.raises(RuntimeError, match="kernel launch"):
        op(torch.zeros(8, requires_grad=True))


def test_serving_programs_on_cuda_capture_or_raise():
    """On a CUDA device a serving program is captured as a CUDA graph or the
    call raises: it never runs its function eagerly instead."""
    from paddle_tpu_torch.models import serving

    class OnCard:
        device = torch.device("cuda", 0)

    calls = []
    prog = serving._Program(lambda *a: calls.append(a), pools=[(OnCard(),)])
    with pytest.raises(Exception):
        prog(torch.zeros(2, dtype=torch.int32), torch.zeros(2))
    assert calls == [] and not prog.captured
    on_cpu = serving._Program(lambda *a: calls.append(a), pools=[(torch.zeros(2),)])
    on_cpu(torch.zeros(2, dtype=torch.int32), torch.zeros(2))
    assert len(calls) == 1 and not on_cpu.captured


def test_decode_programs_on_cuda_capture_or_raise(monkeypatch):
    """The decode engine's prompt pass and decode step on a CUDA device are
    captured as CUDA graphs or the call raises: neither function runs
    eagerly instead."""
    from paddle_tpu_torch.jit import _cuda_graph
    from paddle_tpu_torch.models import LlamaConfig, LlamaDecodeEngine, LlamaForCausalLM
    from paddle_tpu_torch.models import llama_decode

    class OnCard(_cuda_graph._Program):
        def __init__(self, fn, pools, pool=None):
            super().__init__(fn, pools, pool)
            self._device = torch.device("cuda", 0)

    cfg = LlamaConfig(vocab_size=16, hidden_size=16, intermediate_size=32,
                      num_hidden_layers=1, num_attention_heads=2)
    engine = LlamaDecodeEngine(LlamaForCausalLM(cfg, device="cpu"), max_len=8)
    ids = torch.zeros(1, 3, dtype=torch.long)
    _, cache, pos = engine.prefill(ids)          # CPU programs: eager
    calls = []
    for name in ("_prefill_dense", "_step_dense"):
        monkeypatch.setattr(engine, name, lambda *a, _n=name: calls.append(_n))
    monkeypatch.setattr(llama_decode, "_Program", OnCard)
    with pytest.raises(Exception):
        engine.decode_step(torch.zeros(1, 1, dtype=torch.long), cache, pos)
    with pytest.raises(Exception):
        engine.prefill(torch.zeros(1, 4, dtype=torch.long))
    assert calls == []
    assert not cache._slot.programs["step"].captured


def test_kernel_source_present_and_build_ignored():
    assert (PORT / "csrc" / "flash_attention_fwd.cu").is_file()
    assert (PORT / "csrc" / "flash_attention_bwd.cu").is_file()
    ignored = (ROOT / ".gitignore").read_text().split()
    assert "paddle_tpu_torch/_build/" in ignored


def _not_ported_raises():
    """(file, line, message) of every ``raise NotImplementedError(...)`` in
    the port whose message says a part is not ported (or belongs to another
    slice)."""
    out = []
    for path in sorted(PORT.rglob("*.py")):
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Raise) and isinstance(node.exc, ast.Call)
                    and getattr(node.exc.func, "id", None) == "NotImplementedError"):
                continue
            text = " ".join(c.value for c in ast.walk(node.exc)
                            if isinstance(c, ast.Constant) and isinstance(c.value, str))
            names = {n.id for n in ast.walk(node.exc) if isinstance(n, ast.Name)}
            if "not ported" in text or "slice" in text or names & {"where"}:
                out.append((str(path.relative_to(ROOT)), node.lineno, text, names))
    return out


def test_every_unported_raise_names_its_roadmap_item():
    """A part that is not ported says where its work sits in ROADMAP.md
    (Queue A item N), directly or through the constant it formats in."""
    sites = _not_ported_raises()
    # llama's tensor-parallel raise and monitor.timeline's two modeled_* raises
    assert len(sites) >= 3, sites
    consts = {"where": "Queue A item 10"}  # llama._check_supported's _PARALLEL_SLICE
    from paddle_tpu_torch.models import llama

    assert "Queue A item 10" in llama._PARALLEL_SLICE
    for path, line, text, names in sites:
        named = "Queue A item" in text or any(n in consts for n in names)
        assert named, f"{path}:{line} raises NotImplementedError without a ROADMAP item"


@pytest.mark.parametrize("call,item", [
    (lambda: __import__("paddle_tpu_torch.models", fromlist=["x"]).LlamaForCausalLM(
        __import__("paddle_tpu_torch.models", fromlist=["x"]).LlamaConfig(
            vocab_size=16, hidden_size=16, intermediate_size=32, num_hidden_layers=1,
            num_attention_heads=2, tensor_parallel_degree=2), device="cpu"),
     "Queue A item 10"),
], ids=["tensor_parallel"])
def test_unported_raise_messages_name_the_item(call, item):
    with pytest.raises(NotImplementedError, match=item):
        call()


@pytest.mark.parametrize("module", ["framework_io.py", "jit/serialization.py", "inference.py"])
def test_deploy_path_never_needs_ml_dtypes(module):
    """paddle.save/load, jit.save/load and the Predictor carry bfloat16 as
    uint16 bits: they import no ml_dtypes."""
    roots = {m.split(".")[0] for m in _imported_roots(PORT / module)}
    assert "ml_dtypes" not in roots
