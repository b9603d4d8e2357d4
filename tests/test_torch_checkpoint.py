"""The checkpoint manager of the PyTorch port (paddle_tpu_torch/checkpoint)
against the JAX package's: tests/test_checkpoint.py's TestSaveRestore cases
on the port's manager and fault harness, checkpoints written by either
package restored by the other (digests verified, bfloat16 intact), one
verified by tools/ckpt_inspect.py, bfloat16 without ``ml_dtypes``, torch
tensors saved without aliasing, and a JAX training run saved at step 2 and
resumed by the port."""
import glob
import os
import subprocess
import sys
import time

import numpy as np
import pytest

import torch

import paddle_tpu as paddle
from paddle_tpu.analysis import faultinject as jfi
from paddle_tpu.checkpoint import CheckpointManager as JaxManager
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch.analysis import faultinject as fi
from paddle_tpu_torch.checkpoint import (CheckpointCorrupt, CheckpointManager, NoCheckpoint,
                                         load_training_state, training_state,
                                         verify_checkpoint)
from paddle_tpu_torch.checkpoint import manager as tmanager
from paddle_tpu_torch.framework import Parameter
from paddle_tpu_torch.models import LlamaConfig, llama_from_numpy, llama_to_numpy
from paddle_tpu_torch.models.convert import name_map
from paddle_tpu_torch.optimizer import AdamW

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_faults():
    fi.reset()
    jfi.reset()
    yield
    fi.reset()
    jfi.reset()


def _state(seed=0, n=24):
    r = np.random.RandomState(seed)
    arrays = {
        "param/w": r.randn(4, 6).astype("float32"),
        "param/b": r.randn(6).astype("float32"),
        "rng/key": np.array([seed, seed + 1], np.uint32),
    }
    flat = r.randn(n).astype("float32")
    k8 = -(-n // 8)
    padded = np.concatenate([flat, np.zeros(8 * k8 - n, np.float32)])
    zero = {"acc/w/m": (padded.reshape(8, k8), n)}
    return arrays, zero, flat


class TestSaveRestore:
    def test_round_trip_and_manifest(self, tmp_path):
        arrays, zero, flat = _state()
        m = CheckpointManager(tmp_path, keep=3)
        m.save(3, arrays, zero=zero, meta={"loss_scale": 128.0,
                                           "data_cursor": {"cursor": 7}}, block=True)
        assert m.steps() == [3]
        rc = m.restore()
        assert rc.step == 3
        for k in ("param/w", "param/b", "rng/key"):
            assert np.array_equal(rc.arrays[k], arrays[k])
        assert np.array_equal(rc.zero["acc/w/m"], flat)
        assert rc.meta["loss_scale"] == 128.0
        assert rc.meta["data_cursor"] == {"cursor": 7}
        doc = verify_checkpoint(rc.path)
        assert doc["step"] == 3
        ent = doc["entries"]["acc/w/m"]
        assert ent["kind"] == "zero" and ent["dp"] == 8
        assert len(ent["shards"]) == 8
        assert all(sh["digest"] and sh["bytes"] > 0 for sh in ent["shards"])

    def test_zero_reshard_dp8_to_dp4_and_dp1(self, tmp_path):
        arrays, zero, flat = _state(n=26)   # deliberately not divisible
        m = CheckpointManager(tmp_path)
        m.save(1, arrays, zero=zero, block=True)
        rc = m.restore()
        for dp in (8, 4, 2, 1):
            rows = rc.zero_sharded("acc/w/m", dp)
            assert rows.shape == (dp, -(-26 // dp))
            assert np.array_equal(rows.reshape(-1)[:26], flat)
            assert not rows.reshape(-1)[26:].any()

    def test_async_save_does_not_block_the_step_thread(self, tmp_path):
        arrays, zero, _ = _state()
        m = CheckpointManager(tmp_path)
        fi.arm("ckpt.write", action="delay", delay_s=0.5, nth=1, times=1)
        t0 = time.perf_counter()
        m.save(1, arrays, zero=zero)          # writer sleeps 0.5 s
        m.save(2, arrays, zero=zero)          # stages into the second buffer
        dt = time.perf_counter() - t0
        assert dt < 0.4, f"save() blocked on the writer ({dt:.2f}s)"
        m.wait()
        assert m.steps() == [1, 2]
        m.close()

    def test_atomic_commit_rejects_torn_write(self, tmp_path):
        arrays, zero, _ = _state()
        m = CheckpointManager(tmp_path)
        m.save(1, arrays, zero=zero, block=True)
        fi.arm("ckpt.write", action="raise", nth=1)
        m.save(2, arrays, zero=zero)
        with pytest.raises(Exception, match="injected fault"):
            m.wait()
        assert m.steps() == [1]
        assert m.restore_latest_valid().step == 1
        CheckpointManager(tmp_path)
        assert not [p for p in os.listdir(tmp_path) if p.startswith(".tmp-")]

    def test_corrupted_digest_rejected_with_fallback(self, tmp_path):
        arrays, zero, _ = _state()
        m = CheckpointManager(tmp_path)
        m.save(1, arrays, zero=zero, block=True)
        fi.arm("ckpt.write", action="flag", nth=1)
        m.save(2, arrays, zero=zero, block=True)
        assert m.steps() == [1, 2]
        with pytest.raises(CheckpointCorrupt, match="digest mismatch"):
            m.restore(2)
        rc = m.restore_latest_valid()
        assert rc.step == 1 and rc.meta is not None

    def test_on_disk_corruption_detected(self, tmp_path):
        arrays, zero, _ = _state()
        m = CheckpointManager(tmp_path)
        m.save(5, arrays, zero=zero, block=True)
        shard = sorted(glob.glob(os.path.join(str(tmp_path), "step_00000005", "s*.npy")))[0]
        blob = open(shard, "rb").read()
        with open(shard, "wb") as f:
            f.write(blob[:-1] + bytes([blob[-1] ^ 0xFF]))
        with pytest.raises(CheckpointCorrupt, match="digest mismatch"):
            m.restore()
        with pytest.raises(NoCheckpoint):
            m.restore_latest_valid()

    def test_prepare_copies_never_alias_tensors(self, tmp_path):
        """The snapshot's host copy is a real copy: a CPU tensor's numpy view
        shares its storage, and the next step updates it in place while the
        writer thread may still be encoding."""
        m = CheckpointManager(tmp_path)
        x = torch.arange(8, dtype=torch.float32)
        z = torch.ones((4, 2))
        p = Parameter(torch.ones(3))
        job = m._prepare(1, {"x": x, "n": x.numpy(), "p": p}, {"z": (z, 8)}, {})
        assert job["full"]["p"][1] == "float32"
        assert not np.shares_memory(job["full"]["p"][0], p.detach().numpy())
        assert not np.shares_memory(job["full"]["x"][0], x.numpy())
        assert not np.shares_memory(job["full"]["n"][0], x.numpy())
        assert not np.shares_memory(job["zero"]["z"][0], z.numpy())
        x.add_(1)
        assert job["full"]["x"][0][0] == 0.0

    def test_retention_keeps_newest(self, tmp_path):
        arrays, zero, _ = _state()
        m = CheckpointManager(tmp_path, keep=2)
        for s in (1, 2, 3, 4):
            m.save(s, arrays, zero=zero, block=True)
        assert m.steps() == [3, 4]

    def test_recommit_keeps_existing_commit(self, tmp_path):
        m = CheckpointManager(tmp_path)
        m.save(1, {"x": np.zeros(4, np.float32)}, block=True)
        m.save(1, {"x": np.ones(4, np.float32)}, block=True)
        assert np.array_equal(m.restore(1).arrays["x"], np.zeros(4, np.float32))

    def test_clear_purges_committed_steps(self, tmp_path):
        arrays, zero, _ = _state()
        m = CheckpointManager(tmp_path)
        for s in (1, 2):
            m.save(s, arrays, zero=zero, block=True)
        m.clear()
        assert m.steps() == []
        with pytest.raises(NoCheckpoint):
            m.restore()

    def test_restore_missing_step_raises(self, tmp_path):
        m = CheckpointManager(tmp_path)
        with pytest.raises(NoCheckpoint):
            m.restore()
        arrays, zero, _ = _state()
        m.save(1, arrays, zero=zero, block=True)
        with pytest.raises(NoCheckpoint):
            m.restore(9)

    def test_bfloat16_round_trip(self, tmp_path):
        import ml_dtypes

        a = np.arange(8, dtype=np.float32).astype(ml_dtypes.bfloat16)
        t = torch.arange(8, dtype=torch.float32).bfloat16()
        m = CheckpointManager(tmp_path)
        m.save(1, {"x": a, "t": t}, block=True)
        rc = m.restore()
        assert rc.arrays["x"].dtype == ml_dtypes.bfloat16
        assert np.array_equal(rc.arrays["x"].view(np.uint16), a.view(np.uint16))
        assert rc.dtype("t") == "bfloat16"
        assert torch.equal(rc.tensor("t"), t) and rc.tensor("x").dtype == torch.bfloat16

    def test_ckpt_restore_fault_point_fires(self, tmp_path):
        arrays, zero, _ = _state()
        m = CheckpointManager(tmp_path)
        m.save(1, arrays, zero=zero, block=True)
        fi.arm("ckpt.restore", action="raise", nth=1)
        with pytest.raises(Exception, match="injected fault"):
            m.restore()
        assert ("ckpt.restore", "raise") in fi.trips()

    def test_status(self, tmp_path):
        m = CheckpointManager(tmp_path, keep=2)
        m.save(4, {"x": np.zeros(2, np.float32)}, block=True)
        st = m.status()
        assert st["committed"] == 1 and st["latest_step"] == 4 and st["keep"] == 2


def _mixed():
    """numpy arrays and torch tensors of several dtypes, bfloat16 among them."""
    r = np.random.RandomState(5)
    return {
        "w32": torch.from_numpy(r.randn(3, 5).astype(np.float32)),
        "wbf16": torch.from_numpy(r.randn(7).astype(np.float32)).bfloat16(),
        "w16": torch.from_numpy(r.randn(2, 2).astype(np.float16)),
        "ids": torch.arange(6, dtype=torch.int64).reshape(2, 3),
        "flag": torch.tensor([True, False]),
        "np": r.randn(4).astype(np.float64),
    }


class TestAcrossPackages:
    def test_port_checkpoint_restores_in_jax(self, tmp_path):
        import ml_dtypes

        arrays = _mixed()
        _, zero, flat = _state(3, n=13)
        CheckpointManager(tmp_path).save(2, arrays, zero=zero, meta={"k": 1}, block=True)
        rc = JaxManager(tmp_path).restore()
        assert rc.step == 2 and rc.meta == {"k": 1}
        np.testing.assert_array_equal(rc.zero["acc/w/m"], flat)
        for k, v in arrays.items():
            got = rc.arrays[k]
            if k == "wbf16":
                assert got.dtype == ml_dtypes.bfloat16
                np.testing.assert_array_equal(got.view(np.uint16),
                                              v.view(torch.int16).numpy().view(np.uint16))
            else:
                np.testing.assert_array_equal(got, v.numpy() if isinstance(v, torch.Tensor)
                                              else v)

    def test_jax_checkpoint_restores_in_the_port(self, tmp_path):
        import ml_dtypes

        r = np.random.RandomState(6)
        bf = r.randn(9).astype(np.float32).astype(ml_dtypes.bfloat16)
        arrays = {"a": r.randn(3, 4).astype(np.float32), "bf": bf,
                  "i": np.arange(5, dtype=np.int32)}
        _, zero, flat = _state(4, n=19)
        JaxManager(tmp_path).save(7, arrays, zero=zero, meta={"m": [1, 2]}, block=True)
        rc = CheckpointManager(tmp_path).restore()
        assert rc.step == 7 and rc.meta == {"m": [1, 2]}
        np.testing.assert_array_equal(rc.zero["acc/w/m"], flat)
        np.testing.assert_array_equal(rc.arrays["a"], arrays["a"])
        np.testing.assert_array_equal(rc.arrays["i"], arrays["i"])
        t = rc.tensor("bf", "cpu")
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.view(torch.int16).numpy().view(np.uint16),
                                      bf.view(np.uint16))

    def test_same_bytes_as_the_jax_manager(self, tmp_path):
        # the same arrays through both managers give the same shard bytes
        # and digests (the manifests differ only in their save time)
        import ml_dtypes

        r = np.random.RandomState(8)
        a = r.randn(4, 4).astype(np.float32)
        b = r.randn(6).astype(np.float32)
        JaxManager(tmp_path / "jax").save(1, {"a": a, "b": b.astype(ml_dtypes.bfloat16)},
                                          block=True)
        CheckpointManager(tmp_path / "port").save(
            1, {"a": torch.from_numpy(a), "b": torch.from_numpy(b).bfloat16()}, block=True)
        docs = [verify_checkpoint(str(tmp_path / d / "step_00000001")) for d in ("jax", "port")]
        assert docs[0]["entries"] == docs[1]["entries"]

    def test_ckpt_inspect_verifies_a_port_checkpoint(self, tmp_path):
        CheckpointManager(tmp_path).save(3, _mixed(), block=True)
        out = subprocess.run([sys.executable, os.path.join(ROOT, "tools", "ckpt_inspect.py"),
                              str(tmp_path)], capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        assert "ckpt_inspect: OK (1 step(s))" in out.stdout and "bfloat16" in out.stdout
        shard = sorted(glob.glob(os.path.join(str(tmp_path), "step_00000003", "s*.npy")))[0]
        blob = open(shard, "rb").read()
        with open(shard, "wb") as f:
            f.write(blob[:-1] + bytes([blob[-1] ^ 0xFF]))
        out = subprocess.run([sys.executable, os.path.join(ROOT, "tools", "ckpt_inspect.py"),
                              str(tmp_path)], capture_output=True, text=True, timeout=120)
        assert out.returncode == 1 and "digest mismatch" in out.stderr

    def test_bfloat16_without_ml_dtypes(self, tmp_path):
        """In a process where ``ml_dtypes`` cannot be imported (as on a machine
        without it; here it is made unimportable, in a fresh interpreter
        because importing it once registers bfloat16 with numpy), a bf16
        tensor round-trips bit for bit and the JAX manager reads it back."""
        import ml_dtypes

        code = (
            "import sys; sys.modules['ml_dtypes'] = None\n"
            "import numpy as np, torch\n"
            "from paddle_tpu_torch.checkpoint import CheckpointManager\n"
            "t = torch.linspace(-3, 3, 15).reshape(5, 3).bfloat16()\n"
            "m = CheckpointManager(sys.argv[1])\n"
            "m.save(1, {'t': t, 'f': torch.ones(2)}, block=True)\n"
            "rc = m.restore()\n"
            "assert 'bfloat16' not in np.sctypeDict and rc.arrays['t'].dtype == np.uint16\n"
            "assert rc.dtype('t') == 'bfloat16' and rc.arrays['f'].dtype == np.float32\n"
            "assert torch.equal(rc.tensor('t'), t) and torch.equal(rc.tensor('f'), torch.ones(2))\n"
            "print('ok')\n")
        env = dict(os.environ, PYTHONPATH=ROOT)
        out = subprocess.run([sys.executable, "-c", code, str(tmp_path)], env=env, cwd=ROOT,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
        rc = JaxManager(tmp_path).restore()
        assert rc.arrays["t"].dtype == ml_dtypes.bfloat16
        np.testing.assert_array_equal(rc.arrays["t"].astype(np.float32),
                                      torch.linspace(-3, 3, 15).reshape(5, 3).bfloat16()
                                      .float().numpy())


_CFG = dict(vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=32)


def _batch(seed):
    r = np.random.RandomState(seed)
    ids = r.randint(0, 64, (2, 8)).astype("int64")
    labels = r.randint(0, 64, (2, 8)).astype("int64")
    labels[r.rand(2, 8) < 0.25] = -100
    return ids, labels


def test_jax_run_resumes_in_the_port(tmp_path):
    """A JAX training run (AdamW under a scheduler) saved at step 2 with the
    JAX manager; the port restores model, optimizer and scheduler and trains
    steps 3-4: losses and weights equal the JAX run's (fp32, 1e-4)."""
    paddle.seed(0)
    jm = JaxLlama(JaxConfig(**_CFG))
    jm.train()
    jsched = paddle.optimizer.lr.CosineAnnealingDecay(2e-3, T_max=6)
    jopt = paddle.optimizer.AdamW(learning_rate=jsched, parameters=jm.parameters(),
                                  grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0))

    def jstep(s):
        loss, _ = jm(*(paddle.to_tensor(a) for a in _batch(s)))
        loss.backward()
        jopt.step()
        jopt.clear_grad()
        jsched.step()
        return float(loss.numpy())

    for s in range(2):
        jstep(s)
    state = jopt.state_dict()
    arrays = {f"model/{k}": np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    arrays.update({f"opt/{k}": np.asarray(v.numpy()) for k, v in state.items()
                   if k not in ("master_weights", "LR_Scheduler", "@step")})
    JaxManager(tmp_path).save(2, arrays, meta={"@step": state["@step"],
                                               "LR_Scheduler": state["LR_Scheduler"]},
                              block=True)
    ref_losses = [jstep(s) for s in (2, 3)]
    ref_params = {n: np.asarray(p.numpy()) for n, p in jm.named_parameters()}

    rc = CheckpointManager(tmp_path).restore()
    model_state = {k[len("model/"):]: v for k, v in rc.arrays.items() if k.startswith("model/")}
    cfg = LlamaConfig(**_CFG)
    tm = llama_from_numpy(model_state, cfg, device="cpu")
    tm.train()
    # the optimizer's keys are the JAX parameters' names: give the port's
    # parameters those names
    params = dict(tm.named_parameters())
    jnames = {n: p.name for n, p in jm.named_parameters()}
    for src, (dst, _) in name_map(cfg).items():
        params[dst].name = jnames[src]
    tsched = __import__("paddle_tpu_torch.optimizer.lr", fromlist=["lr"]).CosineAnnealingDecay(
        2e-3, T_max=6)
    from paddle_tpu_torch import nn as tnn

    topt = AdamW(learning_rate=tsched, parameters=tm.parameters(),
                 grad_clip=tnn.ClipGradByGlobalNorm(1.0))
    # moments of a Linear weight are in paddle's (in, out) layout, as the
    # weight: transposed as models/convert.py transposes the weight
    opt_state = {k[len("opt/"):]: v for k, v in rc.arrays.items() if k.startswith("opt/")}
    for src, (_, transpose) in name_map(cfg).items():
        for k in [k for k in opt_state if k.startswith(jnames[src] + "_") and transpose]:
            opt_state[k] = opt_state[k].T
    with pytest.raises(ValueError, match="does not fit"):
        topt.set_state_dict(dict({k: v.T for k, v in opt_state.items()}, **rc.meta))
    topt.set_state_dict(dict(opt_state, **rc.meta))
    assert topt._step_count == 2 and tsched.last_epoch == jsched.last_epoch - 2
    losses = []
    for s in (2, 3):
        loss, _ = tm(*(torch.from_numpy(a) for a in _batch(s)))
        loss.backward()
        topt.step()
        topt.clear_grad()
        tsched.step()
        losses.append(loss.item())
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4, atol=1e-4)
    out = llama_to_numpy(tm)
    for n, p in ref_params.items():
        np.testing.assert_allclose(out[n], p, rtol=1e-4, atol=1e-4, err_msg=n)


def test_training_state_round_trip_is_bit_exact(tmp_path):
    """training_state/load_training_state: a bf16 model with fp32 masters,
    saved after 2 steps and restored into fresh objects, trains on exactly
    as the uninterrupted run (CPU, bit for bit)."""
    def build():
        from paddle_tpu_torch.models import LlamaForCausalLM
        from paddle_tpu_torch.optimizer import lr

        m = LlamaForCausalLM(LlamaConfig(dtype="bfloat16", recompute=True, **_CFG),
                             device="cpu", seed=1)
        m.train()
        sched = lr.LinearWarmup(lr.CosineAnnealingDecay(1e-2, T_max=5), warmup_steps=2,
                                start_lr=1e-3, end_lr=1e-2)
        opt = AdamW(learning_rate=sched, parameters=m.named_parameters(),
                    multi_precision=True)
        return m, opt, sched

    def train(m, opt, sched, steps):
        out = []
        for s in steps:
            loss, _ = m(*(torch.from_numpy(a) for a in _batch(s)))
            loss.backward()
            opt.step()
            opt.clear_grad()
            sched.step()
            out.append(loss.item())
        return out

    ref = build()
    ref_losses = train(*ref, range(4))
    run = build()
    train(*run, range(2))
    arrays, meta = training_state(run[0], run[1])
    assert meta["LR_Scheduler.lr_sched"]["last_epoch"] == 0   # warmup just ended
    mgr = CheckpointManager(tmp_path)
    mgr.save(2, arrays, meta=meta)
    mgr.wait()
    fresh = build()
    rc = mgr.restore()
    load_training_state(rc, fresh[0], fresh[1])
    assert train(*fresh, range(2, 4)) == ref_losses[2:]
    for a, b in zip(fresh[0].parameters(), ref[0].parameters()):
        assert torch.equal(a, b)
    mgr.close()


def test_manager_module_imports_nothing_of_jax():
    assert "jax" not in tmanager.__dict__ and "paddle_tpu" not in tmanager.__dict__
