"""paddle.inference of the PyTorch port against the JAX package's
(``tests/test_extension_points.py::TestInferenceAPI`` and
``tests/test_inference_decode.py::TestPredictorWarmup``, ported).

Both packages save the same weights with their ``jit.save``; the port's
Predictor runs on the CPU after ``disable_gpu()``. Most cases compile with
``switch_ir_optim(False)`` (AOTAutograd without Inductor's code generation:
seconds less on this CPU); one runs Inductor. Dynamo's caches are reset
around every test.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu import inference as jinference
from paddle_tpu_torch import inference, jit
from paddle_tpu_torch.jit import InputSpec


@pytest.fixture(autouse=True)
def _fresh_dynamo():
    torch._dynamo.reset()
    yield
    torch._dynamo.reset()


def _copy_linears(jax_seq, torch_seq):
    """The JAX Sequential's Linear weights into the port's (transposed)."""
    jl = [m for m in jax_seq.sublayers() if isinstance(m, jnn.Linear)]
    tl = [m for m in torch_seq.modules() if isinstance(m, torch.nn.Linear)]
    assert len(jl) == len(tl)
    with torch.no_grad():
        for j, t in zip(jl, tl):
            t.weight.copy_(torch.from_numpy(np.array(j.weight.numpy()).T))
            t.bias.copy_(torch.from_numpy(np.array(j.bias.numpy())))
    return torch_seq.eval()


def _cpu_config(prefix, ir_optim=False):
    cfg = inference.Config(prefix)
    cfg.disable_gpu()
    cfg.switch_ir_optim(ir_optim)
    return cfg


class TestInferenceAPI:
    def test_predictor_roundtrip(self, tmp_path):
        paddle.seed(0)
        jnet = jnn.Sequential(jnn.Linear(4, 3), jnn.ReLU())
        spec = paddle.static.InputSpec([None, 4], "float32", "x")
        paddle.jit.save(jnet, str(tmp_path / "jax"), input_spec=[spec])
        tnet = _copy_linears(jnet, torch.nn.Sequential(torch.nn.Linear(4, 3), torch.nn.ReLU()))
        jit.save(tnet, str(tmp_path / "port"), input_spec=[InputSpec([None, 4], "float32", "x")])

        x = np.random.RandomState(0).randn(5, 4).astype("float32")
        outs = []
        for mod, cfg in ((jinference, jinference.Config(str(tmp_path / "jax"))),
                         (inference, _cpu_config(str(tmp_path / "port")))):
            cfg.enable_memory_optim()
            predictor = mod.create_predictor(cfg)
            assert predictor.get_input_names() == ["x"]
            h = predictor.get_input_handle("x")
            h.reshape(x.shape)
            h.copy_from_cpu(x)
            predictor.run()
            names = predictor.get_output_names()
            outs.append((names, predictor.get_output_handle(names[0]).copy_to_cpu()))
        (jnames, ref), (names, out) = outs
        assert names == jnames == ["output_0"]
        assert isinstance(out, np.ndarray)
        np.testing.assert_allclose(out, ref, rtol=1e-5)
        np.testing.assert_allclose(out, tnet(torch.from_numpy(x)).detach().numpy(), rtol=1e-5)

    def test_predictor_run_with_inputs_list(self, tmp_path):
        paddle.seed(1)
        jnet = jnn.Linear(2, 2)
        paddle.jit.save(jnet, str(tmp_path / "jax"),
                        input_spec=[paddle.static.InputSpec([None, 2], "float32", "inp")])
        tnet = _copy_linears(jnn.Sequential(jnet), torch.nn.Sequential(torch.nn.Linear(2, 2)))
        jit.save(tnet, str(tmp_path / "port"),
                 input_spec=[InputSpec([None, 2], "float32", "inp")])
        x = np.ones((3, 2), "float32")
        (ref,) = jinference.create_predictor(jinference.Config(str(tmp_path / "jax"))).run([x])
        predictor = inference.create_predictor(_cpu_config(str(tmp_path / "port")))
        (out,) = predictor.run([x])
        assert predictor.get_input_names() == ["inp"]
        np.testing.assert_allclose(out, ref, rtol=1e-5)


def _warmup_pair(tmp_path):
    paddle.seed(0)
    jnet = jnn.Sequential(jnn.Linear(8, 16), jnn.ReLU(), jnn.Linear(16, 4))
    paddle.jit.save(jnet, str(tmp_path / "jax"),
                    input_spec=[paddle.jit.InputSpec([None, 8], "float32")])
    tnet = _copy_linears(jnet, torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.ReLU(),
                                                   torch.nn.Linear(16, 4)))
    jit.save(tnet, str(tmp_path / "port"), input_spec=[InputSpec([None, 8], "float32")])
    return str(tmp_path / "jax"), str(tmp_path / "port"), tnet


class TestPredictorWarmup:
    @pytest.mark.parametrize("ir_optim", [False, True], ids=["aot_eager", "inductor"])
    def test_warmup_shapes_precompiled(self, tmp_path, ir_optim):
        jax_prefix, prefix, _ = _warmup_pair(tmp_path)
        jcfg = jinference.Config(jax_prefix)
        jcfg.exp_set_warmup_shapes([(1, 8), (4, 8)])
        jpred = jinference.create_predictor(jcfg)
        cfg = _cpu_config(prefix, ir_optim)
        cfg.exp_set_warmup_shapes([(1, 8), (4, 8)])
        pred = inference.create_predictor(cfg)
        assert pred._warmed_shapes == jpred._warmed_shapes == [(1, 8), (4, 8)]
        assert pred.compiles == 2
        x = np.random.RandomState(2).randn(4, 8).astype("float32")
        out = pred.run([x])
        assert out[0].shape == (4, 4)
        # a warmed shape compiles nothing at run
        assert pred.compiles == 2
        np.testing.assert_allclose(out[0], jpred.run([x])[0], rtol=1e-5, atol=1e-6)
        # a shape not warmed compiles once, then reuses its program
        x3 = np.ones((3, 8), "float32")
        a = pred.run([x3])
        b = pred.run([x3])
        assert pred.compiles == 3
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_allclose(a[0], jpred.run([x3])[0], rtol=1e-5, atol=1e-6)

    def test_failed_warmup_warns_and_construction_goes_on(self, tmp_path):
        jax_prefix, prefix, tnet = _warmup_pair(tmp_path)
        jcfg = jinference.Config(jax_prefix)
        jcfg.exp_set_warmup_shapes([(2, 5), (2, 8)])
        with pytest.warns(UserWarning, match=r"predictor warmup for \(2, 5\)"):
            jpred = jinference.create_predictor(jcfg)
        cfg = _cpu_config(prefix)
        cfg.exp_set_warmup_shapes([(2, 5), (2, 8)])
        with pytest.warns(UserWarning, match=r"predictor warmup for \(2, 5\)"):
            pred = inference.create_predictor(cfg)
        assert pred._warmed_shapes == jpred._warmed_shapes == [(2, 8)]
        x = np.random.RandomState(3).randn(2, 8).astype("float32")
        np.testing.assert_allclose(pred.run([x])[0], tnet(torch.from_numpy(x)).detach().numpy(),
                                   rtol=1e-6)

    def test_multi_input_program_refuses_warmup(self, tmp_path):
        class Two(torch.nn.Module):
            def forward(self, a, b):
                return a * b + a

        class JTwo(jnn.Layer):
            def forward(self, a, b):
                return a * b + a

        paddle.jit.save(JTwo(), str(tmp_path / "jax"),
                        input_spec=[paddle.jit.InputSpec([2, 3], "float32", "a"),
                                    paddle.jit.InputSpec([2, 3], "float32", "b")])
        jit.save(Two(), str(tmp_path / "port"),
                 input_spec=[InputSpec([2, 3], "float32", "a"),
                             InputSpec([2, 3], "float32", "b")], device="cpu")
        for mod, cfg in ((jinference, jinference.Config(str(tmp_path / "jax"))),
                         (inference, _cpu_config(str(tmp_path / "port")))):
            cfg.exp_set_warmup_shapes([(2, 3)])
            with pytest.warns(UserWarning, match="single-input programs"):
                pred = mod.create_predictor(cfg)
            assert pred._warmed_shapes == []
            with pytest.raises(ValueError, match="takes 2 inputs"):
                pred._warm((2, 3))
            assert pred.get_input_names() == ["a", "b"]
        a = np.full((2, 3), 2.0, "float32")
        b = np.full((2, 3), 3.0, "float32")
        np.testing.assert_array_equal(pred.run([a, b])[0], a * b + a)


class TestConfig:
    def test_toggles_recorded_as_jax_records_them(self):
        cfgs = [jinference.Config("m"), inference.Config("m")]
        for cfg in cfgs:
            cfg.enable_use_gpu(256, 0, jinference.PrecisionType.Bfloat16)
            cfg.switch_ir_optim(False)
            cfg.enable_memory_optim(False)
            cfg.set_cpu_math_library_num_threads(4)
            cfg.enable_tensorrt_engine()
            cfg.enable_mkldnn()
            cfg.enable_custom_device("npu", 1)
            cfg.exp_set_warmup_shapes([(1, 128), ((2, 7), "int64")])
            cfg.set_model("other")
        fields = ("prog_file", "params_file", "_model_dir", "_use_gpu", "_device_id",
                  "_enable_memory_optim", "_switch_ir_optim", "_cpu_math_threads",
                  "_precision", "_extra")
        for f in fields:
            assert getattr(cfgs[0], f) == getattr(cfgs[1], f), f
        assert cfgs[0].summary() == cfgs[1].summary()
        assert cfgs[0].use_gpu() is cfgs[1].use_gpu() is True
        for cfg in cfgs:
            cfg.disable_gpu()
        assert cfgs[0].use_gpu() is cfgs[1].use_gpu() is False
        assert inference.PrecisionType.Bfloat16 == jinference.PrecisionType.Bfloat16
        assert inference.PlaceType.GPU == jinference.PlaceType.GPU
        assert inference.get_version() == jinference.get_version()

    def test_predictor_runs_on_the_card_unless_disable_gpu(self, tmp_path, monkeypatch):
        """The default Config and enable_use_gpu() both want the card, which
        this machine lacks: the Predictor raises rather than run on the CPU."""
        _, prefix, _ = _warmup_pair(tmp_path)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        cfg = inference.Config(prefix)
        with pytest.raises(RuntimeError, match="no card"):
            inference.create_predictor(cfg)
        cfg.enable_use_gpu()
        with pytest.raises(RuntimeError, match="no card"):
            inference.create_predictor(cfg)
        pred = inference.create_predictor(_cpu_config(prefix))
        assert pred._device.type == "cpu"

    def test_handles_move_data_to_and_from_the_device(self, tmp_path):
        _, prefix, _ = _warmup_pair(tmp_path)
        pred = inference.create_predictor(_cpu_config(prefix))
        h = pred.get_input_handle(pred.get_input_names()[0])
        x = np.arange(16, dtype="float32").reshape(2, 8)
        h.copy_from_cpu(x)
        assert isinstance(h._value, torch.Tensor) and h._value.device.type == "cpu"
        np.testing.assert_array_equal(h.copy_to_cpu(), x)
        h.share_external_data(torch.ones(2, 8))
        pred.run()
        out = pred.get_output_handle("output_0")
        assert isinstance(out._value, torch.Tensor) and out.copy_to_cpu().shape == (2, 4)
        with pytest.raises(KeyError):
            pred.get_output_handle("output_9")


def test_llama_served_from_a_saved_program(tmp_path):
    """The slice end to end at a small size: a 2-layer LLaMA saved at (2, 7)
    by both packages and served by each package's Predictor with that shape
    warmed; the port's logits equal JAX's (test_torch_llama.py's tolerance)
    and its run compiles nothing."""
    from paddle_tpu.models import LlamaConfig as JaxConfig
    from paddle_tpu.models import LlamaForCausalLM as JaxLlama
    from paddle_tpu_torch.models import LlamaConfig, llama_from_numpy

    kw = dict(vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
              num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=32)
    paddle.seed(0)
    jm = JaxLlama(JaxConfig(**kw))
    jm.eval()
    tm = llama_from_numpy({k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()},
                          LlamaConfig(**kw), device="cpu")
    paddle.jit.save(jm, str(tmp_path / "jax"),
                    input_spec=[paddle.jit.InputSpec([2, 7], "int64", "input_ids")])
    jit.save(tm, str(tmp_path / "port"), input_spec=[InputSpec([2, 7], "int64", "input_ids")])
    jcfg = jinference.Config(str(tmp_path / "jax"))
    jcfg.exp_set_warmup_shapes([((2, 7), "int64")])
    cfg = _cpu_config(str(tmp_path / "port"))
    cfg.exp_set_warmup_shapes([((2, 7), "int64")])
    jpred, pred = jinference.create_predictor(jcfg), inference.create_predictor(cfg)
    assert pred._warmed_shapes == jpred._warmed_shapes == [(2, 7)]
    assert pred.get_input_names() == jpred.get_input_names() == ["input_ids"]
    compiles = pred.compiles
    ids = np.random.RandomState(6).randint(0, 64, (2, 7)).astype("int64")
    (out,) = pred.run([ids])
    assert pred.compiles == compiles
    np.testing.assert_allclose(out, jpred.run([ids])[0], rtol=1e-4, atol=1e-4)
    with torch.no_grad():
        np.testing.assert_allclose(out, tm(torch.from_numpy(ids)).numpy(), rtol=1e-5,
                                   atol=1e-6)
