"""The port's static graph (paddle_tpu_torch/static, framework/capture.py,
base and the top-level static-mode functions) against the JAX package's.

Each case builds the same reference-style program (``program_guard`` +
``static.data`` + layers + ``minimize`` + ``Executor.run``) in both
packages, carries the JAX layers' weights into the port's, and holds the
fetched values of the port's replays to the JAX replays' at float32 rtol
1e-5 / atol 1e-6 (the AMP cases at the bf16/fp16 bounds of
test_torch_amp.py). The capture cases that exist only because the port's
tensor is ``torch.Tensor`` (a torch operator on a placeholder, on another
thread, an op on a parameter alone that then trains, a port op recorded
once) are held to the JAX package's recording of the same program, and the
LLaMA program's replay is held to an eager twin bit for bit.
"""
import threading

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as T
from paddle_tpu_torch.framework import capture
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM, llama_from_numpy
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from test_torch_ops import _np, _on_cpu  # noqa: F401

RTOL, ATOL = 1e-5, 1e-6
BOTH = (paddle, T)


@pytest.fixture(autouse=True)
def _static_off():
    yield
    for P in BOTH:
        P.disable_static()


def _carry(jl, tl):
    """The JAX layer's state into the port's (the layouts are equal)."""
    missing, unexpected = tl.set_state_dict({k: _np(v) for k, v in jl.state_dict().items()})
    assert missing == [] and unexpected == []


def _mlp(P):
    return P.nn.Sequential(P.nn.Linear(16, 32), P.nn.ReLU(), P.nn.Linear(32, 10))


def _mnist_script(P, net_from=None, steps=15):
    """The reference idiom: the losses of ``steps`` runs."""
    P.enable_static()
    P.seed(0)
    main, startup = P.static.Program(), P.static.Program()
    with P.static.program_guard(main, startup):
        x = P.static.data(name="x", shape=[None, 16], dtype="float32")
        y = P.static.data(name="y", shape=[None, 1], dtype="int64")
        net = _mlp(P)
        if net_from is not None:
            _carry(net_from, net)
        loss = P.nn.functional.cross_entropy(net(x), y)
        loss.name = "loss"
        P.optimizer.SGD(learning_rate=0.5, parameters=net.parameters()).minimize(loss)
    exe = P.static.Executor()
    exe.run(startup)
    r = np.random.RandomState(0)
    xb, yb = r.randn(32, 16).astype("float32"), r.randint(0, 10, (32, 1)).astype("int64")
    losses = [float(exe.run(main, feed={"x": xb, "y": yb}, fetch_list=["loss"])[0])
              for _ in range(steps)]
    P.disable_static()
    return losses, net


class TestStaticExecutor:
    def test_reference_style_mnist_script_trains_to_jax_losses(self):
        ref, jnet = _mnist_script(paddle)
        # the JAX net's initial weights, rebuilt from the same seed
        paddle.seed(0)
        got, _ = _mnist_script(T, net_from=_mlp(paddle))
        assert got[-1] < got[0] * 0.7, got
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)

    @pytest.mark.parametrize("P", BOTH, ids=["jax", "port"])
    def test_fetch_by_tensor_and_different_batch_size(self, P):
        main = P.static.Program()
        with P.static.program_guard(main):
            x = P.static.data("x", [None, 4], "float32")
            out = (x * 2.0).sum(axis=1)
        exe = P.static.Executor()
        for bs in (2, 7):
            (got,) = exe.run(main, feed={"x": np.ones((bs, 4), "float32")}, fetch_list=[out])
            np.testing.assert_allclose(got, np.full((bs,), 8.0))

    def test_fetch_input_by_name(self):
        outs = []
        for P in BOTH:
            main = P.static.Program()
            with P.static.program_guard(main):
                x = P.static.data("x", [2, 2], "float32")
                y = x + 1.0
                y.name = "y_out"
            xv = np.arange(4, dtype="float32").reshape(2, 2)
            outs.append(P.static.Executor().run(main, feed={"x": xv},
                                                fetch_list=["x", "y_out"]))
        for a, b in zip(*outs):
            np.testing.assert_array_equal(b, a)

    def test_unknown_fetch_name_raises(self):
        main = T.static.Program()
        with T.static.program_guard(main):
            T.static.data("x", [2], "float32")
        with pytest.raises(KeyError, match="nope"):
            T.static.Executor().run(main, feed={"x": np.zeros(2, "float32")},
                                    fetch_list=["nope"])

    def test_clone_for_test_drops_train_hooks(self):
        T.seed(0)
        main = T.static.Program()
        with T.static.program_guard(main):
            x = T.static.data("x", [None, 4], "float32")
            lin = T.nn.Linear(4, 2)
            loss = lin(x).sum()
            loss.name = "loss"
            T.optimizer.SGD(learning_rate=0.1, parameters=lin.parameters()).minimize(loss)
        test_prog = main.clone(for_test=True)
        exe = T.static.Executor()
        w0 = lin.weight.detach().clone()
        exe.run(test_prog, feed={"x": np.ones((2, 4), "float32")}, fetch_list=["loss"])
        torch.testing.assert_close(lin.weight.detach(), w0, rtol=0, atol=0)
        exe.run(main, feed={"x": np.ones((2, 4), "float32")}, fetch_list=["loss"])
        assert not torch.equal(lin.weight.detach(), w0)

    def test_guardless_default_program_idiom(self):
        T.enable_static()
        main = T.static.default_main_program()
        n_before = len(main._ops)
        x = T.static.data("gx", [None, 3], "float32")
        y = x * 3.0
        y.name = "gy"
        assert len(main._ops) > n_before
        assert not T.in_dynamic_mode() and T.in_static_mode()
        xv = np.ones((2, 3), "float32")
        (got,) = T.static.Executor().run(main, feed={"gx": xv}, fetch_list=["gy"])
        np.testing.assert_allclose(got, xv * 3.0)
        T.disable_static()
        assert T.in_dynamic_mode() and not T.in_static_mode()

    def test_missing_feed_raises(self):
        main = T.static.Program()
        with T.static.program_guard(main):
            x = T.static.data("a", [None, 2], "float32")
            x + 1.0
        with pytest.raises(RuntimeError, match="missing input"):
            T.static.Executor().run(main, feed={}, fetch_list=[])

    def test_run_inside_active_guard_terminates(self):
        main = T.static.Program()
        with T.static.program_guard(main):
            x = T.static.data("x", [None, 2], "float32")
            y = x + 1.0
            n_ops = len(main._ops)
            (got,) = T.static.Executor().run(main, feed={"x": np.zeros((1, 2), "float32")},
                                             fetch_list=[y])
            assert len(main._ops) == n_ops
        np.testing.assert_allclose(got, np.ones((1, 2)))

    def test_legacy_callable_fetch_still_works(self):
        main = T.static.Program()
        with T.static.program_guard(main):
            T.static.data("x", [None, 4], "float32")
        (out,) = T.static.Executor().run(main, feed={"x": np.ones((2, 4), "float32")},
                                         fetch_list=[lambda t: (t["x"] * 2).sum()])
        assert float(out) == 16.0


class TestCaptureThreading:
    def test_concurrent_program_guards_do_not_interleave(self):
        progs = {}

        def build(tid):
            main = T.static.Program()
            with T.static.program_guard(main):
                x = T.static.data(f"x{tid}", [None, 4], "float32")
                out = (x * float(tid + 1)).sum()
                out.name = "out"
            progs[tid] = main

        ts = [threading.Thread(target=build, args=(i,)) for i in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        exe = T.static.Executor()
        for tid, main in progs.items():
            assert list(main._inputs) == [f"x{tid}"]
            (got,) = exe.run(main, feed={f"x{tid}": np.ones((2, 4), "float32")},
                             fetch_list=["out"])
            assert float(got) == 8.0 * (tid + 1)

    def test_enable_static_records_torch_operators_on_other_threads(self):
        # the other thread has no program_guard (and no TorchFunctionMode):
        # the placeholder's own __torch_function__ records the operators
        T.enable_static()
        main = T.static.default_main_program()
        n0 = len(main._ops)
        box = {}

        def work():
            x = T.static.data("tl_x", [None, 2], "float32")
            y = (x + 1.0) * x
            y.name = "tl_y"
            box["y"] = y

        th = threading.Thread(target=work)
        th.start()
        th.join(timeout=60)
        assert len(main._ops) > n0
        xv = np.array([[2.0, 3.0], [4.0, 5.0], [1.0, 0.0]], "float32")
        feed = {n: np.zeros((1,) + tuple(ph.shape[1:]), "float32")
                for n, ph in main._inputs.items()}
        feed["tl_x"] = xv
        (got,) = T.static.Executor().run(main, feed=feed, fetch_list=[box["y"]])
        np.testing.assert_array_equal(got, (xv + 1.0) * xv)   # the feed's, not capture's

    def test_guard_masks_default_then_restores(self):
        T.enable_static()
        default = capture.active()
        assert default is not None
        own = T.static.Program()
        with T.static.program_guard(own):
            assert capture.active() is own
        assert capture.active() is default
        T.disable_static()
        assert capture.active() is None and not capture._ANY[0]


class TestCaptureKinds:
    """The four kinds of call the replay must redo, each held to the JAX
    package's recording of the same program."""

    def _replay(self, build, feeds, fetch):
        outs = []
        for P in BOTH:
            main = P.static.Program()
            with P.static.program_guard(main):
                build(P)
            exe = P.static.Executor()
            outs.append([exe.run(main, feed=f, fetch_list=fetch) for f in feeds])
        return outs

    def test_torch_operator_on_a_placeholder(self):
        def build(P):
            x = P.static.data("x", [None, 3], "float32")
            y = ((x * 2.0 - 1.0) ** 2).sum(axis=1) / 3.0
            y.name = "y"

        r = np.random.RandomState(0)
        feeds = [{"x": r.randn(b, 3).astype("float32")} for b in (2, 5)]
        ref, got = self._replay(build, feeds, ["y"])
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a[0], b[0], rtol=RTOL, atol=ATOL)

    def test_port_op_recorded_once(self):
        main = T.static.Program()
        with T.static.program_guard(main):
            x = T.static.data("x", [None, 3], "float32")
            y = T.tanh(x)
            y.name = "y"
        assert len(main._ops) == 1   # the op, not the torch calls inside it
        xv = np.random.RandomState(1).randn(4, 3).astype("float32")
        (got,) = T.static.Executor().run(main, feed={"x": xv}, fetch_list=["y"])
        np.testing.assert_allclose(got, np.tanh(xv), rtol=RTOL, atol=ATOL)

    def test_op_on_a_parameter_alone_then_trains(self):
        # w.t() touches only a parameter: recorded, so every replay reads the
        # weight the last step left (a baked copy would never train)
        losses = {}
        for P in BOTH:
            P.enable_static()
            main = P.static.Program()
            with P.static.program_guard(main, P.static.Program()):
                x = P.static.data("x", [None, 4], "float32")
                y = P.static.data("y", [None, 1], "float32")
                w = P.static.create_parameter([1, 4], "float32",
                                              default_initializer=P.nn.initializer.Constant(0.1))
                wt = P.transpose(w, [1, 0]) if P is paddle else w.t()
                loss = ((x @ wt - y) ** 2).mean()
                loss.name = "loss"
                P.optimizer.SGD(learning_rate=0.1).minimize(loss, parameters=[w])
            exe = P.static.Executor()
            r = np.random.RandomState(0)
            xb = r.randn(8, 4).astype("float32")
            yb = xb.sum(1, keepdims=True).astype("float32")
            losses[P] = [float(exe.run(main, feed={"x": xb, "y": yb},
                                       fetch_list=["loss"])[0]) for _ in range(20)]
            P.disable_static()
        assert losses[T][-1] < losses[T][0] * 0.1
        np.testing.assert_allclose(losses[T], losses[paddle], rtol=1e-4, atol=1e-6)

    def test_in_place_init_of_a_parameter_is_not_recorded(self):
        main = T.static.Program()
        with T.static.program_guard(main):
            lin = torch.nn.Linear(3, 4)        # kaiming_uniform_ on its parameters
            torch.nn.init.normal_(lin.weight)
            lin.weight.data.fill_(0.5)
            with torch.no_grad():
                lin.bias[0] = 1.0
                lin.bias.copy_(torch.ones(4))
        assert main._ops == []


class TestSymbolicDims:
    def test_reshape_with_placeholder_batch_dim(self):
        main = T.static.Program()
        with T.static.program_guard(main, T.static.Program()):
            x = T.static.data("x", [None, 2, 3], "float32")
            out = x.reshape([x.shape[0], 6])
            out.name = "out"
        feed = np.random.RandomState(0).randn(5, 2, 3).astype("float32")
        (r,) = T.static.Executor().run(main, feed={"x": feed}, fetch_list=["out"])
        np.testing.assert_array_equal(r, feed.reshape(5, 6))

    def test_dims_of_derived_tensors_resolve_too(self):
        # B, S = h.shape[:2] of a recorded tensor (the LLaMA attention's
        # reshape) replays at the fed batch
        main = T.static.Program()
        with T.static.program_guard(main):
            x = T.static.data("x", [None, 3, 4], "float32")
            h = x * 2.0
            B, S = h.shape[:2]
            out = T.reshape(h, [B, S, 2, 2]).sum(axis=-1)
            out.name = "out"
        feed = np.random.RandomState(1).randn(6, 3, 4).astype("float32")
        (r,) = T.static.Executor().run(main, feed={"x": feed}, fetch_list=["out"])
        np.testing.assert_allclose(r, (feed * 2.0).reshape(6, 3, 2, 2).sum(-1), rtol=RTOL)

    def test_arithmetic_on_dynamic_dim_warns(self):
        main = T.static.Program()
        with T.static.program_guard(main, T.static.Program()):
            x = T.static.data("x", [None, 4], "float32")
            with pytest.warns(UserWarning, match="dynamic placeholder"):
                _ = x.shape[0] * 2

    def test_static_dims_stay_plain_ints(self):
        main = T.static.Program()
        with T.static.program_guard(main, T.static.Program()):
            x = T.static.data("x", [None, 4], "float32")
            assert type(x.shape[1]) is int and int(x.shape[1]) == 4
            assert x.size(1) == 4 and isinstance(x.size(0), capture._SymDim)
        assert type(x.shape) is torch.Size   # a plain tensor outside capture


class TestMinimize:
    def test_minimize_without_any_parameters_raises(self):
        main = T.static.Program()
        with pytest.raises(Exception, match="no parameters"):
            with T.static.program_guard(main, T.static.Program()):
                x = T.static.data("x", [2], "float32")
                T.optimizer.SGD(learning_rate=0.1).minimize((x * 2.0).mean())

    def test_minimize_parameters_narrows_eagerly(self):
        p1 = T.Parameter(torch.ones(2))
        p2 = T.Parameter(torch.ones(2))
        opt = T.optimizer.SGD(learning_rate=0.5, parameters=[p1, p2])
        opt.minimize((p1 * 2.0).sum() + (p2 * 3.0).sum(), parameters=[p1])
        assert not torch.allclose(p1.detach(), torch.ones(2))
        torch.testing.assert_close(p2.detach(), torch.ones(2))

    def test_eager_optimizer_needs_parameters(self):
        with pytest.raises(Exception, match="parameters is required"):
            T.optimizer.SGD(learning_rate=0.1)


# -- the flagship's shape at a tiny width -------------------------------------
_LLAMA = dict(vocab_size=64, hidden_size=32, intermediate_size=48, num_hidden_layers=2,
              num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=32)


class TestLlamaProgram:
    @pytest.mark.parametrize("recompute", [False, True])
    def test_replay_equals_an_eager_twin_bit_for_bit(self, recompute):
        S = 12
        cfg = LlamaConfig(recompute=recompute, **_LLAMA)
        main = T.static.Program()
        with T.static.program_guard(main):
            ids = T.static.data("input_ids", [None, S], "int64")
            labels = T.static.data("labels", [None, S], "int64")
            model = LlamaForCausalLM(cfg, device="cpu", seed=1)
            model.train()
            loss, _ = model(ids, labels=labels)
            loss.name = "loss"
            T.optimizer.AdamW(learning_rate=1e-2, parameters=model.parameters(),
                              multi_precision=True).minimize(loss)
        kinds = [p[0].__name__ for k, p, _, _ in main._ops if k == "call"
                 and hasattr(p[0], "__name__")]
        assert kinds.count("recompute") == (2 if recompute else 0)
        twin = LlamaForCausalLM(cfg, device="cpu", seed=1)
        twin.train()
        topt = T.optimizer.AdamW(learning_rate=1e-2, parameters=twin.parameters(),
                                 multi_precision=True)
        r = np.random.RandomState(0)
        x, y = r.randint(0, 64, (3, S)), r.randint(0, 64, (3, S))
        exe = T.static.Executor()
        for _ in range(3):
            (lv,) = exe.run(main, feed={"input_ids": x, "labels": y}, fetch_list=["loss"])
            ref, _ = twin(torch.from_numpy(x), labels=torch.from_numpy(y))
            ref.backward()
            topt.step()
            topt.clear_grad()
            assert float(lv) == ref.item()
        for (n, p), q in zip(model.named_parameters(), twin.parameters()):
            assert torch.equal(p.detach(), q.detach()), n

    def test_replayed_logits_match_jax(self):
        paddle.seed(0)
        jm = JaxLlama(JaxConfig(**_LLAMA))
        jm.eval()
        state = {k: _np(v) for k, v in jm.state_dict().items()}
        tm = llama_from_numpy(state, LlamaConfig(**_LLAMA), device="cpu")
        main = T.static.Program()
        with T.static.program_guard(main):
            ids = T.static.data("ids", [None, 10], "int64")
            logits = tm(ids)
            logits.name = "logits"
        x = np.random.RandomState(2).randint(0, 64, (4, 10))
        (got,) = T.static.Executor().run(main, feed={"ids": x}, fetch_list=["logits"])
        np.testing.assert_allclose(got, _np(jm(paddle.to_tensor(x))), rtol=1e-4, atol=1e-4)


# -- static.amp ----------------------------------------------------------------
def _amp_build(P, lr=0.05, decorate_kw=None, jnet=None):
    P.seed(0)
    main = P.static.Program()
    with P.static.program_guard(main):
        x = P.static.data("x", [None, 8], "float32")
        y = P.static.data("y", [None, 1], "float32")
        net = P.nn.Linear(8, 1)
        if jnet is not None:
            _carry(jnet, net)
        loss = ((net(x) - y) ** 2).mean()
        loss.name = "loss"
        opt = P.optimizer.SGD(learning_rate=lr, parameters=net.parameters())
        dec = P.static.amp.decorate(opt, **(decorate_kw or {}))
        dec.minimize(loss)
    return main, net, dec


def _regress(P, main, n_steps=30):
    exe = P.static.Executor()
    r = np.random.RandomState(0)
    x = r.randn(64, 8).astype("float32")
    y = (x @ r.randn(8, 1).astype("float32")).astype("float32")
    return [float(exe.run(main, feed={"x": x, "y": y}, fetch_list=["loss"])[0])
            for _ in range(n_steps)]


class TestStaticAmp:
    @pytest.mark.parametrize("kw,tol", [
        ({}, 5e-3), (dict(use_bf16=True, use_dynamic_loss_scaling=False), 2e-2),
        (dict(amp_lists="black"), 5e-3)])
    def test_trains_to_the_jax_losses(self, kw, tol):
        mains = []
        jnet = None
        for P in BOTH:
            kw_p = dict(kw)
            if kw_p.get("amp_lists") == "black":
                kw_p["amp_lists"] = P.static.amp.AutoMixedPrecisionLists(
                    custom_black_list=["matmul_v2", "matmul", "linear"])
            main, net, dec = _amp_build(P, decorate_kw=kw_p, jnet=jnet)
            jnet = net if P is paddle else jnet
            if kw.get("use_bf16"):
                assert dec._scaler is None and main._amp_ctx["dtype"] == "bfloat16"
            elif not kw:
                assert dec._scaler is not None and main._amp_ctx["dtype"] == "float16"
            mains.append(main)
        ref, got = (_regress(P, main, 12) for P, main in zip(BOTH, mains))
        assert got[-1] < got[0] * 0.5
        np.testing.assert_allclose(got, ref, rtol=tol, atol=tol)

    def test_bf16_namespace(self):
        bf16 = T.static.amp.bf16
        lists = bf16.AutoMixedPrecisionListsBF16(custom_bf16_list=["matmul"])
        assert lists.dtype == "bfloat16" and "matmul" in lists.white_list
        main = T.static.Program()
        with T.static.program_guard(main):
            x = T.static.data("x", [None, 4], "float32")
            net = T.nn.Linear(4, 2)
            out = net(x).sum()
            out.name = "s"
            dec = bf16.decorate_bf16(T.optimizer.SGD(learning_rate=0.01,
                                                     parameters=net.parameters()))
            dec.minimize(out)
        (v,) = T.static.Executor().run(main, feed={"x": np.ones((2, 4), "float32")},
                                       fetch_list=["s"])
        assert np.isfinite(v)

    def test_o2_amp_init_casts_parameters(self):
        main, net, dec = _amp_build(T, decorate_kw=dict(use_bf16=True, use_pure_fp16=True,
                                                        use_dynamic_loss_scaling=False))
        dec.amp_init(place=None)
        assert net.weight.dtype == torch.bfloat16
        losses = _regress(T, main, n_steps=10)
        assert losses[-1] < losses[0]

    def test_fp16_guard_casts_inside(self):
        with T.static.amp.fp16_guard():
            out = T.matmul(torch.ones(4, 4), torch.ones(4, 4))
        assert out.dtype == torch.float16

    def test_o2_fp16_scaler_not_defeated_by_replay_context(self):
        main, net, dec = _amp_build(T, lr=0.01, decorate_kw=dict(
            use_pure_fp16=True, init_loss_scaling=2.0 ** 15))
        dec.amp_init()
        losses = _regress(T, main, n_steps=12)
        assert losses[-1] < losses[0] * 0.9, losses
        assert float(dec._scaler._scale) >= 1.0


# -- the rest of the static surface -------------------------------------------
class TestStaticSurface:
    def test_top_level_and_base_names(self):
        for name in ("static", "base", "enable_static", "disable_static", "in_static_mode"):
            assert hasattr(T, name)
        assert T.base.Program is T.static.Program and T.base.Executor is T.static.Executor
        assert T.base.in_dygraph_mode()
        assert T.static.cpu_places(2) == ["cpu", "cpu"]
        assert T.static.cuda_places() == ["gpu:0"]

    def test_gradients_and_append_backward(self):
        x = torch.tensor([1.0, 2.0], requires_grad=True)
        (g,) = T.static.gradients((x * x).sum(), x)
        torch.testing.assert_close(g, 2 * x.detach())
        p = T.Parameter(torch.tensor([3.0]))
        pairs = T.static.append_backward((p * 2).sum(), parameter_list=[p])
        torch.testing.assert_close(pairs[0][1], torch.tensor([2.0]))
        main = T.static.Program()
        with T.static.program_guard(main):
            x = T.static.data("x", [1], "float32")
            q = T.Parameter(torch.tensor([1.0]))
            T.static.append_backward((x * q).sum(), parameter_list=[q])
        T.static.Executor().run(main, feed={"x": np.array([4.0], "float32")})
        torch.testing.assert_close(q.grad, torch.tensor([4.0]))

    def test_print_is_recorded_and_passes_through(self, capsys):
        main = T.static.Program()
        with T.static.program_guard(main):
            x = T.static.data("x", [None], "float32")
            y = T.static.Print(x, message="seen") * 2.0
            y.name = "y"
        (got,) = T.static.Executor().run(main, feed={"x": np.array([1.0, 2.0], "float32")},
                                         fetch_list=["y"])
        np.testing.assert_allclose(got, [2.0, 4.0])
        assert "seen shape=(2,)" in capsys.readouterr().out

    def test_ema_matches_jax(self):
        vals = []
        for P in BOTH:
            w = P.create_parameter([3], "float32")
            ema = P.static.ExponentialMovingAverage(decay=0.5)
            for v in (1.0, 3.0):
                if P is T:
                    with torch.no_grad():
                        w.fill_(v)
                else:
                    w._replace_value(paddle.full([3], v).value)
                ema.update([w])
            ema.apply()
            applied = _np(w).copy()
            ema.restore()
            vals.append((applied, _np(w).copy()))
        np.testing.assert_allclose(vals[1][0], vals[0][0])
        np.testing.assert_allclose(vals[1][1], vals[0][1])

    def test_save_load_and_program_state(self, tmp_path):
        net = T.nn.Linear(3, 2)
        T.static.save(net, str(tmp_path / "m"))
        state = T.static.load_program_state(str(tmp_path / "m"))
        assert set(state) == set(net.state_dict())
        other = T.nn.Linear(3, 2)
        T.static.set_program_state(other, state)
        torch.testing.assert_close(other.weight, net.weight)
        third = T.nn.Linear(3, 2)
        T.static.load(third, str(tmp_path / "m"))
        torch.testing.assert_close(third.bias, net.bias)
        with pytest.raises(TypeError):
            T.static.save(object(), str(tmp_path / "x"))

    def test_serialize_family(self, tmp_path):
        x = T.static.create_global_var([2], 1.0, "float32", name="gv")
        desc = T.static.deserialize_program(T.static.serialize_program([x], [x]))
        assert desc == {"feed": ["gv"], "fetch": ["gv"]}
        net = T.nn.Linear(2, 2)
        blob = T.static.serialize_persistables([x], [x], layer=net)
        path = str(tmp_path / "p.bin")
        T.static.save_to_file(path, blob)
        got = T.static.deserialize_persistables(None, T.static.load_from_file(path))
        np.testing.assert_array_equal(got["weight"], net.weight.detach().numpy())
        with pytest.raises(ValueError):
            T.static.serialize_persistables([x], [x])

    def test_create_parameter_and_global_var(self):
        w = T.static.create_parameter([3, 4], "float32", name="w0")
        assert w.requires_grad and w.name == "w0" and w.shape == (3, 4)
        b = T.static.create_parameter([4], "float32", is_bias=True)
        assert torch.count_nonzero(b) == 0
        g = T.static.create_global_var([2, 2], 7.0, "int64", persistable=True, name="g")
        assert g.dtype == torch.int64 and int(g.sum()) == 28 and g.persistable

    def test_accuracy_auc_and_ctr_bundle_match_jax(self):
        r = np.random.RandomState(0)
        logits = r.randn(20, 5).astype("float32")
        lab = r.randint(0, 5, (20, 1)).astype("int64")
        for k in (1, 2):
            np.testing.assert_allclose(
                _np(T.static.accuracy(torch.from_numpy(logits), torch.from_numpy(lab), k=k)),
                _np(paddle.static.accuracy(paddle.to_tensor(logits), paddle.to_tensor(lab),
                                           k=k)))
        probs = r.rand(50).astype("float32")
        blab = r.randint(0, 2, 50).astype("int64")
        got = T.static.auc(torch.from_numpy(probs), torch.from_numpy(blab))[0]
        ref = paddle.static.auc(paddle.to_tensor(probs), paddle.to_tensor(blab))[0]
        np.testing.assert_allclose(_np(got), _np(ref), rtol=1e-6)
        p = r.rand(6).astype("float32")
        lb = r.randint(0, 2, 6).astype("float32")
        for a, b in zip(T.static.ctr_metric_bundle(torch.from_numpy(p), torch.from_numpy(lb)),
                        paddle.static.ctr_metric_bundle(paddle.to_tensor(p),
                                                        paddle.to_tensor(lb))):
            np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6)

    def test_inference_model_round_trip(self, tmp_path):
        net = T.nn.Sequential(T.nn.Linear(4, 8), T.nn.ReLU(), T.nn.Linear(8, 2))
        net.eval()
        spec = [T.static.InputSpec([None, 4], "float32", "x")]
        T.static.save_inference_model(str(tmp_path / "inf"), spec, net)
        prog, feeds, fn = T.static.load_inference_model(str(tmp_path / "inf"), device="cpu")
        assert isinstance(prog, T.static.Program) and feeds == []
        x = torch.from_numpy(np.random.RandomState(0).randn(3, 4).astype("float32"))
        torch.testing.assert_close(fn(x), net(x))
        with pytest.raises(ValueError, match="exports a Layer"):
            T.static.save_inference_model(str(tmp_path / "bad"), spec, None)

    def test_compiled_program_and_build_strategy(self):
        main = T.static.Program()
        with T.static.program_guard(main):
            x = T.static.data("x", [2], "float32")
            (x + 1.0).name = "y"
        bs = T.static.BuildStrategy()
        assert bs.reduce_strategy == T.static.BuildStrategy.ReduceStrategy.AllReduce
        (got,) = T.static.Executor().run(T.static.CompiledProgram(main, bs),
                                         feed={"x": np.zeros(2, "float32")}, fetch_list=["y"])
        np.testing.assert_allclose(got, [1.0, 1.0])
        assert T.static.normalize_program(main, None, None)._train_hooks == []

    def test_to_static_inside_a_guard_is_one_entry(self):
        f = T.jit.to_static(lambda x: torch.relu(x) * 3.0)
        main = T.static.Program()
        with T.static.program_guard(main):
            x = T.static.data("x", [None, 3], "float32")
            y = f(x)
            y.name = "y"
        assert len(main._ops) == 1
        xv = np.array([[-1.0, 2.0, 0.5]], "float32")
        (got,) = T.static.Executor().run(main, feed={"x": xv}, fetch_list=["y"])
        np.testing.assert_allclose(got, np.maximum(xv, 0) * 3.0)
