"""paddle.amp of the port (``auto_cast``, ``decorate``, ``GradScaler``) against
the JAX package's, on the same numpy weights and inputs.

Tolerances, stated once: the operator-stats tables are equal (every op's
calls by output dtype, the AMP casts included); a low-dtype loss agrees to
2e-2 relative at bfloat16 and 5e-3 at float16 (op_test's bfloat16 bound, and
float16's three more mantissa bits); each gradient to the same bound,
norm-relative (||port - jax|| / ||jax||), since both packages round the same
products to the low dtype, each on its own CPU kernels, and a value on a
rounding boundary may land one low-dtype step apart.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as T
from paddle_tpu.amp import debugging as jdbg
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch import jit
from paddle_tpu_torch.amp import amp_lists
from paddle_tpu_torch.amp import debugging as tdbg
from paddle_tpu_torch.device import _CURRENT
from paddle_tpu_torch.models import LlamaConfig, llama_from_numpy, llama_to_numpy
from paddle_tpu_torch.models.convert import name_map
from paddle_tpu_torch.ops import _apply
from paddle_tpu_torch.optimizer import AdamW

TOL = {"bfloat16": 2e-2, "float16": 5e-3}
_CFG = dict(vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=32)


@pytest.fixture(autouse=True)
def _clean():
    before = _CURRENT[0]
    T.set_device("cpu")
    yield
    _CURRENT[0] = before
    for dbg in (jdbg, tdbg):
        dbg._OP_STATS[0] = None
    torch._dynamo.reset()


def _norm_rel(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    den = np.linalg.norm(ref)
    return np.linalg.norm(a - ref) / den if den else np.linalg.norm(a)


def _categorised(name, white=(), black=()):
    opdef = _apply.get_registry().get(name)
    return (name in amp_lists.WHITE_LIST or name in amp_lists.BLACK_LIST
            or name in white or name in black
            or (opdef is not None and opdef.amp_category is not None))


def _batch(seed, shape=(2, 8)):
    r = np.random.RandomState(seed)
    ids = r.randint(0, 64, shape).astype("int64")
    labels = r.randint(0, 64, shape).astype("int64")
    labels[r.rand(*shape) < 0.25] = -100
    return ids, labels


def _llamas(seed=0):
    paddle.seed(seed)
    jm = JaxLlama(JaxConfig(**_CFG))
    jm.train()
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = llama_from_numpy(state, LlamaConfig(**_CFG), device="cpu")
    tm.train()
    return jm, tm


def _jax_grads(jm):
    return {n: None if p.grad is None else np.asarray(p.grad.numpy()).astype(np.float32)
            for n, p in jm.named_parameters()}


LEVELS = [
    ("O1", "bfloat16", None, None),
    ("O1", "float16", None, None),
    ("O2", "bfloat16", None, None),
    ("O2", "float16", None, None),
    ("O1", "bfloat16", {"swiglu", "add"}, {"matmul"}),
    ("O2", "float16", {"rms_norm"}, {"swiglu"}),
    ("OD", "bfloat16", None, None),
]
LEVEL_IDS = [f"{lv}-{dt}" + ("-custom" if w else "") for lv, dt, w, _ in LEVELS]


class TestLlamaUnderAutoCast:
    @pytest.mark.parametrize("level,dtype,white,black", LEVELS, ids=LEVEL_IDS)
    def test_stats_loss_and_gradients(self, level, dtype, white, black):
        jm, tm = _llamas()
        ids, labels = _batch(1)
        kw = dict(level=level, dtype=dtype, custom_white_list=white, custom_black_list=black)

        jdbg.enable_operator_stats_collection()
        with paddle.amp.auto_cast(**kw):
            jloss, jlogits = jm(paddle.to_tensor(ids), labels=paddle.to_tensor(labels))
        jtable = dict(jdbg.operator_stats())
        jdbg._OP_STATS[0] = None
        jloss.backward()

        tdbg.enable_operator_stats_collection()
        with T.amp.auto_cast(**kw):
            tloss, tlogits = tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
        ttable = dict(tdbg.operator_stats())
        tdbg._OP_STATS[0] = None
        tloss.backward()

        assert {k: v for k, v in ttable.items() if _categorised(k, white or (), black or ())} \
            == {k: v for k, v in jtable.items() if _categorised(k, white or (), black or ())}
        assert ttable == jtable
        assert str(tlogits.dtype).removeprefix("torch.") == np.dtype(jlogits.dtype).name
        assert str(tloss.dtype).removeprefix("torch.") == np.dtype(jloss.dtype).name
        tol = TOL[dtype]
        np.testing.assert_allclose(tloss.float().item(),
                                   float(np.asarray(jloss.numpy(), np.float32)), rtol=tol)
        jg, tg = _jax_grads(jm), llama_to_numpy(tm, grads=True)
        for name, ref in jg.items():
            assert _norm_rel(tg[name], ref) <= tol, name
            assert tg[name].dtype == np.float32

    def test_flash_attention_reaches_the_kernel_in_the_low_dtype(self, monkeypatch):
        """Under O1 the attention op's q, k and v arrive in the low dtype
        (white list), so on the card the kernel runs at bf16/fp16."""
        import importlib

        port_F = importlib.import_module("paddle_tpu_torch.nn.functional.flash_attention")
        seen = []
        real = port_F._math_sdpa

        def spy(q, k, v, *a, **kw):
            seen.append((q.dtype, k.dtype, v.dtype))
            return real(q, k, v, *a, **kw)

        monkeypatch.setattr(port_F, "_math_sdpa", spy)
        _, tm = _llamas()
        ids, labels = _batch(2)
        for dtype in ("bfloat16", "float16"):
            seen.clear()
            with T.amp.auto_cast(level="O1", dtype=dtype):
                tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
            assert seen == [(getattr(torch, dtype),) * 3] * _CFG["num_hidden_layers"]

    def test_recompute_under_auto_cast_matches_no_recompute(self):
        """The recompute of a layer runs under the AMP state of its forward,
        so its gradients are those of the plain run bit for bit."""
        grads = []
        for recompute in (False, True):
            paddle.seed(0)
            jm = JaxLlama(JaxConfig(**_CFG))
            state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
            tm = llama_from_numpy(state, LlamaConfig(recompute=recompute, **_CFG),
                                  device="cpu")
            tm.train()
            ids, labels = _batch(3)
            with T.amp.auto_cast(level="O1", dtype="bfloat16"):
                loss, _ = tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
            loss.backward()
            grads.append(llama_to_numpy(tm, grads=True))
        for name in grads[0]:
            np.testing.assert_array_equal(grads[1][name], grads[0][name])


class TestLinearReluNet:
    """The AMP recipe on a two-layer perceptron (paddle's own AMP example)."""

    @staticmethod
    def _nets(seed=0):
        paddle.seed(seed)
        j1, j2 = paddle.nn.Linear(4, 8), paddle.nn.Linear(8, 2)
        t1, t2 = T.nn.Linear(4, 8, device="cpu"), T.nn.Linear(8, 2, device="cpu")
        with torch.no_grad():
            for j, t in ((j1, t1), (j2, t2)):
                t.weight.copy_(torch.from_numpy(np.asarray(j.weight.numpy()).T.copy()))
                t.bias.copy_(torch.from_numpy(np.asarray(j.bias.numpy())))
        return (j1, j2), (t1, t2)

    @pytest.mark.parametrize("level,dtype,white,black", LEVELS[:6], ids=LEVEL_IDS[:6])
    def test_matches_jax(self, level, dtype, white, black):
        (j1, j2), (t1, t2) = self._nets()
        r = np.random.RandomState(4)
        x, y = r.randn(5, 4).astype(np.float32), r.randn(5, 2).astype(np.float32)
        kw = dict(level=level, dtype=dtype, custom_white_list=white, custom_black_list=black)
        tables, losses = [], []
        for P, dbg, l1, l2, relu in (
                (paddle, jdbg, j1, j2, paddle.nn.functional.relu),
                (T, tdbg, t1, t2, torch.relu)):
            dbg.enable_operator_stats_collection()
            with P.amp.auto_cast(**kw):
                out = l2(relu(l1(P.to_tensor(x, place="cpu"))))
                loss = P.mean(P.square(P.subtract(out, P.to_tensor(y, place="cpu"))))
            tables.append({k: v for k, v in dbg.operator_stats().items()
                           if _categorised(k, white or (), black or ())})
            dbg._OP_STATS[0] = None
            loss.backward()
            losses.append(float(np.asarray(loss.float().detach() if P is T else
                                           loss.astype("float32").numpy())))
        assert tables[0] == tables[1]
        assert {"linear", "mean", "square"} <= set(tables[1])
        np.testing.assert_allclose(losses[1], losses[0], rtol=TOL[dtype])
        for j, t in ((j1, t1), (j2, t2)):
            assert _norm_rel(t.weight.grad.numpy().T, j.weight.grad.numpy()) <= TOL[dtype]
            assert _norm_rel(t.bias.grad.numpy(), j.bias.grad.numpy()) <= TOL[dtype]


class TestAmpState:
    def test_state_helpers(self):
        for P in (paddle, T):
            assert not P.amp.is_auto_cast_enabled()
            assert P.amp.get_amp_dtype() == "float32"
            with P.amp.auto_cast(level="O2", dtype="bfloat16"):
                assert P.amp.is_auto_cast_enabled()
                assert P.amp.get_amp_dtype() == "bfloat16"
                assert P.amp.amp_state().level == "O2"
                with P.amp.auto_cast(enable=False):
                    assert not P.amp.is_auto_cast_enabled()
            with P.amp.auto_cast(level="O0"):
                assert not P.amp.is_auto_cast_enabled()
            with pytest.raises(ValueError):
                with P.amp.auto_cast(level="O3"):
                    pass
            assert P.amp.amp_state() is None
            assert P.amp.amp_guard is P.amp.auto_cast
            assert P.amp.white_list() == set(paddle.amp.amp_lists.WHITE_LIST)
            assert P.amp.black_list() == set(paddle.amp.amp_lists.BLACK_LIST)
        assert T.amp.is_bfloat16_supported() and T.amp.is_float16_supported()

    def test_lists_are_the_jax_lists(self):
        assert amp_lists.WHITE_LIST == paddle.amp.amp_lists.WHITE_LIST
        assert amp_lists.BLACK_LIST == paddle.amp.amp_lists.BLACK_LIST

    def test_cast_and_skip_are_never_cast(self):
        seen = []
        op = T.utils.register_custom_op("torch_test_amp_skip",
                                        lambda x: seen.append(x.dtype) or x,
                                        amp_category="skip")
        with T.amp.auto_cast(level="O2", dtype="bfloat16"):
            op(T.to_tensor([1.0]))
            assert T.cast(T.to_tensor([1.0]), "float16").dtype == torch.float16
        assert seen == [torch.float32]


class TestDecorate:
    def test_o2_casts_in_place_and_trains_as_jax(self):
        jm, tm = _llamas(seed=3)
        jopt = paddle.optimizer.AdamW(learning_rate=1e-3, parameters=jm.parameters())
        topt = AdamW(learning_rate=1e-3, parameters=tm.parameters())
        before = {n: (p, p.name, p.need_clip, dict(p.optimize_attr))
                  for n, p in tm.named_parameters()}
        paddle.amp.decorate(jm, jopt, level="O2", dtype="bfloat16")
        out = T.amp.decorate(tm, topt, level="O2", dtype="bfloat16")
        assert out == (tm, topt)
        assert topt._multi_precision
        for n, p in tm.named_parameters():
            assert p.dtype == torch.bfloat16
            assert before[n] == (p, p.name, p.need_clip, dict(p.optimize_attr))
        assert {str(np.dtype(p.dtype)) for p in jm.parameters()} == {"bfloat16"}
        jl, tl = [], []
        for s in range(3):
            ids, labels = _batch(10 + s)
            with paddle.amp.auto_cast(level="O2", dtype="bfloat16"):
                loss, _ = jm(paddle.to_tensor(ids), labels=paddle.to_tensor(labels))
            loss.backward()
            jopt.step()
            jopt.clear_grad()
            jl.append(float(np.asarray(loss.astype("float32").numpy())))
            with T.amp.auto_cast(level="O2", dtype="bfloat16"):
                loss, _ = tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
            loss.backward()
            topt.step()
            topt.clear_grad()
            tl.append(loss.float().item())
        np.testing.assert_allclose(tl, jl, rtol=TOL["bfloat16"])
        # the float32 masters (made from the bf16 values, as in JAX), after
        # three steps, parameter by parameter under the JAX names
        tparams = dict(tm.named_parameters())
        for jname, jp in jm.named_parameters():
            tname, transpose = name_map(tm.config)[jname]
            tp = tparams[tname]
            master = topt._master_weights[id(tp)].numpy()
            jmaster = np.asarray(jopt._master_weights[id(jp)])
            assert _norm_rel(master.T if transpose else master, jmaster) <= 1e-2, jname
            assert torch.equal(tp, topt._master_weights[id(tp)].to(torch.bfloat16))

    def test_decorate_leaves_o1_alone_and_returns_the_models(self):
        _, tm = _llamas()
        assert T.amp.decorate(tm, level="O1") is tm
        assert {p.dtype for p in tm.parameters()} == {torch.float32}

    def test_after_a_step_refuses(self):
        _, tm = _llamas()
        opt = AdamW(parameters=tm.parameters())
        loss, _ = tm(*(torch.from_numpy(a) for a in _batch(0)))
        loss.backward()
        opt.step()
        with pytest.raises(RuntimeError, match="first step"):
            T.amp.decorate(tm, opt, level="O2", dtype="bfloat16")

    def test_captured_program_refuses_stale_weights(self):
        from paddle_tpu_torch.framework import PARAM_EPOCH
        from paddle_tpu_torch.jit import _cuda_graph

        prog = _cuda_graph._Program(lambda *a: None, pools=[(torch.zeros(1),)])
        prog._graph, prog._epoch = object(), PARAM_EPOCH[0]
        prog._device = torch.device("cuda", 0)
        _, tm = _llamas()
        T.amp.decorate(tm, level="O2", dtype="bfloat16")
        with pytest.raises(RuntimeError, match="decorate"):
            prog(torch.zeros(1))


class TestGradScaler:
    # (finite?) per step: growth after 2 good steps, backoff, the floor of 1
    SCRIPT = [True, True, True, False, True, False, False, False, True, True, False]

    @staticmethod
    def _drive(P, scaler, opt, w, bad):
        x = np.array([1.0, 2.0, 3.0], np.float32)
        if bad:
            x[1] = np.inf
        loss = P.sum(P.multiply(w, P.to_tensor(x, place="cpu")))
        scaler.scale(loss).backward()
        scaler.step(opt)
        scaler.update()
        opt.clear_grad()

    def test_scale_trajectory_and_skipped_steps(self):
        trajectories = []
        w_np = np.array([0.5, -0.5, 0.25], np.float32)
        for P, opt_cls in ((paddle, paddle.optimizer.AdamW), (T, AdamW)):
            w = P.to_tensor(w_np, place="cpu", stop_gradient=False)
            opt = opt_cls(learning_rate=0.1, parameters=[w])
            scaler = P.amp.GradScaler(init_loss_scaling=4.0, incr_every_n_steps=2,
                                      decr_every_n_nan_or_inf=1)
            scales, values = [], []
            for good in self.SCRIPT:
                if P is T and opt._accumulators:
                    before = (w.detach().clone(), {k: v.clone() for k, v in
                                                   opt._accumulators[id(w)].items()},
                              opt._step_count)
                else:
                    before = None
                self._drive(P, scaler, opt, w, bad=not good)
                scales.append(scaler._scale)
                values.append(np.asarray(w.detach().numpy() if P is T else w.numpy()).copy())
                if before is not None and not good:
                    # a skipped step leaves the parameter, the moments and the
                    # step count as they were, bit for bit
                    assert torch.equal(w.detach(), before[0])
                    for k, v in opt._accumulators[id(w)].items():
                        assert torch.equal(v, before[1][k])
                    assert opt._step_count == before[2]
            trajectories.append((scales, values))
        (js, jv), (ts, tv) = trajectories
        assert ts == js
        assert min(ts) == 1.0 and max(ts) > 4.0
        for a, b in zip(tv, jv):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)

    def test_unscale_once_then_clip(self):
        w = T.to_tensor([3.0, 4.0], stop_gradient=False)
        clip = T.nn.ClipGradByGlobalNorm(1.0)
        opt = AdamW(learning_rate=0.0, parameters=[w], grad_clip=clip)
        scaler = T.amp.GradScaler(init_loss_scaling=8.0)
        scaler.scale(T.sum(T.multiply(w, w))).backward()
        scaler.unscale_(opt)
        np.testing.assert_allclose(w.grad.numpy(), [6.0, 8.0])
        scaler.unscale_(opt)  # once a step
        np.testing.assert_allclose(w.grad.numpy(), [6.0, 8.0])
        scaler.step(opt)
        scaler.update()
        assert not scaler._unscaled

    def test_state_dict_round_trip_and_minimize(self):
        for P, opt_cls in ((paddle, paddle.optimizer.AdamW), (T, AdamW)):
            w = P.to_tensor([1.0, 2.0], place="cpu", stop_gradient=False)
            opt = opt_cls(learning_rate=0.1, parameters=[w])
            a = P.amp.GradScaler(init_loss_scaling=16.0, incr_every_n_steps=3)
            a.minimize(opt, a.scale(P.sum(P.multiply(w, w))))
            b = P.amp.GradScaler()
            b.load_state_dict(a.state_dict())
            assert b.state_dict()["scale"] == a.state_dict()["scale"] == 16.0
            assert b._good_steps == a._good_steps == 1
            assert float(np.asarray(a.get_loss_scaling().numpy()) if P is paddle else
                         a.get_loss_scaling(place="cpu").item()) == 16.0

    def test_disabled_scaler_passes_through(self):
        w = T.to_tensor([1.0], stop_gradient=False)
        opt = AdamW(learning_rate=0.1, parameters=[w])
        scaler = T.amp.GradScaler(enable=False)
        loss = T.sum(w)
        assert scaler.scale(loss) is loss
        loss.backward()
        scaler.step(opt)
        assert opt._step_count == 1


class TestToStatic:
    def test_compiles_again_when_the_amp_state_changes(self):
        sf = jit.to_static(lambda x, w: T.matmul(x, w), backend="aot_eager")
        x, w = torch.randn(3, 4), torch.randn(4, 2)
        assert sf(x, w).dtype == torch.float32
        with T.amp.auto_cast(level="O1", dtype="bfloat16"):
            out = sf(x, w)
            eager = T.matmul(x, w)
        assert out.dtype == torch.bfloat16 and torch.equal(out, eager)
        ((_, backend),) = sf._cache.values()
        assert backend.graphs == 2
        assert sf(x, w).dtype == torch.float32
        assert backend.graphs == 2

    def test_o1_step_equals_eager(self):
        _, tm = _llamas(seed=5)
        ids, labels = (torch.from_numpy(a) for a in _batch(6))

        def step(ids, labels):
            with T.amp.auto_cast(level="O1", dtype="bfloat16"):
                loss, _ = tm(ids, labels=labels)
            return loss

        compiled = jit.to_static(step, backend="aot_eager")
        results = []
        for fn in (step, compiled):
            tm.zero_grad()
            loss = fn(ids, labels)
            loss.backward()
            results.append((loss.item(), llama_to_numpy(tm, grads=True)))
        (l0, g0), (l1, g1) = results
        np.testing.assert_allclose(l1, l0, rtol=1e-5)
        for name in g0:
            np.testing.assert_allclose(g1[name], g0[name], rtol=1e-5, atol=1e-6)
