"""Master gradients (``amp.decorate(level="O2", master_grad=True)``) of the port
against the JAX package's, on the 2-layer LLaMA of ``test_torch_amp.py``.

Tolerances, stated once: a gradient within 2e-2 (bfloat16) or 5e-3 (float16)
norm-relative of the JAX one, and losses to the same bound relative, as in
``test_torch_amp.py``: both packages run each op's pullback again in float32
at the same reduced-precision inputs, so they differ only where each
package's CPU kernels round the forward's reduced-precision products.
"""
import numpy as np
import pytest
import torch
from test_torch_amp import TOL, _batch, _CFG, _jax_grads, _llamas, _norm_rel

import paddle_tpu as paddle
import paddle_tpu_torch as T
from paddle_tpu.amp import debugging as jdbg
from paddle_tpu.autograd import tape as jtape
from paddle_tpu_torch.amp import debugging as tdbg
from paddle_tpu_torch.autograd import master_grad as tmaster
from paddle_tpu_torch.device import _CURRENT
from paddle_tpu_torch.models import LlamaConfig, llama_from_numpy, llama_to_numpy
from paddle_tpu_torch.models.convert import name_map
from paddle_tpu_torch.optimizer import AdamW

DTYPES = ["bfloat16", "float16"]
#: a loss scale at which the 2-layer model's float16 pullback overflows
#: (2**15 does not at this width): the scale op's own float16 factor is inf
OVERFLOW_SCALE = 2.0 ** 18


@pytest.fixture(autouse=True)
def _clean():
    before = _CURRENT[0]
    T.set_device("cpu")
    yield
    _CURRENT[0] = before
    jtape.set_master_grad(False)
    tmaster.set_master_grad(False)
    for dbg in (jdbg, tdbg):
        dbg._OP_STATS[0] = None


def _step(P, model, dtype, seed, scale=None):
    ids, labels = _batch(seed)
    cv = paddle.to_tensor if P is paddle else torch.from_numpy
    with P.amp.auto_cast(level="O2", dtype=dtype):
        loss, _ = model(cv(ids), labels=cv(labels))
    (loss if scale is None else P.scale(loss, scale=scale)).backward()
    return loss


def _decorated(dtype, master_grad=True, seed=5, **cfg):
    jm, tm = _llamas(seed=seed)
    if cfg:
        state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
        tm = llama_from_numpy(state, LlamaConfig(**_CFG, **cfg), device="cpu")
        tm.train()
    paddle.amp.decorate(jm, level="O2", dtype=dtype, master_grad=master_grad)
    T.amp.decorate(tm, level="O2", dtype=dtype, master_grad=master_grad)
    return jm, tm


def _finite(grads):
    return all(np.isfinite(g).all() for g in grads.values())


class TestLlama:
    @pytest.mark.parametrize("dtype", DTYPES)
    def test_leaf_gradients_are_float32_and_match_jax(self, dtype):
        jm, tm = _decorated(dtype)
        jl, tl = _step(paddle, jm, dtype, 7), _step(T, tm, dtype, 7)
        np.testing.assert_allclose(tl.float().item(), float(np.asarray(
            jl.numpy(), np.float32)), rtol=TOL[dtype])
        assert {p.grad.dtype for p in tm.parameters()} == {torch.float32}
        assert {p.dtype for p in tm.parameters()} == {getattr(torch, dtype)}
        assert {np.dtype(p.grad.dtype).name for p in jm.parameters()} == {"float32"}
        jg, tg = _jax_grads(jm), llama_to_numpy(tm, grads=True)
        for name, ref in jg.items():
            assert _norm_rel(tg[name], ref) <= TOL[dtype], name

    @pytest.mark.parametrize("dtype", DTYPES)
    def test_master_gradients_are_closer_to_float32_than_reduced_ones(self, dtype):
        """The float32 pullback beats the reduced one: summed over the
        parameters, the port's master gradients are closer to JAX's master
        gradients than the port's reduced-precision gradients are."""
        jm, tm = _decorated(dtype)
        _step(paddle, jm, dtype, 7)
        _step(T, tm, dtype, 7)
        _, tr = _decorated(dtype, master_grad=False)
        _step(T, tr, dtype, 7)
        jg = _jax_grads(jm)
        tg, rg = llama_to_numpy(tm, grads=True), llama_to_numpy(tr, grads=True)
        total_master = sum(_norm_rel(tg[n], r) for n, r in jg.items())
        total_reduced = sum(_norm_rel(rg[n], r) for n, r in jg.items())
        assert total_master < total_reduced

    @pytest.mark.parametrize("dtype", DTYPES)
    def test_three_adamw_steps_follow_jax(self, dtype):
        jm, tm = _llamas(seed=3)
        jopt = paddle.optimizer.AdamW(learning_rate=1e-3, parameters=jm.parameters())
        topt = AdamW(learning_rate=1e-3, parameters=tm.parameters())
        paddle.amp.decorate(jm, jopt, level="O2", dtype=dtype, master_grad=True)
        T.amp.decorate(tm, topt, level="O2", dtype=dtype, master_grad=True)
        jl, tl = [], []
        for s in range(3):
            jloss = _step(paddle, jm, dtype, 10 + s)
            jopt.step()
            jopt.clear_grad()
            tloss = _step(T, tm, dtype, 10 + s)
            assert {p.grad.dtype for p in tm.parameters()} == {torch.float32}
            topt.step()
            topt.clear_grad()
            jl.append(float(np.asarray(jloss.numpy(), np.float32)))
            tl.append(tloss.float().item())
        np.testing.assert_allclose(tl, jl, rtol=TOL[dtype])
        tparams = dict(tm.named_parameters())
        for jname, jp in jm.named_parameters():
            tname, transpose = name_map(tm.config)[jname]
            tp = tparams[tname]
            master = topt._master_weights[id(tp)].numpy()
            jmaster = np.asarray(jopt._master_weights[id(jp)])
            assert _norm_rel(master.T if transpose else master, jmaster) <= TOL[dtype], jname

    def test_scaled_loss_overflows_without_the_mode_only(self):
        """float16 with the loss scaled past float16's range: the pullback
        overflows without master grad, in both packages; with it every
        gradient is finite and equal to JAX's."""
        for master_grad in (False, True):
            jm, tm = _decorated("float16", master_grad=master_grad)
            _step(paddle, jm, "float16", 7, scale=OVERFLOW_SCALE)
            _step(T, tm, "float16", 7, scale=OVERFLOW_SCALE)
            jg, tg = _jax_grads(jm), llama_to_numpy(tm, grads=True)
            assert _finite(jg) == _finite(tg) == master_grad
            if master_grad:
                for name, ref in jg.items():
                    assert _norm_rel(tg[name], ref) <= TOL["float16"], name

    def test_grad_scaler_steps_with_the_mode_and_skips_without(self):
        for master_grad in (False, True):
            _, tm = _decorated("float16", master_grad=master_grad)
            opt = AdamW(learning_rate=1e-3, parameters=tm.parameters())
            scaler = T.amp.GradScaler(init_loss_scaling=OVERFLOW_SCALE)
            ids, labels = _batch(7)
            with T.amp.auto_cast(level="O2", dtype="float16"):
                loss, _ = tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
            scaler.scale(loss).backward()
            before = [p.detach().clone() for p in tm.parameters()]
            scaler.step(opt)
            scaler.update()
            moved = any(not torch.equal(b, p) for b, p in zip(before, tm.parameters()))
            assert moved == master_grad
            assert scaler._scale == (OVERFLOW_SCALE if master_grad else OVERFLOW_SCALE / 2)

    def test_operator_stats_equal_jax_under_the_mode(self):
        jm, tm = _decorated("bfloat16")
        ids, labels = _batch(1)
        jdbg.enable_operator_stats_collection()
        with paddle.amp.auto_cast(level="O2", dtype="bfloat16"):
            jloss, _ = jm(paddle.to_tensor(ids), labels=paddle.to_tensor(labels))
        jloss.backward()
        jtable = dict(jdbg.operator_stats())
        tdbg.enable_operator_stats_collection()
        with T.amp.auto_cast(level="O2", dtype="bfloat16"):
            tloss, _ = tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
        tloss.backward()
        ttable = dict(tdbg.operator_stats())
        assert ttable == jtable

    def test_recompute_under_the_mode_equals_no_recompute(self):
        """``full`` recompute reruns each layer's forward (and its ops'
        float32 pullbacks) under the mode: gradients bit for bit those of
        the plain run."""
        grads = []
        for recompute in (False, True):
            _, tm = _decorated("bfloat16", recompute=recompute)
            _step(T, tm, "bfloat16", 9)
            grads.append(llama_to_numpy(tm, grads=True))
        for name in grads[0]:
            np.testing.assert_array_equal(grads[1][name], grads[0][name])

    def test_decorate_without_master_grad_turns_the_mode_off(self):
        _, tm = _decorated("bfloat16")
        assert tmaster.master_grad_enabled()
        assert {p.grad_dtype for p in tm.parameters()} == {torch.float32}
        T.amp.decorate(tm, level="O2", dtype="bfloat16", master_grad=False)
        assert not tmaster.master_grad_enabled()
        assert {p.grad_dtype for p in tm.parameters()} == {torch.bfloat16}
        _step(T, tm, "bfloat16", 7)
        assert {p.grad.dtype for p in tm.parameters()} == {torch.bfloat16}


class TestOps:
    def _both(self, fn, arrays, dtype, scale=1.0):
        out = []
        for P in (paddle, T):
            xs = [P.to_tensor(a, place="cpu", stop_gradient=False) for a in arrays]
            with (jtape.master_grad() if P is paddle else tmaster.master_grad()):
                y = fn(P, *[P.cast(x, dtype) for x in xs])
                P.scale(P.sum(P.cast(y, "float32")), scale=scale).backward()
            out.append([np.asarray(x.grad.numpy() if P is paddle else x.grad.numpy())
                        for x in xs])
        return out

    @pytest.mark.parametrize("dtype", DTYPES)
    def test_float32_cotangents_through_a_cast_chain(self, dtype):
        """float32 leaves -> cast to the low dtype -> multiply -> cast back ->
        sum -> scaled by 2**20 in float32: the cotangents pass 65504, which
        float16 cannot hold; under the mode they stay float32 through every
        cast and op."""
        r = np.random.RandomState(0)
        a, b = r.standard_normal((3, 4)).astype(np.float32), r.standard_normal(
            (3, 4)).astype(np.float32)
        (ja, jb), (ta, tb) = self._both(
            lambda P, x, y: P.multiply(x, y), [a, b], dtype, scale=2.0 ** 20)
        for t, j in ((ta, ja), (tb, jb)):
            assert np.isfinite(t).all() and np.isfinite(j).all()
            np.testing.assert_allclose(t, j, rtol=TOL[dtype])

    def test_fan_out_sums_float32_cotangents(self):
        r = np.random.RandomState(1)
        a = r.standard_normal((4,)).astype(np.float32)
        (ja,), (ta,) = self._both(
            lambda P, x: P.add(P.multiply(x, x), P.exp(x)), [a], "bfloat16")
        np.testing.assert_allclose(ta, ja, rtol=TOL["bfloat16"])

    def test_float32_ops_are_untouched(self):
        """An op whose inputs are all float32 runs without the master node:
        its gradient is the plain one bit for bit."""
        x = torch.randn(5, requires_grad=True)
        with tmaster.master_grad():
            y = T.exp(T.multiply(x, x))
            assert "MasterFn" not in type(y.grad_fn).__name__
            T.sum(y).backward()
        ref = x.detach().clone().requires_grad_(True)
        torch.exp(ref * ref).sum().backward()
        assert torch.equal(x.grad, ref.grad)


def test_paddle_grad_under_the_mode_matches_jax():
    """``paddle.grad`` under the mode: the pullbacks run in float32 and a
    float32-gradient parameter's gradient comes back float32, as in JAX."""
    r = np.random.RandomState(8)
    w_np, x_np = (r.standard_normal((4, 3)).astype(np.float32) for _ in range(2))
    out = []
    for P, ctx in ((paddle, jtape.master_grad), (T, tmaster.master_grad)):
        w = P.to_tensor(w_np, place="cpu", stop_gradient=False)
        if P is T:
            w.data = w.data.to(torch.bfloat16)
            w.grad_dtype = torch.float32
        else:
            w = paddle.cast(w, "bfloat16")
            w.stop_gradient = False
        with ctx():
            y = P.sum(P.cast(P.exp(P.multiply(w, P.cast(P.to_tensor(x_np, place="cpu"),
                                                         "bfloat16"))), "float32"))
            (g,) = P.grad(y, w)
        out.append(g)
    jg, tg = out
    assert str(tg.dtype) == "torch.float32" and np.dtype(jg.dtype).name == "float32"
    assert _norm_rel(tg.numpy(), np.asarray(jg.numpy())) <= TOL["bfloat16"]
