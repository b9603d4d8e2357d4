"""paddle_tpu_torch.jit.to_static against paddle_tpu.jit.to_static.

The counterparts of tests/test_jit.py's to_static cases, run on both
packages with the same numpy inputs (fp32, on the CPU); the 2-layer LLaMA
under both packages' to_static (loss, every gradient, three AdamW steps);
the graph a compiled LLaMA step hands its backend (the flash-attention ops,
not a decomposed softmax); torch.library's opcheck on the kernels' ops; and
one case through the default Inductor backend.

Every port case but the Inductor one compiles with ``backend="aot_eager"``
(AOTAutograd without code generation): Inductor's first compile takes tens
of seconds on this CPU. Dynamo's caches are reset before each test, so the
code objects the tests share start from no compiled entry.
"""
import importlib

import numpy as np
import pytest
import torch
from functorch.compile import make_boxed_func
from torch._dynamo.backends.common import aot_autograd

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch import jit
from paddle_tpu_torch.models import LlamaConfig, llama_from_numpy, llama_to_numpy
from paddle_tpu_torch.ops.cuda import axpy as port_axpy
from paddle_tpu_torch.ops.cuda import flash_attention as port_fa
from paddle_tpu_torch.optimizer import SGD, AdamW

port_F = importlib.import_module("paddle_tpu_torch.nn.functional.flash_attention")
BACKEND = "aot_eager"
_SCALE = 2.0     # a global a compiled function reads (Dynamo guards on it)


@pytest.fixture(autouse=True)
def _fresh_dynamo():
    torch._dynamo.reset()
    yield
    torch._dynamo.reset()


def _t(a):
    return torch.from_numpy(np.array(a))


class SmallNet(torch.nn.Module):
    """tests/test_jit.py's SmallNet: fc1 (4 -> 8), relu, fc2 (8 -> 2)."""

    def __init__(self):
        super().__init__()
        self.fc1 = torch.nn.Linear(4, 8)
        self.fc2 = torch.nn.Linear(8, 2)

    def forward(self, x):
        return self.fc2(torch.relu(self.fc1(x)))


class JaxSmallNet(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.fc1 = jnn.Linear(4, 8)
        self.fc2 = jnn.Linear(8, 2)

    def forward(self, x):
        return self.fc2(paddle.nn.functional.relu(self.fc1(x)))


def _small_pair(seed=7):
    """(JAX SmallNet, port SmallNet) holding the same weights (paddle's
    Linear weight is (in, out), torch's (out, in))."""
    paddle.seed(seed)
    jm = JaxSmallNet()
    tm = SmallNet()
    with torch.no_grad():
        for name in ("fc1", "fc2"):
            jl, tl = getattr(jm, name), getattr(tm, name)
            tl.weight.copy_(_t(jl.weight.numpy()).T)
            tl.bias.copy_(_t(jl.bias.numpy()))
    return jm, tm


class TestToStatic:
    def test_function_matches_jax(self):
        def f(x, y):
            return torch.matmul(x, y) + x.sum()

        def jf(x, y):
            return paddle.matmul(x, y) + x.sum()

        sf, jsf = jit.to_static(f, backend=BACKEND), paddle.jit.to_static(jf)
        xn = np.random.RandomState(0).randn(3, 3).astype(np.float32)
        ref = jsf(paddle.to_tensor(xn), paddle.to_tensor(xn)).numpy()
        out = sf(_t(xn), _t(xn))
        # fp32 sums in another order: 1e-5
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)
        out2 = sf(_t(xn), _t(xn))
        np.testing.assert_array_equal(out2.numpy(), out.numpy())
        assert len(sf._cache) == 1 == len(jsf._cache)

    def test_layer_trains_like_jax(self):
        """Five SGD steps of SmallNet under to_static: the losses against the
        JAX package's to_static losses (1e-4)."""
        r = np.random.RandomState(1)
        xn, yn = r.randn(8, 4).astype(np.float32), r.randn(8, 2).astype(np.float32)
        jm, tm = _small_pair()
        jm, tm = paddle.jit.to_static(jm), jit.to_static(tm, backend=BACKEND)
        jopt = paddle.optimizer.SGD(learning_rate=0.1, parameters=jm.parameters())
        topt = SGD(learning_rate=0.1, parameters=tm.parameters())
        jl, tl = [], []
        for _ in range(5):
            loss = ((jm(paddle.to_tensor(xn)) - paddle.to_tensor(yn)) ** 2).mean()
            loss.backward()
            jopt.step()
            jopt.clear_grad()
            jl.append(float(loss))
            loss = ((tm(_t(xn)) - _t(yn)) ** 2).mean()
            loss.backward()
            topt.step()
            topt.clear_grad()
            tl.append(loss.item())
        np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-4)
        assert len(tm.forward._cache) == 1

    def test_recompiles_on_new_shape(self):
        sf = jit.to_static(lambda x: x * 2, backend=BACKEND)
        jsf = paddle.jit.to_static(lambda x: x * 2)
        for shape in ((2, 2), (3, 2)):
            xn = np.ones(shape, np.float32)
            np.testing.assert_array_equal(sf(_t(xn)).numpy(), jsf(paddle.to_tensor(xn)).numpy())
        assert len(sf._cache) == 2 == len(jsf._cache)

    def test_buffer_update_through_the_compiled_call(self):
        """BatchNorm's running statistics move through the compiled call as
        they do eagerly (bit for bit), and the running mean as the JAX
        package's to_static moves it (1e-5)."""
        xn = np.random.RandomState(2).randn(16, 4).astype(np.float32) * 3 + 1
        eager = torch.nn.BatchNorm1d(4)
        compiled = jit.to_static(torch.nn.BatchNorm1d(4), backend=BACKEND)

        class BNNet(jnn.Layer):
            def __init__(self):
                super().__init__()
                self.bn = jnn.BatchNorm1D(4)

            def forward(self, x):
                return self.bn(x)

        jm = paddle.jit.to_static(BNNet())
        before = compiled.running_mean.clone()
        with torch.no_grad():
            eager(_t(xn))
            compiled(_t(xn))
        with paddle.no_grad():
            jm(paddle.to_tensor(xn))
        assert not torch.equal(before, compiled.running_mean)
        np.testing.assert_array_equal(compiled.running_mean.numpy(), eager.running_mean.numpy())
        np.testing.assert_array_equal(compiled.running_var.numpy(), eager.running_var.numpy())
        np.testing.assert_allclose(compiled.running_mean.numpy(), jm.bn._mean.numpy(),
                                   rtol=1e-5, atol=1e-5)

    def test_recompile_past_the_limit_raises(self):
        """Under full_graph=True a signature whose guards make Dynamo
        recompile past its limit (a global the function reads, changed
        between calls; JAX would keep the first trace) raises instead of
        running eagerly. New signatures do not count against the limit."""
        global _SCALE
        sf = jit.to_static(lambda x: x * _SCALE, backend=BACKEND)
        with torch._dynamo.config.patch(recompile_limit=2):
            for n in (2, 3, 4):
                sf(torch.ones(n))
            _SCALE = 3.0
            sf(torch.ones(2))
            _SCALE = 4.0
            with pytest.raises(torch._dynamo.exc.FailOnRecompileLimitHit):
                sf(torch.ones(2))
        _SCALE = 2.0
        assert len(sf._cache) == 3

    @pytest.mark.parametrize("layer", [False, True], ids=["function", "layers"])
    def test_ten_signatures_compile_ten_programs(self, layer):
        """Ten input shapes (past Dynamo's default recompile_limit of 8) give
        ten programs, as JAX's to_static caches ten, with equal outputs
        (1e-5). With ``layer``, each shape goes to its own to_static'd
        SmallNet: ten StaticFunctions of one forward code object."""
        rng = np.random.RandomState(7)
        xs = [rng.randn(n + 1, 4).astype(np.float32) for n in range(10)]
        if layer:
            nets = [_small_pair(seed=40 + i) for i in range(10)]
            ports = [jit.to_static(m, backend=BACKEND) for _, m in nets]
            jaxs = [paddle.jit.to_static(j) for j, _ in nets]
            got = [m(_t(x)) for m, x in zip(ports, xs)]
            want = [j(paddle.to_tensor(x)) for j, x in zip(jaxs, xs)]
            assert all(len(m.forward._cache) == 1 for m in ports)
        else:
            sf = jit.to_static(lambda x: torch.tanh(x) * 2.0 + 1.0, backend=BACKEND)
            jf = paddle.jit.to_static(lambda x: paddle.tanh(x) * 2.0 + 1.0)
            got = [sf(_t(x)) for x in xs]
            want = [jf(paddle.to_tensor(x)) for x in xs]
            assert len(sf._cache) == len(jf._cache) == 10
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.detach().numpy(), w.numpy(), rtol=1e-5, atol=1e-5)

    def test_dropout_differs_between_calls(self):
        class DropNet(torch.nn.Module):
            def forward(self, x):
                return torch.nn.functional.dropout(x, p=0.5, training=True)

        m = jit.to_static(DropNet(), backend=BACKEND)
        x = torch.ones(64)
        a, b = m(x), m(x)
        assert not torch.equal(a, b), "dropout mask must differ across compiled calls"
        assert set(a.unique().tolist()) <= {0.0, 2.0}

    def test_enable_rollback_and_not_to_static(self):
        calls = []

        @jit.not_to_static
        def helper(x):
            calls.append(1)
            return x + 1.0

        assert helper._not_to_static

        def f(x):
            return helper(x) * 2.0

        sf = jit.to_static(f, backend=BACKEND)
        x = torch.arange(3.0)
        np.testing.assert_array_equal(sf(x).numpy(), [2.0, 4.0, 6.0])
        assert len(sf._cache) == 1          # traced through: no graph break
        jit.enable_to_static(False)
        try:
            np.testing.assert_array_equal(sf(x + 1).numpy(), [4.0, 6.0, 8.0])
            assert len(sf._cache) == 1      # ran eagerly, compiled nothing
        finally:
            jit.enable_to_static(True)
        _, tm = _small_pair()
        tm = jit.to_static(tm, backend=BACKEND)
        assert isinstance(tm.forward, jit.StaticFunction)
        out = tm(torch.ones(2, 4))
        tm.forward.rollback()
        assert not isinstance(tm.forward, jit.StaticFunction)
        np.testing.assert_allclose(tm(torch.ones(2, 4)).detach().numpy(),
                                   out.detach().numpy(), rtol=1e-6)

    def test_exports(self):
        names = ("to_static", "StaticFunction", "InputSpec", "not_to_static",
                 "enable_to_static", "ignore_module", "set_verbosity", "set_code_level")
        assert all(hasattr(jit, n) for n in names)
        spec = jit.InputSpec([None, 4], "float32", name="x")
        assert spec.shape == [None, 4] and "x" in repr(spec)
        assert jit.ignore_module([]) is None
        jit.set_verbosity(1)
        jit.set_code_level(50)
        assert jit._LOG_STATE == {"verbosity": 1, "code_level": 50}
        jit.set_verbosity(0)
        jit.set_code_level(100)

    def test_inductor_backend_on_cpu(self):
        """The one case through the default backend (Inductor generates and
        compiles C++ for the CPU): against the JAX package's to_static, 1e-5
        (fp32, another order of operations)."""
        def f(x):
            return torch.tanh(x) * 2.0 + x.sum()

        def jf(x):
            return paddle.tanh(x) * 2.0 + x.sum()

        sf = jit.to_static(f)
        assert sf._backend == "inductor"
        xn = np.random.RandomState(3).randn(4, 5).astype(np.float32)
        np.testing.assert_allclose(sf(_t(xn)).numpy(),
                                   paddle.jit.to_static(jf)(paddle.to_tensor(xn)).numpy(),
                                   rtol=1e-5, atol=1e-5)
        assert len(sf._cache) == 1


# -- the slice: the 2-layer LLaMA under both packages' to_static ---------------
_CFG = dict(vocab_size=64, intermediate_size=64, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=256,
            hidden_size=32)


def _llama_pair(seed=0, **port_kw):
    """tests/test_torch_llama.py's ``_pair``: (JAX model, port model) holding
    the same weights, both in training mode."""
    paddle.seed(seed)
    jm = JaxLlama(JaxConfig(**_CFG))
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = llama_from_numpy(state, LlamaConfig(**_CFG, **port_kw), device="cpu")
    jm.train()
    tm.train()
    return jm, tm


def _batch(seed, shape=(2, 7)):
    r = np.random.RandomState(seed)
    ids = r.randint(0, 64, shape).astype("int64")
    labels = r.randint(0, 64, shape).astype("int64")
    labels[r.rand(*shape) < 0.25] = -100
    return ids, labels


class TestLlamaUnderToStatic:
    def test_loss_gradients_and_adamw_steps_match_jax(self):
        """Loss and every gradient of the first step (1e-4, fp32), then three
        AdamW steps' losses (1e-4): the port's to_static against the JAX
        package's."""
        jm, tm = _llama_pair()
        jm, tm = paddle.jit.to_static(jm), jit.to_static(tm, backend=BACKEND)
        ids, labels = _batch(1)
        jloss, _ = jm(paddle.to_tensor(ids), labels=paddle.to_tensor(labels))
        jloss.backward()
        jgrads = {n: np.asarray(p.grad.numpy()) for n, p in jm.named_parameters()}
        tloss, _ = tm(_t(ids), labels=_t(labels))
        tloss.backward()
        tgrads = llama_to_numpy(tm, grads=True)
        np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-4, atol=1e-4)
        assert set(tgrads) == set(jgrads)
        for name, ref in jgrads.items():
            np.testing.assert_allclose(tgrads[name], ref, rtol=1e-4, atol=1e-4, err_msg=name)
        jm.clear_gradients()
        tm.zero_grad(set_to_none=True)

        jopt = paddle.optimizer.AdamW(learning_rate=1e-3, parameters=jm.parameters())
        topt = AdamW(learning_rate=1e-3, parameters=tm.parameters())
        jl, tl = [], []
        for step in range(3):
            ids, labels = _batch(10 + step)
            loss, _ = jm(paddle.to_tensor(ids), labels=paddle.to_tensor(labels))
            loss.backward()
            jopt.step()
            jopt.clear_grad()
            jl.append(float(loss))
            loss, _ = tm(_t(ids), labels=_t(labels))
            loss.backward()
            topt.step()
            topt.clear_grad()
            tl.append(loss.item())
        np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-4)
        assert len(tm.forward._cache) == 1 == len(jm.forward._cache)


def _recording_backend(graphs):
    """An AOTAutograd backend that keeps the forward and backward graphs it
    is handed and runs them as they are."""
    def keep(kind):
        def compiler(gm, example_inputs):
            graphs.append((kind, gm))
            return make_boxed_func(gm.forward)

        return compiler

    return aot_autograd(fw_compiler=keep("fw"), bw_compiler=keep("bw"))


def _targets(gm):
    return [str(n.target) for n in gm.graph.nodes if n.op == "call_function"]


class TestTracedGraphHoldsTheKernels:
    @pytest.mark.parametrize("recompute", [False, True], ids=["plain", "recompute"])
    def test_flash_ops_not_a_decomposition(self, monkeypatch, recompute):
        """A 2-layer LLaMA step at S = 128 on the path the card takes
        (``_use_kernel`` sends the CPU model there too, where the ops run
        their plain versions): the forward graph calls the forward op once a
        layer and holds no softmax; the backward graph calls the backward op
        once a layer, and the forward op once more a layer under recompute.
        Loss and gradients equal the eager step's on the same path (1e-5)."""
        monkeypatch.setattr(port_F, "_use_kernel", lambda q: q.shape[1] >= 128)
        _, eager = _llama_pair(seed=3, recompute=recompute)
        _, tm = _llama_pair(seed=3, recompute=recompute)
        graphs = []
        tm = jit.to_static(tm, backend=_recording_backend(graphs))
        ids, labels = _batch(4, (2, 128))
        loss, _ = tm(_t(ids), labels=_t(labels))
        loss.backward()
        ref, _ = eager(_t(ids), labels=_t(labels))
        ref.backward()
        fw = [t for k, g in graphs if k == "fw" for t in _targets(g)]
        bw = [t for k, g in graphs if k == "bw" for t in _targets(g)]
        L = 2
        assert fw.count("paddle_tpu_torch.flash_attention_fwd.default") == L
        assert not any("softmax" in t and "log_softmax" not in t for t in fw), fw
        assert bw.count("paddle_tpu_torch.flash_attention_bwd.default") == L
        assert bw.count("paddle_tpu_torch.flash_attention_fwd.default") == (L if recompute else 0)
        np.testing.assert_allclose(loss.item(), ref.item(), rtol=1e-5, atol=1e-5)
        got, want = llama_to_numpy(tm, grads=True), llama_to_numpy(eager, grads=True)
        for name in want:
            np.testing.assert_allclose(got[name], want[name], rtol=1e-5, atol=1e-5,
                                       err_msg=name)


    @pytest.mark.parametrize("granularity,want", [
        ("full", (4, 2)), ("full_attn", (4, 2)), ("core_attn", (4, 2)), (None, (2, 2))],
        ids=["full", "full_attn", "core_attn", "off"])
    def test_recompute_policies_rerun_the_forward_op(self, monkeypatch, granularity, want):
        """Eager steps on the kernels' path: the selective policy sees the
        forward op by name, keeps only the products' outputs and runs the op
        again in the backward pass, as it ran the autograd Function before
        the kernels were ops: (2L, L) plain forward and backward calls a
        step under every recompute granularity, (L, L) without."""
        monkeypatch.setattr(port_F, "_use_kernel", lambda q: q.shape[1] >= 128)
        calls = {"fwd": 0, "bwd": 0}
        fwd, bwd = port_fa.flash_attention_fwd_plain, port_fa.flash_attention_bwd_plain

        def counted(name, fn):
            def run(*a):
                calls[name] += 1
                return fn(*a)

            return run

        monkeypatch.setattr(port_fa, "flash_attention_fwd_plain", counted("fwd", fwd))
        monkeypatch.setattr(port_fa, "flash_attention_bwd_plain", counted("bwd", bwd))
        kw = (dict(recompute=False) if granularity is None
              else dict(recompute=True, recompute_granularity=granularity))
        _, tm = _llama_pair(seed=5, **kw)
        ids, labels = _batch(6, (1, 128))
        loss, _ = tm(_t(ids), labels=_t(labels))
        loss.backward()
        assert (calls["fwd"], calls["bwd"]) == want


class TestLibraryOps:
    """torch.library.opcheck (schema, autograd registration, fake tensors,
    AOT dispatch) on the kernels' ops, through their CPU implementations
    (the plain versions)."""

    @pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D,causal", [
        (2, 16, 16, 4, 2, 32, True), (1, 8, 24, 2, 2, 64, False), (1, 5, 9, 4, 1, 96, True),
    ])
    def test_flash_ops(self, B, Sq, Sk, Hq, Hkv, D, causal):
        r = np.random.RandomState(B + Sq + D)
        q = _t(r.randn(B, Sq, Hq, D).astype(np.float32))
        k, v = (_t(r.randn(B, Sk, Hkv, D).astype(np.float32)) for _ in range(2))
        scale = 1.0 / np.sqrt(D)
        fwd = torch.ops.paddle_tpu_torch.flash_attention_fwd.default
        bwd = torch.ops.paddle_tpu_torch.flash_attention_bwd.default
        torch.library.opcheck(fwd, (q, k, v, causal, scale, D))
        torch.library.opcheck(fwd, tuple(t.clone().requires_grad_() for t in (q, k, v))
                              + (causal, scale, D))
        out, lse = fwd(q, k, v, causal, scale, D)
        do = torch.randn_like(out)
        torch.library.opcheck(bwd, (q, k, v, out, lse, do, causal, scale))

    @pytest.mark.parametrize("D,pads", [(80, 3), (96, 0)])
    def test_head_dim_pads_counted_in_a_compiled_call(self, D, pads):
        """The forward op counts the head-dim pad where it runs, so a
        compiled call counts as an eager one: three tensors a call at D = 80
        (padded to 96), none at 96; the output equals the eager call's
        (1e-6)."""
        r = np.random.RandomState(D)
        q, k, v = (_t(r.randn(1, 8, 2, D).astype(np.float32)) for _ in range(3))

        scale = float(1.0 / np.sqrt(D))

        def attend(q, k, v):
            return port_fa._at_native_dim(q, k, v, True, scale)[0]

        sf = jit.to_static(attend, backend=BACKEND)
        before = port_fa.pads_for_head_dim
        got = [sf(q, k, v) for _ in range(2)]
        assert port_fa.pads_for_head_dim - before == 2 * pads
        want = attend(q, k, v)
        assert port_fa.pads_for_head_dim - before == 3 * pads
        for g in got:
            np.testing.assert_allclose(g.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_axpy_op(self, dtype):
        x = torch.linspace(-3, 3, 37).to(dtype)
        torch.library.opcheck(torch.ops.paddle_tpu_torch.axpy.default, (x,))
        np.testing.assert_array_equal(port_axpy.axpy(x).float().numpy(),
                                      port_axpy.axpy_plain(x).float().numpy())
