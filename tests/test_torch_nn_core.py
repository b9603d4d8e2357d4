"""The port's ``nn`` core against the JAX package's: ``Layer``
(paddle_tpu_torch/nn/layer/layers.py), the containers, ``ParamAttr`` and
``create_parameter``, the initializers, and the slice as a whole.

``Layer`` semantics: ``state_dict`` keys (order included) and values,
``set_state_dict`` both ways and through ``paddle_tpu_torch.save``/``load``,
hook order and removal, ``train``/``eval``, ``apply`` and the traversal
orders, the container operations, ``ParamAttr``'s ``trainable``,
``learning_rate`` and ``need_clip`` in the port's optimizers and clippers,
``clear_gradients``, and the functional bridge on
``torch.func.functional_call``. Deterministic initializers equal JAX's; the
random ones are held to their distributions over 2e5 draws (both packages'
samples), repeat under the port's ``seed``, and ``set_global_initializer``
takes effect. The slice: a ``Layer`` of ``Embedding``, a ``LayerList`` of
residual blocks (``LayerNorm`` -> ``Linear`` -> ``GELU`` -> ``Linear``), a
final ``LayerNorm``, a ``Linear`` head and ``CrossEntropyLoss`` (2 blocks,
hidden 32) runs in both packages with the same weights: the loss, every
gradient by key, three AdamW steps, ``jit.to_static`` against eager and a
``jit.save``/``load`` round trip. float32 rtol 1e-5 / atol 1e-6 (AdamW's
parameters 1e-5 / 1e-5, as tests/test_nn.py).
"""
import collections
import math

import numpy as np
import pytest
import torch
from scipy.stats import truncnorm

import paddle_tpu as paddle
import paddle_tpu_torch as T
from test_torch_nn_layers import _sd, carry
from test_torch_ops import _np, _on_cpu  # noqa: F401

RTOL, ATOL = 1e-5, 1e-6
BOTH = (paddle, T)


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _t(P, a, grad=False):
    return P.to_tensor(a, place="cpu", stop_gradient=not grad)


def _net(P):
    class Block(P.nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = P.nn.Linear(4, 3)
            self.bn = P.nn.BatchNorm1D(3)
            self.register_buffer("steps", P.to_tensor(np.zeros(2, np.float32), place="cpu"))
            self.register_buffer("scratch", P.to_tensor(np.ones(2, np.float32), place="cpu"),
                                 persistable=False)

        def forward(self, x):
            return self.bn(self.fc(x))

    class Net(P.nn.Layer):
        def __init__(self):
            super().__init__()
            self.stem = P.nn.Linear(5, 4)
            self.body = P.nn.Sequential(("block", Block()), ("act", P.nn.ReLU()))
            self.head = P.nn.LayerList([P.nn.Linear(3, 2), P.nn.LayerNorm(2)])

        def forward(self, x):
            h = self.body(self.stem(x))
            for m in self.head:
                h = m(h)
            return h

    return Net()


def _kind(layer):
    """A layer's class name, case and underscores aside: the JAX package's
    activation layers are classes named after their functionals
    (``relu``), the port's after the layers (``ReLU``)."""
    return type(layer).__name__.lower().replace("_", "")


def _pair():
    paddle.seed(3)
    j, t = _net(paddle), _net(T)
    carry(j, t)
    return j, t


# -- Layer -----------------------------------------------------------------------

def test_state_dict_keys_order_and_values_equal_jax():
    j, t = _pair()
    jsd, tsd = _sd(j), _sd(t)
    assert list(tsd) == list(jsd)
    assert "body.block.steps" in tsd and "body.block.scratch" not in tsd
    for k in jsd:
        np.testing.assert_array_equal(tsd[k], jsd[k])
    # and the forward agrees on the carried weights
    x = _x(6, 5)
    np.testing.assert_allclose(_np(t(_t(T, x))), _np(j(_t(paddle, x))), rtol=RTOL, atol=ATOL)


def test_set_state_dict_both_ways_and_through_save_load(tmp_path):
    j, t = _pair()
    paddle.seed(9)
    j2 = _net(paddle)
    # port -> JAX
    assert j2.set_state_dict(_sd(t)) == ([], [])
    for k, v in _sd(j2).items():
        np.testing.assert_array_equal(v, _sd(j)[k])
    # missing, unexpected and a wrong shape, as JAX reports them
    part = dict(list(_sd(j).items())[:2])
    part["nope"] = np.zeros(1, np.float32)
    got = [m.set_state_dict(dict(part)) for m in (_net(paddle), _net(T))]
    assert got[1] == got[0] and got[1][1] == ["nope"] and len(got[1][0]) == len(_sd(j)) - 2
    for P in BOTH:
        with pytest.raises(ValueError, match="shape mismatch"):
            _net(P).set_state_dict({"stem.weight": np.zeros((4, 5), np.float32)})
    # the port's paddle.save / paddle.load, and JAX's file loaded by the port
    T.save(t.state_dict(), str(tmp_path / "t.pdparams"))
    paddle.save(j.state_dict(), str(tmp_path / "j.pdparams"))
    for name in ("t", "j"):
        t2 = _net(T)
        t2.set_state_dict(T.load(str(tmp_path / f"{name}.pdparams"), device="cpu"))
        for k, v in _sd(t2).items():
            np.testing.assert_array_equal(v, _sd(j)[k])


def test_traversal_orders_equal_jax():
    got = []
    for m in _pair():
        got.append(dict(
            params=[n for n, _ in m.named_parameters()],
            own=[n for n, _ in m.named_parameters(include_sublayers=False)],
            count=len(m.parameters()),
            subs=[(n, _kind(s)) for n, s in m.named_sublayers()],
            subs_self=[(n, _kind(s)) for n, s in m.named_sublayers(
                prefix="net", include_self=True)],
            sublayers=[_kind(s) for s in m.sublayers(include_self=True)],
            children=[_kind(s) for s in m.children()],
            named_children=[n for n, _ in m.named_children()],
            buffers=[n for n, _ in m.named_buffers()],
            nbuf=len(m.buffers()),
            full_name=m.body.block.fc.full_name(),
            repr=m.stem.extra_repr()))
    assert got[1] == got[0]
    assert got[1]["buffers"] == ["body.block.steps", "body.block.scratch",
                                 "body.block.bn._mean", "body.block.bn._variance"]


def test_train_eval_and_apply_equal_jax():
    got = []
    for m in _pair():
        seen = []
        m.apply(lambda layer: seen.append(_kind(layer)))
        m.eval()
        modes = [s.training for s in m.sublayers(include_self=True)]
        m.body.train()
        mixed = [s.training for s in m.sublayers(include_self=True)]
        got.append((seen, modes, mixed))
    assert got[1] == got[0]
    assert not any(got[1][1]) and got[1][0][0] == "net"


def test_hooks_order_modification_and_removal_equal_jax():
    got = []
    for m, P in zip(_pair(), BOTH):
        log = []
        lin = m.stem
        h1 = lin.register_forward_pre_hook(lambda layer, inp: log.append("pre1"))
        h2 = lin.register_forward_pre_hook(
            lambda layer, inp: (log.append("pre2"), (P.scale(inp[0], 2.0),))[1])
        h3 = lin.register_forward_post_hook(
            lambda layer, inp, out: (log.append("post1"), P.add(out, P.ones_like(out)))[1])
        h4 = lin.register_forward_post_hook(lambda layer, inp, out: log.append("post2"))
        x = _t(P, _x(2, 5))
        out1 = _np(lin(x))
        h2.remove()
        h3.remove()
        out2 = _np(lin(x))
        h1.remove()
        h4.remove()
        lin(x)
        got.append((log, out1, out2))
    assert got[1][0] == got[0][0] == ["pre1", "pre2", "post1", "post2", "pre1", "post2"]
    for a, b in zip(got[1][1:], got[0][1:]):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


def test_astype_and_to_cast_floating_state_like_jax():
    got = []
    for m in _pair():
        m.astype("float16")
        got.append(["float16" in str(v.dtype) for v in m.state_dict().values()])
    assert got[1] == got[0] and all(got[1])
    t = _pair()[1]
    t.to("cpu", "bfloat16")
    assert {v.dtype for v in t.state_dict().values()} == {torch.bfloat16}
    t.float()
    assert {v.dtype for v in t.state_dict().values()} == {torch.float32}


def test_clear_gradients_equal_jax():
    got = []
    for m, P in zip(_pair(), BOTH):
        P.sum(m(_t(P, _x(6, 5)))).backward()
        before = [p.grad is not None for p in m.parameters()]
        m.clear_gradients()
        got.append((before, [p.grad is None for p in m.parameters()]))
    assert got[1] == got[0] and all(got[1][0]) and all(got[1][1])


def test_functional_state_round_trip_and_functional_call():
    _, t = _pair()
    names, values = t.functional_state()
    assert names == [n for n, _ in t.named_parameters()]
    x = _t(T, _x(6, 5))
    t.eval()
    want = _np(t(x))
    doubled = [v * 2 for v in values]
    out = torch.func.functional_call(t, dict(zip(names, doubled)), (x,))
    t.load_functional_state(names, doubled)
    np.testing.assert_allclose(_np(t(x)), _np(out), rtol=RTOL, atol=ATOL)
    t.load_functional_state(names, [v / 2 for v in doubled])
    np.testing.assert_allclose(_np(t(x)), want, rtol=RTOL, atol=ATOL)


# -- containers ----------------------------------------------------------------------

def _names(layer):
    return [n for n, _ in layer.named_parameters()]


def test_sequential_operations_equal_jax():
    got = []
    for P in BOTH:
        paddle.seed(0)
        od = collections.OrderedDict([("a", P.nn.Linear(2, 3)), ("b", P.nn.Tanh())])
        s1 = P.nn.Sequential(od)
        s2 = P.nn.Sequential(("x", P.nn.Linear(2, 2)), ("y", P.nn.ReLU()))
        s3 = P.nn.Sequential(P.nn.Linear(2, 2), P.nn.ReLU(), P.nn.Linear(2, 1))
        row = [_names(s1), _names(s2), _names(s3), len(s3),
               _kind(s3[-1]), len(s3[1:]), _names(s3[:1])]
        s3[1] = P.nn.Sigmoid()
        row.append([_kind(m) for m in s3.sublayers()])
        del s3[0]
        row += [len(s3), _names(s3)]
        got.append(row)
    assert got[1] == got[0]


def test_layerlist_and_layerdict_operations_equal_jax():
    got = []
    for P in BOTH:
        ll = P.nn.LayerList([P.nn.Linear(2, 2), P.nn.ReLU()])
        ll.append(P.nn.Linear(2, 3))
        ll.insert(1, P.nn.Tanh())
        ll.extend([P.nn.Sigmoid()])
        ll[0] = P.nn.Linear(2, 4)
        row = [len(ll), [_kind(m) for m in ll], _kind(ll[-1]),
               len(ll[1:3]), _names(ll)]
        ld = P.nn.LayerDict({"a": P.nn.Linear(2, 2)})
        ld["b"] = P.nn.ReLU()
        ld.update([("c", P.nn.Linear(2, 1))])
        row += [list(ld.keys()), "b" in ld, len(ld), _names(ld)]
        del ld["a"]
        popped = ld.pop("b")
        row += [list(ld), _kind(popped)]
        ld.clear()
        row.append(len(ld))
        got.append(row)
    assert got[1] == got[0]


def test_parameter_containers_equal_jax():
    got = []
    for P in BOTH:
        mk = P.create_parameter
        pl = P.nn.ParameterList([mk([2], "float32"), mk([3], "float32")])
        pl.append(mk([4], "float32"))
        pd = P.nn.ParameterDict({"w": mk([2, 2], "float32")})
        pd["b"] = mk([2], "float32")
        got.append([len(pl), [list(p.shape) for p in pl], list(pl[1].shape), _names(pl),
                    len(pd), list(pd.keys()), [k for k in pd], _names(pd)])
    assert got[1] == got[0]


# -- ParamAttr, create_parameter, optimizers and clippers ------------------------------

def _attr_net(P):
    class Net(P.nn.Layer):
        def __init__(self):
            super().__init__()
            init = P.nn.initializer.Constant(0.5)
            self.a = self.create_parameter([3], attr=P.ParamAttr(initializer=init))
            self.b = self.create_parameter([3], attr=P.ParamAttr(
                initializer=init, learning_rate=0.1, need_clip=False))
            self.c = self.create_parameter([3], attr=P.ParamAttr(
                initializer=init, trainable=False, name="frozen_c"))
            self.d = self.create_parameter([3], is_bias=True)
            self.e = self.create_parameter([3], attr=False)

        def forward(self, x):
            return P.sum(P.multiply(x, self.a)) * 3 + P.sum(P.multiply(x, self.b)) * 5 + \
                P.sum(P.multiply(x, self.c)) + P.sum(self.d)

    return Net()


def test_param_attr_effects_in_optimizer_and_clipper_equal_jax():
    x = _x(3, seed=4)
    got = []
    for P in BOTH:
        net = _attr_net(P)
        attrs = (net.e is None, net.c.name, float(_np(net.d).sum()),
                 [getattr(p, "need_clip", True) for p in (net.a, net.b)],
                 [p.optimize_attr["learning_rate"] for p in (net.a, net.b)])
        trainable = [n for n, p in net.named_parameters()
                     if not (p.stop_gradient if P is paddle else not p.requires_grad)]
        opt = P.optimizer.SGD(learning_rate=1.0, parameters=net.parameters(),
                              grad_clip=P.nn.ClipGradByGlobalNorm(1.0))
        loss = net(_t(P, x))
        loss.backward()
        opt.step()
        got.append((attrs, trainable, {k: v for k, v in _sd(net).items()}))
    assert got[1][:2] == got[0][:2]
    assert got[1][1] == ["a", "b", "d"]
    for k in got[0][2]:
        np.testing.assert_allclose(got[1][2][k], got[0][2][k], rtol=RTOL, atol=ATOL, err_msg=k)
    # c is frozen; b moved by its own, unclipped gradient times 0.1
    np.testing.assert_array_equal(got[1][2]["c"], np.full(3, 0.5, np.float32))
    np.testing.assert_allclose(got[1][2]["b"], 0.5 - 0.1 * 5 * x, rtol=RTOL, atol=ATOL)


def test_top_level_create_parameter_and_param_attr():
    got = []
    for P in BOTH:
        paddle.seed(0)
        p = P.create_parameter([4, 3], "float32", name="w0",
                               attr=P.ParamAttr(initializer=P.nn.initializer.Constant(2.0)))
        q = P.create_parameter([2], "float32", is_bias=True)
        got.append((p.name, list(p.shape), float(_np(p).sum()), float(_np(q).sum())))
    assert got[1] == got[0] == ("w0", [4, 3], 24.0, 0.0)


# -- initializers ---------------------------------------------------------------------

def _I(P):
    return P.nn.initializer


@pytest.mark.parametrize("make,shape", [
    (lambda I: I.Constant(0.7), [3, 4]),
    (lambda I: I.Assign(np.arange(6, dtype=np.float32).reshape(2, 3)), [2, 3]),
    (lambda I: I.Dirac(), [4, 4, 3]),
    (lambda I: I.Dirac(groups=2), [4, 2, 3, 3]),
    (lambda I: I.Bilinear(), [2, 2, 4, 4]),
    (lambda I: I.Bilinear(), [1, 3, 5]),
], ids=["constant", "assign", "dirac", "dirac_groups", "bilinear", "bilinear_1d"])
def test_deterministic_initializers_equal_jax(make, shape):
    got = [_np(make(_I(P))(shape, "float32")) for P in BOTH]
    np.testing.assert_array_equal(got[1], got[0])


def test_calculate_gain_and_fans_equal_jax():
    from paddle_tpu.nn.initializer import _fan_in_out as jfans

    from paddle_tpu_torch.nn.initializer import _fan_in_out as tfans

    for nl in ("sigmoid", "linear", "conv1d", "conv2d", "conv3d", "tanh", "relu", "selu"):
        assert T.nn.initializer.calculate_gain(nl) == paddle.nn.initializer.calculate_gain(nl)
    for param in (None, 0.2):
        assert (T.nn.initializer.calculate_gain("leaky_relu", param)
                == paddle.nn.initializer.calculate_gain("leaky_relu", param))
    for shape in ([5], [], [4, 6], [8, 3, 3, 3], [2, 3, 5]):
        assert tfans(shape) == jfans(shape)
    with pytest.raises(ValueError):
        T.nn.initializer.calculate_gain("swish")


_DRAWS = (400, 500)   # 2e5 draws; paddle's fans: fan_in 400, fan_out 500


@pytest.mark.parametrize("make,mean,std,bounds", [
    (lambda I: I.Normal(0.3, 2.0), 0.3, 2.0, None),
    (lambda I: I.Uniform(-0.5, 1.5), 0.5, 2.0 / math.sqrt(12), (-0.5, 1.5)),
    (lambda I: I.TruncatedNormal(0.0, 1.0), 0.0, float(truncnorm.std(-2, 2)), (-2.0, 2.0)),
    (lambda I: I.TruncatedNormal(1.0, 0.5, -1.0, 3.0), 1.0 + 0.5 * float(truncnorm.mean(-1, 3)),
     0.5 * float(truncnorm.std(-1, 3)), (0.5, 2.5)),
    (lambda I: I.XavierNormal(), 0.0, math.sqrt(2.0 / 900), None),
    (lambda I: I.XavierUniform(), 0.0, math.sqrt(6.0 / 900) / math.sqrt(3),
     (-math.sqrt(6.0 / 900), math.sqrt(6.0 / 900))),
    (lambda I: I.XavierUniform(fan_in=10, fan_out=20, gain=2.0), 0.0,
     2.0 * math.sqrt(6.0 / 30) / math.sqrt(3), (-2.0 * math.sqrt(0.2), 2.0 * math.sqrt(0.2))),
    (lambda I: I.KaimingNormal(), 0.0, math.sqrt(2.0) / math.sqrt(400), None),
    (lambda I: I.KaimingUniform(nonlinearity="leaky_relu", negative_slope=0.2), 0.0,
     math.sqrt(2.0 / 1.04) * math.sqrt(3.0 / 400) / math.sqrt(3),
     (-math.sqrt(2.0 / 1.04) * math.sqrt(3.0 / 400), math.sqrt(2.0 / 1.04) * math.sqrt(3.0 / 400))),
], ids=["normal", "uniform", "truncated", "truncated_window", "xavier_normal",
        "xavier_uniform", "xavier_uniform_fans", "kaiming_normal", "kaiming_uniform"])
def test_random_initializers_follow_their_distribution(make, mean, std, bounds):
    """Mean within 5 standard errors, standard deviation within 1%, bounds
    held, in both packages' 2e5 draws; the port's draws repeat under
    ``seed``."""
    for P in BOTH:
        P.seed(21)
        a = _np(make(_I(P))(list(_DRAWS), "float32")).astype(np.float64)
        assert a.shape == _DRAWS
        assert abs(a.mean() - mean) <= 5 * std / math.sqrt(a.size), (P.__name__, a.mean())
        assert abs(a.std() - std) <= 0.01 * std, (P.__name__, a.std())
        if bounds is not None:
            assert a.min() >= bounds[0] - 1e-6 and a.max() <= bounds[1] + 1e-6
    T.seed(21)
    again = _np(make(_I(T))(list(_DRAWS), "float32"))
    T.seed(21)
    np.testing.assert_array_equal(_np(make(_I(T))(list(_DRAWS), "float32")), again)


@pytest.mark.parametrize("shape", [[64, 32], [32, 64], [4, 8, 16]])
def test_orthogonal_is_orthogonal(shape):
    for P in BOTH:
        P.seed(2)
        w = _np(_I(P).Orthogonal(gain=1.5)(shape, "float32")).astype(np.float64)
        m = w.reshape(-1, shape[-1])
        small = m.T @ m if m.shape[0] >= m.shape[1] else m @ m.T
        np.testing.assert_allclose(small / 1.5 ** 2, np.eye(small.shape[0]), atol=1e-5)


def test_set_global_initializer_takes_effect():
    got = []
    for P in BOTH:
        I = _I(P)
        I.set_global_initializer(I.Constant(0.5), I.Constant(0.25))
        try:
            lin = P.nn.Linear(3, 2)
            explicit = P.nn.Linear(3, 2, weight_attr=P.ParamAttr(initializer=I.Constant(1.0)))
        finally:
            I.set_global_initializer(None, None)
        after = P.nn.Linear(3, 2)
        got.append((_np(lin.weight).tolist(), _np(lin.bias).tolist(),
                    _np(explicit.weight).tolist(), bool(np.any(_np(after.weight) != 0.5))))
    assert got[1] == got[0]
    assert got[1][0] == [[0.5, 0.5]] * 3 and got[1][1] == [0.25, 0.25] and got[1][3]


def test_linear_layout_is_paddles():
    lin = T.nn.Linear(8, 4)
    assert list(lin.weight.shape) == [8, 4] and list(lin.bias.shape) == [4]
    assert not isinstance(lin, torch.nn.Linear) and isinstance(lin, torch.nn.Module)
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig(vocab_size=16, hidden_size=8, intermediate_size=16, num_hidden_layers=1,
                      num_attention_heads=2)
    llama = LlamaForCausalLM(cfg, device="cpu")
    q = llama.llama.layers[0].self_attn.q_proj
    assert isinstance(q, torch.nn.Linear) and list(q.weight.shape) == [8, 8]
    assert list(llama.llama.layers[0].mlp.up_proj.weight.shape) == [16, 8]


# -- the slice as a whole ---------------------------------------------------------------

V, H, B, S = 48, 32, 2, 6


def _slice_net(P):
    nn = P.nn
    F = nn.functional

    class Block(nn.Layer):
        def __init__(self):
            super().__init__()
            self.norm = nn.LayerNorm(H)
            self.up = nn.Linear(H, 4 * H)
            self.act = nn.GELU()
            self.down = nn.Linear(4 * H, H)

        def forward(self, x):
            return P.add(x, self.down(self.act(self.up(self.norm(x)))))

    class Net(nn.Layer):
        def __init__(self):
            super().__init__()
            self.embed = nn.Embedding(V, H)
            self.blocks = nn.LayerList([Block() for _ in range(2)])
            self.norm = nn.LayerNorm(H)
            self.head = nn.Linear(H, V)
            self.loss = nn.CrossEntropyLoss()

        def forward(self, ids):
            h = self.embed(ids)
            for blk in self.blocks:
                h = blk(h)
            return self.head(self.norm(h))

    del F
    return Net()


def _slice_pair():
    paddle.seed(5)
    j, t = _slice_net(paddle), _slice_net(T)
    carry(j, t)
    return j, t


def _ids(seed):
    r = np.random.RandomState(seed)
    return r.randint(0, V, (B, S)).astype(np.int64), r.randint(0, V, (B, S)).astype(np.int64)


def _loss(P, net, ids, labels):
    logits = net(_t(P, ids))
    return net.loss(P.reshape(logits, [-1, V]), P.reshape(_t(P, labels), [-1]))


def test_slice_net_loss_and_every_gradient_equal_jax():
    j, t = _slice_pair()
    ids, labels = _ids(0)
    losses = []
    for P, net in ((paddle, j), (T, t)):
        loss = _loss(P, net, ids, labels)
        loss.backward()
        losses.append(float(_np(loss)))
    np.testing.assert_allclose(losses[1], losses[0], rtol=RTOL, atol=ATOL)
    jg = {n: _np(p.grad) for n, p in j.named_parameters()}
    tg = {n: _np(p.grad) for n, p in t.named_parameters()}
    assert list(tg) == list(jg) and len(tg) == 3 + 2 * 6 + 2
    for k in jg:
        np.testing.assert_allclose(tg[k], jg[k], rtol=RTOL, atol=ATOL, err_msg=k)


def test_slice_net_three_adamw_steps_equal_jax():
    j, t = _slice_pair()
    curves = []
    for P, net in ((paddle, j), (T, t)):
        opt = P.optimizer.AdamW(learning_rate=1e-2, parameters=net.parameters(),
                                weight_decay=0.01)
        curve = []
        for step in range(3):
            ids, labels = _ids(step)
            loss = _loss(P, net, ids, labels)
            loss.backward()
            opt.step()
            opt.clear_grad()
            curve.append(float(_np(loss)))
        curves.append(curve)
    np.testing.assert_allclose(curves[1], curves[0], rtol=1e-5, atol=1e-5)
    for k, v in _sd(j).items():
        np.testing.assert_allclose(_sd(t)[k], v, rtol=1e-5, atol=1e-5, err_msg=k)


def test_slice_net_to_static_equals_eager():
    _, t = _slice_pair()
    t.eval()
    ids = _t(T, _ids(1)[0])
    eager = _np(t(ids))
    static = T.jit.to_static(t, backend="aot_eager")
    np.testing.assert_allclose(_np(static(ids)), eager, rtol=RTOL, atol=ATOL)


def test_slice_net_jit_save_load_round_trip(tmp_path):
    from paddle_tpu_torch.jit import InputSpec

    _, t = _slice_pair()
    t.eval()
    ids = _ids(2)[0]
    want = _np(t(_t(T, ids)))
    path = str(tmp_path / "net")
    T.jit.save(t, path, input_spec=[InputSpec([B, S], "int64")])
    loaded = T.jit.load(path, device="cpu")
    np.testing.assert_allclose(_np(loaded(ids)), want, rtol=RTOL, atol=ATOL)
