"""Every optimizer of the PyTorch port against the JAX package's
(paddle_tpu/optimizer/optimizer.py, SGD through LBFGS, and
paddle_tpu/incubate/optimizer.py's LookAhead and ModelAverage).

A small two-layer net with named parameters is built on both sides from the
same numpy weights; each step's batch comes from a numpy seed, both run
``loss.backward()``, ``opt.step()``, ``opt.clear_grad()``, and the parameters
are compared after every step (fp32: rtol 1e-5, atol 1e-6). Then the cases of
tests/test_optimizer.py, run on the port, and the optimizer ``state_dict``
across packages in both directions.
"""
import numpy as np
import pytest

import torch

import paddle_tpu as paddle
import paddle_tpu.incubate as jinc
import paddle_tpu.nn as jnn
import paddle_tpu.optimizer as jopt
import paddle_tpu_torch.incubate as tinc
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.optimizer as topt
from paddle_tpu_torch.framework import Parameter

_SHAPES = {"w1": (4, 5), "b1": (5,), "w2": (5, 3)}
_TOL = dict(rtol=1e-5, atol=1e-6)


def _weights(seed=0):
    r = np.random.RandomState(seed)
    return {n: (r.randn(*s) * 0.5).astype(np.float32) for n, s in _SHAPES.items()}


def _batch(step):
    r = np.random.RandomState(100 + step)
    return r.randn(6, 4).astype(np.float32), r.randn(6, 3).astype(np.float32)


class _Jax:
    def __init__(self, weights):
        self.params = {n: paddle.Parameter(paddle.to_tensor(w).value, name=n)
                       for n, w in weights.items()}

    def loss(self, step):
        x, y = (paddle.to_tensor(a) for a in _batch(step))
        p = self.params
        h = paddle.tanh(paddle.matmul(x, p["w1"]) + p["b1"])
        return ((paddle.matmul(h, p["w2"]) - y) ** 2).mean()

    def values(self):
        return {n: np.asarray(p.numpy(), np.float32) for n, p in self.params.items()}


class _Port:
    def __init__(self, weights):
        self.params = {n: Parameter(torch.tensor(w), name=n) for n, w in weights.items()}

    def loss(self, step):
        x, y = (torch.from_numpy(a) for a in _batch(step))
        p = self.params
        h = torch.tanh(x @ p["w1"] + p["b1"])
        return ((h @ p["w2"] - y) ** 2).mean()

    def values(self):
        return {n: p.detach().numpy().copy() for n, p in self.params.items()}


def _run(jo, tmod, jnet, tnet, steps, start=0, schedulers=()):
    for s in range(start, start + steps):
        for opt, net in ((jo, jnet), (tmod, tnet)):
            net.loss(s).backward()
            opt.step()
            opt.clear_grad()
        for sched in schedulers:
            sched.step()
        ref, out = jnet.values(), tnet.values()
        for n in ref:
            np.testing.assert_allclose(out[n], ref[n], **_TOL, err_msg=f"{n} at step {s}")


def _params(net, how):
    if how == "list":
        return list(net.params.values())
    # two groups, the second with a weight decay of its own
    return [{"params": [net.params["w1"], net.params["b1"]]},
            {"params": [net.params["w2"]], "weight_decay": 0.3}]


# (name, factory(module, params), steps); every factory builds the same
# optimizer on both sides
_OPTS = {
    "SGD": (lambda m, p: m.SGD(0.1, parameters=p), 3),
    "SGD_wd": (lambda m, p: m.SGD(0.1, parameters=p, weight_decay=0.2), 3),
    "SGD_L2": (lambda m, p: m.SGD(0.1, parameters=p, weight_decay=m.L2Decay(0.2)), 3),
    "SGD_L1": (lambda m, p: m.SGD(0.1, parameters=p, weight_decay=m.L1Decay(0.05)), 3),
    "Momentum": (lambda m, p: m.Momentum(0.05, momentum=0.8, parameters=p), 3),
    "Momentum_nesterov": (lambda m, p: m.Momentum(0.05, momentum=0.8, parameters=p,
                                                  use_nesterov=True, weight_decay=0.1), 3),
    "Adam": (lambda m, p: m.Adam(0.01, parameters=p), 3),
    "Adam_amsgrad": (lambda m, p: m.Adam(0.01, parameters=p, amsgrad=True), 4),
    "Adam_coupled": (lambda m, p: m.Adam(0.01, parameters=p, weight_decay=0.1), 3),
    "Adam_L2": (lambda m, p: m.Adam(0.01, parameters=p, weight_decay=m.L2Decay(0.1)), 3),
    "Adam_L1": (lambda m, p: m.Adam(0.01, parameters=p, weight_decay=m.L1Decay(0.1)), 3),
    "AdamW": (lambda m, p: m.AdamW(0.01, parameters=p, weight_decay=0.3), 3),
    "AdamW_amsgrad": (lambda m, p: m.AdamW(0.01, parameters=p, amsgrad=True), 4),
    "Adamax": (lambda m, p: m.Adamax(0.02, parameters=p), 3),
    "Adagrad": (lambda m, p: m.Adagrad(0.05, parameters=p, initial_accumulator_value=0.1), 3),
    "Adadelta": (lambda m, p: m.Adadelta(1.0, parameters=p, rho=0.9), 3),
    "RMSProp": (lambda m, p: m.RMSProp(0.01, parameters=p), 3),
    "RMSProp_centered": (lambda m, p: m.RMSProp(0.01, parameters=p, centered=True,
                                                momentum=0.5), 3),
    "Lamb": (lambda m, p: m.Lamb(0.01, lamb_weight_decay=0.05, parameters=p), 3),
    "NAdam": (lambda m, p: m.NAdam(0.01, parameters=p), 3),
    "RAdam": (lambda m, p: m.RAdam(0.01, parameters=p, beta2=0.9), 8),
    "ASGD": (lambda m, p: m.ASGD(0.05, batch_num=2, parameters=p), 4),
    "Rprop": (lambda m, p: m.Rprop(0.01, parameters=p), 5),
}


@pytest.mark.parametrize("how", ["list", "groups"])
@pytest.mark.parametrize("name", sorted(_OPTS))
def test_optimizer_matches_jax(name, how):
    make, steps = _OPTS[name]
    w = _weights()
    jnet, tnet = _Jax(w), _Port(w)
    _run(make(jopt, _params(jnet, how)), make(topt, _params(tnet, how)), jnet, tnet, steps)


@pytest.mark.parametrize("name", ["SGD", "Adam", "AdamW", "Momentum", "Lamb"])
def test_lr_scheduler_clip_and_lr_multiplier_match_jax(name):
    """A scheduler as the learning rate (stepped after every step), global-norm
    clipping and a per-parameter learning-rate multiplier at once."""
    make, steps = _OPTS[name]
    w = _weights(1)
    nets = _Jax(w), _Port(w)
    scheds, opts = [], []
    for (mod, lr, nn_), net in zip(((jopt, jopt.lr, jnn), (topt, topt.lr, tnn)), nets):
        net.params["w2"].optimize_attr["learning_rate"] = 0.5
        sched = lr.LinearWarmup(lr.CosineAnnealingDecay(0.05, T_max=6), warmup_steps=2,
                                start_lr=0.01, end_lr=0.05)
        opt = make(mod, list(net.params.values()))
        opt.set_lr_scheduler(sched)
        opt._grad_clip = nn_.ClipGradByGlobalNorm(0.1)
        scheds.append(sched)
        opts.append(opt)
    _run(opts[0], opts[1], nets[0], nets[1], 5, schedulers=scheds)
    assert opts[1].get_lr() == opts[0].get_lr()


@pytest.mark.parametrize("clip", ["value", "norm", "global"])
def test_grad_clip_options_match_jax(clip):
    w = _weights(2)
    nets = _Jax(w), _Port(w)
    opts = []
    for mod, nn_, net in ((jopt, jnn, nets[0]), (topt, tnn, nets[1])):
        c = {"value": lambda: nn_.ClipGradByValue(0.05), "norm": lambda: nn_.ClipGradByNorm(0.1),
             "global": lambda: nn_.ClipGradByGlobalNorm(0.1)}[clip]()
        net.params["b1"].need_clip = False
        opts.append(mod.Adam(0.01, parameters=list(net.params.values()), grad_clip=c))
    _run(opts[0], opts[1], nets[0], nets[1], 3)


def test_lbfgs_matches_jax():
    w = _weights(3)
    jnet, tnet = _Jax(w), _Port(w)
    jo = jopt.LBFGS(learning_rate=0.5, parameters=list(jnet.params.values()), history_size=3)
    to = topt.LBFGS(learning_rate=0.5, parameters=list(tnet.params.values()), history_size=3)
    for s in range(6):
        def jclosure():
            jo.clear_grad()
            loss = jnet.loss(0)
            loss.backward()
            return loss

        def tclosure():
            to.clear_grad()
            loss = tnet.loss(0)
            loss.backward()
            return loss

        jl, tl = jo.step(jclosure), to.step(tclosure)
        np.testing.assert_allclose(tl.item(), float(jl.numpy()), rtol=1e-5, atol=1e-6)
        ref, out = jnet.values(), tnet.values()
        for n in ref:
            np.testing.assert_allclose(out[n], ref[n], rtol=1e-4, atol=1e-5,
                                       err_msg=f"{n} at step {s}")
    assert len(to._s) == len(jo._s) == 3
    with pytest.raises(ValueError, match="closure"):
        to.step()


def test_lookahead_matches_jax():
    w = _weights(4)
    jnet, tnet = _Jax(w), _Port(w)
    jo = jinc.LookAhead(jopt.SGD(0.1, parameters=list(jnet.params.values())), alpha=0.5, k=2)
    to = tinc.LookAhead(topt.SGD(0.1, parameters=list(tnet.params.values())), alpha=0.5, k=2)
    _run(jo, to, jnet, tnet, 6)
    assert to.get_lr() == pytest.approx(0.1)


def test_model_average_matches_jax():
    w = _weights(5)
    jnet, tnet = _Jax(w), _Port(w)
    jma = jinc.ModelAverage(0.15, parameters=list(jnet.params.values()),
                            min_average_window=2, max_average_window=3)
    tma = tinc.ModelAverage(0.15, parameters=list(tnet.params.values()),
                            min_average_window=2, max_average_window=3)
    jo = jopt.SGD(0.1, parameters=list(jnet.params.values()))
    to = topt.SGD(0.1, parameters=list(tnet.params.values()))
    for s in range(5):
        _run(jo, to, jnet, tnet, 1, start=s)
        jma.step()
        tma.step()
    trained = tnet.values()
    jma.apply()
    tma.apply()
    ref, out = jnet.values(), tnet.values()
    for n in ref:
        np.testing.assert_allclose(out[n], ref[n], **_TOL, err_msg=n)
        assert not np.allclose(out[n], trained[n])
    jma.restore()
    tma.restore()
    for n, v in tnet.values().items():
        np.testing.assert_array_equal(v, trained[n])


# the cases of tests/test_optimizer.py, on the port
def _quadratic_steps(opt_cls, steps=60, **kw):
    w = Parameter(torch.tensor([3.0, -2.0]))
    opt = opt_cls(parameters=[w], **kw)
    for _ in range(steps):
        (w * w).sum().backward()
        opt.step()
        opt.clear_grad()
    return w.detach().abs().max().item()


def test_sgd_adam_converge():
    assert _quadratic_steps(topt.SGD, learning_rate=0.1) < 1e-3
    assert _quadratic_steps(topt.Adam, steps=300, learning_rate=0.1) < 1e-2
    assert _quadratic_steps(topt.Momentum, steps=150, learning_rate=0.02, momentum=0.9) < 1e-2
    assert _quadratic_steps(topt.AdamW, steps=300, learning_rate=0.1, weight_decay=0.01) < 1e-2


def test_adam_matches_reference_formula():
    w0, g = np.array([1.0], np.float32), np.array([0.5], np.float32)
    w = Parameter(torch.tensor(w0))
    opt = topt.Adam(learning_rate=0.1, parameters=[w])
    (w * torch.tensor(g)).sum().backward()
    opt.step()
    mhat = 0.1 * g / (1 - 0.9)
    vhat = 0.001 * g * g / (1 - 0.999)
    np.testing.assert_allclose(w.detach().numpy(), w0 - 0.1 * mhat / (np.sqrt(vhat) + 1e-8),
                               rtol=1e-5)


def test_weight_decay_coupled():
    w = Parameter(torch.tensor([1.0]))
    opt = topt.SGD(learning_rate=0.1, parameters=[w], weight_decay=0.5)
    (w * 0.0).sum().backward()
    opt.step()
    # grad = 0 + wd*w = 0.5 -> w = 1 - 0.1*0.5
    np.testing.assert_allclose(w.detach().numpy(), [0.95], rtol=1e-6)


def test_grad_clip_global_norm():
    w = Parameter(torch.tensor([3.0, 4.0]))
    opt = topt.SGD(learning_rate=1.0, parameters=[w], grad_clip=tnn.ClipGradByGlobalNorm(1.0))
    (w * torch.tensor([3.0, 4.0])).sum().backward()  # grad=(3,4), norm 5
    opt.step()
    np.testing.assert_allclose(w.detach().numpy(), [3 - 0.6, 4 - 0.8], rtol=1e-5)
    # the clip maps the pairs the step uses; the gradient itself is kept
    np.testing.assert_array_equal(w.grad.numpy(), [3.0, 4.0])


def test_lr_schedulers():
    s = topt.lr.StepDecay(0.1, step_size=2, gamma=0.5)
    lrs = []
    for _ in range(5):
        lrs.append(s())
        s.step()
    np.testing.assert_allclose(lrs, [0.1, 0.1, 0.05, 0.05, 0.025])
    c = topt.lr.CosineAnnealingDecay(1.0, T_max=10)
    assert abs(c() - 1.0) < 1e-6
    w = topt.lr.LinearWarmup(0.1, warmup_steps=10, start_lr=0.0, end_lr=0.1)
    first = w()
    for _ in range(10):
        w.step()
    assert first < 0.02 and abs(w() - 0.1) < 1e-6


def test_scheduler_with_optimizer():
    w = Parameter(torch.tensor([1.0]))
    sched = topt.lr.StepDecay(0.1, step_size=1, gamma=0.1)
    opt = topt.SGD(learning_rate=sched, parameters=[w])
    assert abs(opt.get_lr() - 0.1) < 1e-9
    sched.step()
    assert abs(opt.get_lr() - 0.01) < 1e-9
    with pytest.raises(RuntimeError, match="LRScheduler"):
        opt.set_lr(0.5)
    plain = topt.SGD(learning_rate=0.1, parameters=[w])
    plain.set_lr(0.5)
    assert plain.get_lr() == 0.5
    with pytest.raises(TypeError, match="learning_rate"):
        topt.SGD(learning_rate="0.1", parameters=[w])


def test_optimizer_state_roundtrip(tmp_path):
    w = Parameter(torch.tensor([1.0, 2.0]), name="w")
    opt = topt.Adam(learning_rate=0.1, parameters=[w])
    (w * w).sum().backward()
    opt.step()
    path = str(tmp_path / "opt.pt")
    torch.save(opt.state_dict(), path)
    opt2 = topt.Adam(learning_rate=0.1, parameters=[w])
    opt2.set_state_dict(torch.load(path))
    assert opt2._step_count == 1
    torch.testing.assert_close(opt2._accumulators[id(w)]["moment1"],
                               opt._accumulators[id(w)]["moment1"])
    assert opt2._accumulators[id(w)]["moment1"] is not opt._accumulators[id(w)]["moment1"]


def _to_numpy_state(state):
    """The state as numpy copies: a CPU tensor's ``.numpy()`` shares its
    memory, which ``jnp.asarray`` aliases without a copy, so the source
    optimizer's in-place updates would race the other package's reads."""
    out = {}
    for k, v in state.items():
        if k == "master_weights":
            out[k] = {n: np.array(t.numpy() if not isinstance(t, torch.Tensor)
                                  else t.detach().cpu().numpy()) for n, t in v.items()}
        elif k in ("LR_Scheduler", "@step"):
            out[k] = v
        else:
            out[k] = np.array(v.numpy() if not isinstance(v, torch.Tensor)
                              else v.detach().cpu().numpy())
    return out


@pytest.mark.parametrize("name", ["Adam_amsgrad", "AdamW", "Momentum", "NAdam", "ASGD",
                                  "Rprop", "RMSProp_centered"])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_state_dict_crosses_packages(name, direction):
    """Three steps in one package, its state_dict (as numpy) into a fresh
    optimizer of the other, then three more steps there; the continued run
    equals the first package's own continuation."""
    make, _ = _OPTS[name]
    w = _weights(6)
    jnet, tnet = _Jax(w), _Port(w)
    sched = {m: m.lr.StepDecay(0.01, step_size=2, gamma=0.5) for m in (jopt, topt)}
    jo, to = make(jopt, list(jnet.params.values())), make(topt, list(tnet.params.values()))
    for opt, m in ((jo, jopt), (to, topt)):
        if not isinstance(opt, (jopt.Rprop, topt.Rprop)):
            opt.set_lr_scheduler(sched[m])
    _run(jo, to, jnet, tnet, 3, schedulers=list(sched.values()))
    src, dst_mod = (jo, topt) if direction == "jax_to_port" else (to, jopt)
    state = _to_numpy_state(src.state_dict())
    assert state["@step"] == 3 and any(k.startswith("w1_") for k in state)
    # fresh optimizers over the same nets, with fresh schedulers
    fresh = {m: m.lr.StepDecay(0.01, step_size=2, gamma=0.5) for m in (jopt, topt)}
    new = make(dst_mod, list((tnet if dst_mod is topt else jnet).params.values()))
    if not isinstance(new, (jopt.Rprop, topt.Rprop)):
        new.set_lr_scheduler(fresh[dst_mod])
    new.set_state_dict(state)
    assert new._step_count == 3
    if dst_mod is topt:
        to, sched[topt] = new, fresh[topt]
    else:
        jo, sched[jopt] = new, fresh[jopt]
    _run(jo, to, jnet, tnet, 3, start=3, schedulers=list(sched.values()))


def test_multi_precision_state_crosses_packages():
    """bf16 parameters with fp32 masters: the masters travel under
    "master_weights" and the continued bf16 runs agree."""
    w = _weights(7)
    jnet = _Jax(w)
    for n, p in jnet.params.items():
        jnet.params[n] = paddle.Parameter(p.astype("bfloat16").value, name=n)
    jo = jopt.AdamW(0.01, parameters=list(jnet.params.values()), multi_precision=True)
    for s in range(2):
        x, y = (paddle.to_tensor(a).astype("bfloat16") for a in _batch(s))
        p = jnet.params
        h = paddle.tanh(paddle.matmul(x, p["w1"]) + p["b1"])
        ((paddle.matmul(h, p["w2"]) - y) ** 2).mean().backward()
        jo.step()
        jo.clear_grad()
    state = _to_numpy_state(jo.state_dict())
    assert sorted(state["master_weights"]) == sorted(_SHAPES)
    tparams = [Parameter(torch.from_numpy(np.array(p.astype("float32").numpy()))
                         .bfloat16(), name=n) for n, p in jnet.params.items()]
    to = topt.AdamW(0.01, parameters=tparams, multi_precision=True)
    to.set_state_dict(state)
    for p in tparams:
        np.testing.assert_array_equal(to._master_weights[id(p)].numpy(),
                                      state["master_weights"][p.name])
        assert to._master_weights[id(p)].dtype == torch.float32
