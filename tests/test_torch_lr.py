"""The LR schedulers of the PyTorch port against the JAX package's
(paddle_tpu/optimizer/lr.py): the same constructor arguments give the same
``get_lr()`` sequence over 30 steps (host floats on both sides, so equal to
1e-12), with ``step(epoch=)`` jumps, ``ReduceOnPlateau`` fed the same
metrics, and a ``state_dict`` taken mid-schedule that resumes the same
sequence in the other package."""
import numpy as np
import pytest

import paddle_tpu.optimizer.lr as jlr
import paddle_tpu_torch.optimizer.lr as tlr

_CASES = {
    "NoamDecay": lambda m: m.NoamDecay(d_model=64, warmup_steps=5, learning_rate=2.0),
    "PiecewiseDecay": lambda m: m.PiecewiseDecay([3, 9, 20], [0.1, 0.05, 0.01, 0.001]),
    "NaturalExpDecay": lambda m: m.NaturalExpDecay(0.5, gamma=0.1),
    "InverseTimeDecay": lambda m: m.InverseTimeDecay(0.5, gamma=0.2),
    "PolynomialDecay": lambda m: m.PolynomialDecay(0.5, decay_steps=10, end_lr=0.01,
                                                   power=2.0),
    "PolynomialDecay_cycle": lambda m: m.PolynomialDecay(0.5, decay_steps=7, cycle=True),
    "LinearWarmup_number": lambda m: m.LinearWarmup(0.3, warmup_steps=6, start_lr=0.0,
                                                    end_lr=0.3),
    "LinearWarmup_scheduler": lambda m: m.LinearWarmup(
        m.CosineAnnealingDecay(0.3, T_max=20), warmup_steps=5, start_lr=0.01, end_lr=0.3),
    "ExponentialDecay": lambda m: m.ExponentialDecay(0.5, gamma=0.9),
    "MultiStepDecay": lambda m: m.MultiStepDecay(0.5, milestones=[4, 11, 17], gamma=0.3),
    "StepDecay": lambda m: m.StepDecay(0.5, step_size=4, gamma=0.5),
    "LambdaDecay": lambda m: m.LambdaDecay(0.5, lr_lambda=lambda e: 0.95 ** e),
    "MultiplicativeDecay": lambda m: m.MultiplicativeDecay(0.5, lr_lambda=lambda e: 0.9),
    "CosineAnnealingDecay": lambda m: m.CosineAnnealingDecay(0.5, T_max=12, eta_min=0.01),
    "CosineAnnealingWarmRestarts": lambda m: m.CosineAnnealingWarmRestarts(
        0.5, T_0=4, T_mult=2, eta_min=0.001),
    "CosineAnnealingWarmRestarts_mult1": lambda m: m.CosineAnnealingWarmRestarts(0.5, T_0=5),
    "OneCycleLR": lambda m: m.OneCycleLR(1.0, total_steps=25),
    "OneCycleLR_linear": lambda m: m.OneCycleLR(1.0, total_steps=25, anneal_strategy="linear",
                                                phase_pct=0.4),
    "CyclicLR": lambda m: m.CyclicLR(0.1, 1.0, step_size_up=4, step_size_down=6),
    "CyclicLR_triangular2": lambda m: m.CyclicLR(0.1, 1.0, step_size_up=3,
                                                 mode="triangular2"),
    "CyclicLR_exp_range": lambda m: m.CyclicLR(0.1, 1.0, step_size_up=3, mode="exp_range",
                                               exp_gamma=0.95),
    "CyclicLR_scale_fn": lambda m: m.CyclicLR(0.1, 1.0, step_size_up=3,
                                              scale_fn=lambda x: 1 / x, scale_mode="cycle"),
    "ConstantLR": lambda m: m.ConstantLR(0.5, factor=0.25, total_iters=7),
    "LinearLR": lambda m: m.LinearLR(0.5, total_steps=12, start_factor=0.2, end_factor=0.9),
}
_STEPS = 30


def _trace(sched, epochs=None):
    out = []
    for i in range(_STEPS):
        out.append(sched.get_lr() if hasattr(sched, "lr_sched") else sched())
        sched.step() if epochs is None or i not in epochs else sched.step(epochs[i])
    return out


@pytest.mark.parametrize("name", sorted(_CASES))
def test_sequence_matches_jax(name):
    ref, out = _trace(_CASES[name](jlr)), _trace(_CASES[name](tlr))
    np.testing.assert_allclose(out, ref, rtol=1e-12, atol=1e-15)
    assert all(isinstance(x, float) for x in out)


@pytest.mark.parametrize("name", sorted(n for n in _CASES
                                        if n not in ("MultiplicativeDecay",)))
def test_step_with_epoch_matches_jax(name):
    # jumps forward and back (MultiplicativeDecay's lr depends on the path,
    # as in the reference, and is covered by the plain sequence)
    epochs = {4: 9, 10: 3, 17: 22}
    ref, out = _trace(_CASES[name](jlr), epochs), _trace(_CASES[name](tlr), epochs)
    np.testing.assert_allclose(out, ref, rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("kw", [
    dict(mode="min", factor=0.5, patience=2, cooldown=1),
    dict(mode="max", factor=0.2, patience=1, threshold_mode="abs", threshold=0.05),
    dict(mode="min", patience=0, min_lr=0.02),
], ids=["min_rel_cooldown", "max_abs", "min_lr"])
def test_reduce_on_plateau_matches_jax(kw):
    metrics = np.random.RandomState(0).rand(_STEPS).cumsum() % 1.3
    scheds = [m.ReduceOnPlateau(0.5, **kw) for m in (jlr, tlr)]
    seqs = [[], []]
    for x in metrics:
        for s, seq in zip(scheds, seqs):
            s.step(float(x))
            seq.append(s())
    np.testing.assert_allclose(seqs[1], seqs[0], rtol=1e-12)
    assert len(set(seqs[1])) > 1  # the schedule did move
    scheds[1].step(None)          # no metric: nothing moves
    assert scheds[1]() == seqs[1][-1]


def test_reduce_on_plateau_reads_a_tensor_metric():
    import torch

    s = tlr.ReduceOnPlateau(0.5, patience=0)
    for x in (1.0, 2.0, 3.0):
        s.step(torch.tensor(x))
    assert s() == pytest.approx(0.005)


@pytest.mark.parametrize("name", sorted(_CASES))
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_state_dict_resumes_across_packages(name, direction):
    src_mod, dst_mod = (jlr, tlr) if direction == "jax_to_port" else (tlr, jlr)
    src = _CASES[name](src_mod)
    for _ in range(11):
        src.step()
    state = src.state_dict()
    # the state loaded by the package that wrote it and by the other one
    # (MultiplicativeDecay's running product is private in both, so a
    # resume restarts it from the base rate in either)
    twin, dst = _CASES[name](src_mod), _CASES[name](dst_mod)
    for s in (twin, dst):
        s.set_state_dict(dict(state))
        if getattr(src, "lr_sched", None) is not None:
            # the JAX state_dict keeps no nested scheduler: carry the inner one
            s.lr_sched.set_state_dict(src.lr_sched.state_dict())
    ref = _trace(twin)[:15]
    np.testing.assert_allclose(_trace(dst)[:15], ref, rtol=1e-12, atol=1e-15)
    if name != "MultiplicativeDecay":
        np.testing.assert_allclose(ref, _trace(src)[:15], rtol=1e-12, atol=1e-15)


def test_state_dict_keys_equal_jax():
    for name, make in _CASES.items():
        assert sorted(make(tlr).state_dict()) == sorted(make(jlr).state_dict()), name
