"""Seeds and generator states: the port of ``paddle_tpu/framework/random.py``.

The JAX package threads one functional PRNG key; the port's random draws
come from torch's default generators, one for the CPU and one for each card,
which ``seed`` sets all at once (``torch.manual_seed``). The states are
``[CPU state, card 0 state, ...]`` as uint8 tensors. Like every entry point,
``seed`` raises where there is no card unless ``set_device("cpu")`` was
called. ``generator(device)`` is the generator the samplers
(``ops/random_ops.py``) pass explicitly: the CPU's or the card's default
one, so ``seed`` fixes every draw.
"""
from __future__ import annotations

import torch

_INITIAL = [0]


def seed(s: int):
    """Seed the CPU's and every card's default generator; returns the CPU's."""
    from .. import resolve_device

    resolve_device(None)
    _INITIAL[0] = int(s)
    return torch.manual_seed(int(s))


def initial_seed() -> int:
    return _INITIAL[0]


def get_rng_state():
    """``[CPU state] + [each card's state]``."""
    states = [torch.get_rng_state()]
    if torch.cuda.is_available():
        states += list(torch.cuda.get_rng_state_all())
    return states


def set_rng_state(state):
    states = list(state)
    torch.set_rng_state(states[0])
    if len(states) > 1:
        torch.cuda.set_rng_state_all(states[1:])


def get_cuda_rng_state():
    return list(torch.cuda.get_rng_state_all())


def set_cuda_rng_state(state):
    torch.cuda.set_rng_state_all(list(state))


def generator(device):
    """The default ``torch.Generator`` of ``device`` (a ``torch.device``)."""
    if device.type == "cuda":
        idx = device.index if device.index is not None else torch.cuda.current_device()
        return torch.cuda.default_generators[idx]
    return torch.default_generator
