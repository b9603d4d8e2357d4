"""Adam and AdamW: the port of paddle_tpu/optimizer/optimizer.py
(``Optimizer.step`` / ``_fused_apply`` / ``clear_grad``, ``Adam``, ``AdamW``).

The update is the JAX package's, written with ``torch._foreach_*`` over every
parameter of a group at once (its fused multi-tensor apply), and it differs
from ``torch.optim.AdamW`` where the JAX package does:
  * decoupled decay ``p * (1 - lr * wd)`` comes *before* the Adam update,
    and applies to every parameter (norms and embedding included) unless
    ``apply_decay_param_fun`` says otherwise;
  * bias corrections ``1 - beta ** step`` with ``step`` a float32 scalar;
  * ``eps`` is added outside the square root of the bias-corrected second
    moment: ``p - lr * mhat / (sqrt(vhat) + eps)``;
  * moments are float32; under ``multi_precision`` a float16/bfloat16
    parameter keeps a float32 master weight, is updated through it and is
    then the master cast to its dtype. Without a master, a float32 copy of
    the parameter is updated and cast back.
A float32 parameter (and a master weight) is updated in place, where the JAX
package builds new arrays.

Not ported yet (``NotImplementedError``; a later slice): LR schedulers (the
learning rate is a number), ``grad_clip``, ``amsgrad``.
"""
from __future__ import annotations

import numpy as np
import torch

_LATER = "a later slice of the port"
_LOW = (torch.float16, torch.bfloat16)


class Optimizer:
    """Base: parameter groups, float32 state and the fused apply.

    ``parameters`` is an iterable of tensors (``model.parameters()``: each
    tensor's ``name``, the ``param_{N}`` that ``framework.Parameter`` gives
    it, as in the JAX package) or of ``(name, tensor)`` pairs
    (``model.named_parameters()``: the pair's name). Names are what
    ``apply_decay_param_fun`` is called with.
    """

    def __init__(self, learning_rate=0.001, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False, name=None):
        if parameters is None:
            raise ValueError("parameters is required: pass model.parameters() or "
                             "model.named_parameters()")
        if isinstance(learning_rate, bool) or not isinstance(
                learning_rate, (int, float, np.floating)):
            raise NotImplementedError(
                f"learning_rate must be a number; LR schedulers are not ported yet: "
                f"they belong to {_LATER}")
        if grad_clip is not None:
            raise NotImplementedError(f"grad_clip is not ported yet: it belongs to {_LATER}")
        self._names, self._params = [], []
        for item in parameters:
            # a plain torch tensor's ``name`` reads None
            name, p = item if isinstance(item, tuple) else (getattr(item, "name", None), item)
            self._names.append(name)
            self._params.append(p)
        self._learning_rate = float(learning_rate)
        self._weight_decay = float(weight_decay) if weight_decay else 0.0
        self._multi_precision = bool(multi_precision)
        self._accumulators = {}   # id(param) -> {state name: float32 tensor}
        self._master_weights = {}  # id(param) -> float32 tensor
        self._step_count = 0

    def get_lr(self):
        return self._learning_rate

    def _init_state(self, p):
        return {}

    def _groups(self):
        """[(weight decay, [params])] for this step."""
        return [(self._weight_decay, self._params)]

    def _apply(self, grads, states, p32s, lr, wd, step):
        """Update ``p32s`` and ``states`` in place from float32 ``grads``."""
        raise NotImplementedError

    @torch.no_grad()
    def step(self):
        self._step_count += 1
        lr = np.float32(self.get_lr())
        step = np.float32(self._step_count)
        for wd, group in self._groups():
            params = [p for p in group if p.grad is not None]
            if not params:
                continue
            for p in params:
                if id(p) not in self._accumulators:
                    self._accumulators[id(p)] = self._init_state(p)
                    if self._multi_precision and p.dtype in _LOW:
                        self._master_weights[id(p)] = p.detach().float()
            # the float32 values the rule updates: the master, the parameter
            # itself when it is float32, else a float32 copy
            p32s = [self._master_weights[id(p)] if id(p) in self._master_weights
                    else p if p.dtype == torch.float32 else p.float() for p in params]
            grads = [p.grad.float() for p in params]
            states = [self._accumulators[id(p)] for p in params]
            self._apply(grads, states, p32s, lr, np.float32(wd), step)
            for p, x in zip(params, p32s):
                if x is not p:
                    p.copy_(x)  # rounds to the parameter's dtype

    def clear_grad(self, set_to_zero=True):
        """Drop every gradient (``set_to_zero`` is accepted for paddle's
        signature; the next backward allocates fresh gradients either way)."""
        for p in self._params:
            p.grad = None


class Adam(Optimizer):
    """The JAX package's signature, in its order. ``lazy_mode`` and
    ``use_multi_tensor`` are accepted and ignored, as there: the update is
    dense, and always one fused pass over the group."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
                 parameters=None, weight_decay=None, grad_clip=None, lazy_mode=False,
                 multi_precision=False, use_multi_tensor=False, amsgrad=False, name=None):
        if amsgrad:
            raise NotImplementedError(f"amsgrad is not ported yet: it belongs to {_LATER}")
        if weight_decay:
            raise NotImplementedError(
                f"Adam's coupled (L2) weight decay is not ported yet: it belongs to {_LATER}")
        super().__init__(learning_rate, parameters, None, grad_clip, multi_precision)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon

    def _init_state(self, p):
        return {"moment1": torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                "moment2": torch.zeros(p.shape, dtype=torch.float32, device=p.device)}

    def _apply(self, grads, states, p32s, lr, wd, step):
        b1, b2 = self._beta1, self._beta2
        # float32 scalars as in the JAX rule: beta ** step with step float32
        one = np.float32(1)
        bias1 = float(one - np.float32(b1) ** step)
        bias2 = float(one - np.float32(b2) ** step)
        m = [s["moment1"] for s in states]
        v = [s["moment2"] for s in states]
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, grads, alpha=1 - b1)
        torch._foreach_mul_(v, b2)
        torch._foreach_addcmul_(v, grads, grads, value=1 - b2)
        denom = torch._foreach_div(v, bias2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self._eps)
        upd = torch._foreach_div(m, bias1)
        torch._foreach_mul_(upd, float(lr))
        torch._foreach_div_(upd, denom)
        torch._foreach_sub_(p32s, upd)


class AdamW(Adam):
    """Decoupled weight decay (reference: python/paddle/optimizer/adamw.py).
    ``lr_ratio`` and ``lazy_mode`` are accepted and ignored, as in the JAX
    package."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
                 parameters=None, weight_decay=0.01, lr_ratio=None, apply_decay_param_fun=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False, amsgrad=False,
                 name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters, None, grad_clip,
                         lazy_mode, multi_precision, amsgrad=amsgrad)
        self._weight_decay = float(weight_decay) if weight_decay else 0.0
        self._apply_decay_param_fun = apply_decay_param_fun
        if apply_decay_param_fun is not None and None in self._names:
            raise ValueError(
                "apply_decay_param_fun needs parameter names, and a tensor without a "
                "name was given: pass the port's parameters (framework.Parameter, as "
                "model.parameters() gives them) or model.named_parameters()")

    def _groups(self):
        if self._apply_decay_param_fun is None:
            return super()._groups()
        decays = [bool(self._apply_decay_param_fun(n)) for n in self._names]
        include = [p for p, d in zip(self._params, decays) if d]
        exclude = [p for p, d in zip(self._params, decays) if not d]
        return [(self._weight_decay, include), (0.0, exclude)]

    def _apply(self, grads, states, p32s, lr, wd, step):
        if wd:
            torch._foreach_mul_(p32s, float(np.float32(1) - lr * wd))
        super()._apply(grads, states, p32s, lr, wd, step)
