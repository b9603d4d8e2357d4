"""Optimizers: the port of paddle_tpu/optimizer/optimizer.py (``Optimizer``
and every rule of the file, ``SGD`` through ``LBFGS``).

Each rule is the JAX package's, written with ``torch._foreach_*`` over every
parameter of a group at once (its fused multi-tensor apply); only LBFGS,
which works on one flat vector and keeps its history on the host, uses
per-tensor ops. Where the JAX rules differ from ``torch.optim``, the port
keeps the JAX arithmetic:
  * AdamW's decoupled decay ``p * (1 - lr * wd)`` comes *before* the Adam
    update and applies to every parameter (norms and embedding included)
    unless ``apply_decay_param_fun`` says otherwise; the other optimizers
    add a coupled decay to the gradient: ``g + wd * p`` for a number or
    ``L2Decay``, ``g + wd * sign(p)`` for ``L1Decay``;
  * bias corrections ``1 - beta ** step`` with ``step`` a float32 scalar,
    and ``eps`` outside the square root of the bias-corrected second moment;
  * state is float32; under ``multi_precision`` a float16/bfloat16 parameter
    keeps a float32 master weight, is updated through it and is then the
    master cast to its dtype. Without a master, a float32 copy of the
    parameter is updated and cast back.
A float32 parameter (and a master weight) is updated in place, where the JAX
package builds new arrays. The learning rate is a number or an
``lr.LRScheduler``, read once a step on the host (times a parameter's
``optimize_attr["learning_rate"]``); ``grad_clip`` maps the step's
``(param, grad)`` pairs before the update. Nothing in ``step()`` reads a
device value on the host (LBFGS aside).

``state_dict()`` uses the JAX keys: ``"{name}_{state}"`` for every state
tensor, ``"master_weights"``, ``"LR_Scheduler"`` and ``"@step"``, where
``name`` is the parameter's name (``param_{N}``, or the pair's name for
``named_parameters()``), so a state written by either package loads in the
other.
"""
from __future__ import annotations

import numpy as np
import torch

from .lr import LRScheduler

_LOW = (torch.float16, torch.bfloat16)
_F32 = np.float32


class L2Decay:
    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)


class L1Decay:
    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)


def _zeros(p):
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def _to_f32(value, device):
    """A state value from either package (a tensor, a numpy array or anything
    numpy reads) as a float32 tensor of its own on ``device``."""
    if isinstance(value, torch.Tensor):
        return value.detach().to(device=device, dtype=torch.float32, copy=True)
    if not isinstance(value, np.ndarray) and hasattr(value, "numpy"):
        value = value.numpy()
    return torch.from_numpy(np.array(value, dtype=np.float32)).to(device)


def _fitting(value, shape, device, key):
    """``_to_f32`` of a loaded state value, which must have ``shape`` (a
    paddle-layout (in, out) value for a torch (out, in) parameter is
    transposed by the caller, not reshaped here)."""
    t = _to_f32(value, device)
    if t.shape != shape:
        raise ValueError(f"optimizer state {key}: shape {tuple(t.shape)} does not fit "
                         f"{tuple(shape)}")
    return t


class Optimizer:
    """Base: parameter groups, float32 state and the fused apply.

    ``parameters`` is an iterable of tensors (``model.parameters()``: each
    tensor's ``name``, the ``param_{N}`` that ``framework.Parameter`` gives
    it, as in the JAX package), of ``(name, tensor)`` pairs
    (``model.named_parameters()``: the pair's name), or of dicts, each a
    group with ``"params"`` and its own ``"weight_decay"`` (and a rule's
    hyper-parameters where the JAX rule reads them from the group). Names
    are what ``apply_decay_param_fun`` is called with and what
    ``state_dict()`` keys by.
    """

    def __init__(self, learning_rate=0.001, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False, name=None):
        if parameters is None:
            from ..framework.enforce import InvalidArgumentError

            raise InvalidArgumentError("parameters is required: pass model.parameters() or "
                                       "model.named_parameters()")
        if not isinstance(learning_rate, LRScheduler) and (
                isinstance(learning_rate, bool)
                or not isinstance(learning_rate, (int, float, np.floating))):
            raise TypeError(f"learning_rate must be a number or an LRScheduler, "
                            f"got {type(learning_rate).__name__}")
        items = list(parameters)
        groups = ([dict(g) for g in items] if items and isinstance(items[0], dict)
                  else [{"params": items}])
        self._param_groups, self._names, self._params = [], [], []
        for group in groups:
            params = []
            for item in group["params"]:
                # a plain torch tensor's ``name`` reads None
                name, p = item if isinstance(item, tuple) else (getattr(item, "name", None),
                                                                item)
                self._names.append(name)
                self._params.append(p)
                params.append(p)
            group["params"] = params
            self._param_groups.append(group)
        self._learning_rate = learning_rate
        self._coupled_decay = "l1" if isinstance(weight_decay, L1Decay) else True
        self._weight_decay = (weight_decay.coeff if isinstance(weight_decay, (L1Decay, L2Decay))
                              else float(weight_decay) if weight_decay else 0.0)
        self._grad_clip = grad_clip
        self._multi_precision = bool(multi_precision)
        self._accumulators = {}   # id(param) -> {state name: float32 tensor}
        self._master_weights = {}  # id(param) -> float32 tensor
        self._step_count = 0

    # -- learning rate -------------------------------------------------------
    def get_lr(self):
        if isinstance(self._learning_rate, LRScheduler):
            return float(self._learning_rate())
        return float(self._learning_rate)

    def set_lr(self, value):
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError("cannot set_lr when using an LRScheduler")
        self._learning_rate = float(value)

    def set_lr_scheduler(self, scheduler):
        self._learning_rate = scheduler

    @property
    def _parameter_list(self):
        return list(self._params)

    # -- the rule ------------------------------------------------------------
    def _init_state(self, p):
        return {}

    def _hyper(self, group):
        return {}

    def _groups(self):
        """The groups of this step: dicts with ``"params"``."""
        return self._param_groups

    def _apply(self, grads, states, p32s, lrs, wd, step, hyper):
        """Update ``p32s`` and ``states`` in place from float32 ``grads``
        (which the rule must not write); ``lrs`` is one float a parameter."""
        raise NotImplementedError

    @torch.no_grad()
    def step(self):
        self._step_count += 1
        lr = _F32(self.get_lr())
        step = _F32(self._step_count)
        for group in self._groups():
            pg = [(p, p.grad) for p in group["params"] if p.grad is not None]
            if not pg:
                continue
            if self._grad_clip is not None:
                pg = self._grad_clip(pg)
            wd = group.get("weight_decay", self._weight_decay)
            if isinstance(wd, (L2Decay, L1Decay)):
                wd = wd.coeff
            wd = _F32(wd or 0.0)
            params = [p for p, _ in pg]
            for p in params:
                if id(p) not in self._accumulators:
                    self._accumulators[id(p)] = self._init_state(p)
                    if self._multi_precision and p.dtype in _LOW:
                        self._master_weights[id(p)] = p.detach().float()
            # the float32 values the rule updates: the master, the parameter
            # itself when it is float32, else a float32 copy
            p32s = [self._master_weights[id(p)] if id(p) in self._master_weights
                    else p if p.dtype == torch.float32 else p.float() for p in params]
            grads = [g.float() for _, g in pg]
            if wd and self._coupled_decay == "l1":
                grads = torch._foreach_add(grads, torch._foreach_sign(p32s), alpha=float(wd))
            elif wd and self._coupled_decay:
                grads = torch._foreach_add(grads, torch._foreach_mul(p32s, float(wd)))
            lrs = [float(lr * _F32(getattr(p, "optimize_attr", {}).get("learning_rate", 1.0)))
                   for p in params]
            states = [self._accumulators[id(p)] for p in params]
            self._apply(grads, states, p32s, lrs, wd, step, self._hyper(group))
            for p, x in zip(params, p32s):
                if x is not p:
                    p.copy_(x)  # rounds to the parameter's dtype

    def clear_grad(self, set_to_zero=True):
        """Drop every gradient (``set_to_zero`` is accepted for paddle's
        signature; the next backward allocates fresh gradients either way)."""
        for p in self._params:
            p.grad = None

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None, no_grad_set=None):
        loss.backward()
        self.step()
        return None, None

    # -- persistence ---------------------------------------------------------
    def _keyed(self):
        return [(name or f"param_{i}", p)
                for i, (name, p) in enumerate(zip(self._names, self._params))]

    def state_dict(self):
        """The JAX package's keys; values are the live float32 tensors."""
        state = {"LR_Scheduler": {}, "master_weights": {}}
        if isinstance(self._learning_rate, LRScheduler):
            state["LR_Scheduler"] = self._learning_rate.state_dict()
        for name, p in self._keyed():
            for k, v in self._accumulators.get(id(p), {}).items():
                state[f"{name}_{k}"] = v
            if id(p) in self._master_weights:
                state["master_weights"][name] = self._master_weights[id(p)]
        state["@step"] = self._step_count
        return state

    def set_state_dict(self, state):
        """Load a ``state_dict()`` of either package (tensors or numpy
        arrays), copied to each parameter's device as float32."""
        self._step_count = int(state.get("@step", 0))
        if isinstance(self._learning_rate, LRScheduler) and state.get("LR_Scheduler"):
            self._learning_rate.set_state_dict(state["LR_Scheduler"])
        masters = state.get("master_weights", {})
        for name, p in self._keyed():
            acc = self._init_state(p)
            found = False
            for k in list(acc):
                if f"{name}_{k}" in state:
                    acc[k] = _fitting(state[f"{name}_{k}"], acc[k].shape, p.device,
                                      f"{name}_{k}")
                    found = True
            if found:
                self._accumulators[id(p)] = acc
            if masters.get(name) is not None:
                self._master_weights[id(p)] = _fitting(masters[name], p.shape, p.device,
                                                       f"master_weights[{name!r}]")

    load_state_dict = set_state_dict


class SGD(Optimizer):
    def __init__(self, learning_rate=0.001, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip, multi_precision)

    def _apply(self, grads, states, p32s, lrs, wd, step, hyper):
        torch._foreach_sub_(p32s, torch._foreach_mul(grads, lrs))


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, rescale_grad=1.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip, multi_precision)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def _init_state(self, p):
        return {"velocity": _zeros(p)}

    def _hyper(self, group):
        return {"momentum": group.get("momentum", self._momentum)}

    def _apply(self, grads, states, p32s, lrs, wd, step, hyper):
        mu = hyper["momentum"]
        v = [s["velocity"] for s in states]
        torch._foreach_mul_(v, mu)
        torch._foreach_add_(v, grads)
        if self._nesterov:
            upd = torch._foreach_add(grads, torch._foreach_mul(v, mu))
            torch._foreach_mul_(upd, lrs)
        else:
            upd = torch._foreach_mul(v, lrs)
        torch._foreach_sub_(p32s, upd)


def _moments(states, grads, b1, b2, k1="moment1", k2="moment2"):
    """m = b1 m + (1 - b1) g and v = b2 v + (1 - b2) g^2, in place."""
    m = [s[k1] for s in states]
    v = [s[k2] for s in states]
    torch._foreach_mul_(m, b1)
    torch._foreach_add_(m, grads, alpha=1 - b1)
    torch._foreach_mul_(v, b2)
    torch._foreach_addcmul_(v, grads, grads, value=1 - b2)
    return m, v


class Adam(Optimizer):
    """The JAX package's signature, in its order. ``lazy_mode`` and
    ``use_multi_tensor`` are accepted and ignored, as there: the update is
    dense, and always one fused pass over the group. A numeric or ``L2Decay``
    ``weight_decay`` is coupled (added to the gradient), ``L1Decay`` adds
    ``wd * sign(p)``."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
                 parameters=None, weight_decay=None, grad_clip=None, lazy_mode=False,
                 multi_precision=False, use_multi_tensor=False, amsgrad=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip, multi_precision)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon
        self._amsgrad = amsgrad

    def _init_state(self, p):
        st = {"moment1": _zeros(p), "moment2": _zeros(p)}
        if self._amsgrad:
            st["moment2_max"] = _zeros(p)
        return st

    def _hyper(self, group):
        return {"beta1": group.get("beta1", self._beta1),
                "beta2": group.get("beta2", self._beta2)}

    def _apply(self, grads, states, p32s, lrs, wd, step, hyper):
        b1, b2 = hyper["beta1"], hyper["beta2"]
        # float32 scalars as in the JAX rule: beta ** step with step float32
        bias1 = float(_F32(1) - _F32(b1) ** step)
        bias2 = float(_F32(1) - _F32(b2) ** step)
        m, v = _moments(states, grads, b1, b2)
        denom = torch._foreach_div(v, bias2)
        if self._amsgrad:
            vmax = [s["moment2_max"] for s in states]
            torch._foreach_maximum_(vmax, denom)
            denom = torch._foreach_sqrt(vmax)
        else:
            torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self._eps)
        upd = torch._foreach_div(m, bias1)
        torch._foreach_mul_(upd, lrs)
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
        self._coupled_decay = False
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
        return [{"params": [p for p, d in zip(self._params, decays) if d],
                 "weight_decay": self._weight_decay},
                {"params": [p for p, d in zip(self._params, decays) if not d],
                 "weight_decay": 0.0}]

    def _apply(self, grads, states, p32s, lrs, wd, step, hyper):
        if wd:
            torch._foreach_mul_(p32s, [float(_F32(1) - _F32(lr) * wd) for lr in lrs])
        super()._apply(grads, states, p32s, lrs, wd, step, hyper)


class Adamax(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
                 parameters=None, weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon

    def _init_state(self, p):
        return {"moment": _zeros(p), "inf_norm": _zeros(p)}

    def _apply(self, grads, states, p32s, lrs, wd, step, hyper):
        b1, b2 = self._beta1, self._beta2
        bias1 = _F32(1) - _F32(b1) ** step
        m = [s["moment"] for s in states]
        u = [s["inf_norm"] for s in states]
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, torch._foreach_mul(grads, 1 - b1))
        torch._foreach_mul_(u, b2)
        torch._foreach_maximum_(u, torch._foreach_abs(grads))
        upd = torch._foreach_mul(m, [float(_F32(lr) / bias1) for lr in lrs])
        torch._foreach_div_(upd, torch._foreach_add(u, self._eps))
        torch._foreach_sub_(p32s, upd)


class Adagrad(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, parameters=None, weight_decay=None,
                 grad_clip=None, initial_accumulator_value=0.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._eps = epsilon
        self._init_acc = initial_accumulator_value

    def _init_state(self, p):
        return {"moment": torch.full(p.shape, self._init_acc, dtype=torch.float32,
                                     device=p.device)}

    def _apply(self, grads, states, p32s, lrs, wd, step, hyper):
        acc = [s["moment"] for s in states]
        torch._foreach_add_(acc, torch._foreach_mul(grads, grads))
        denom = torch._foreach_sqrt(acc)
        torch._foreach_add_(denom, self._eps)
        upd = torch._foreach_mul(grads, lrs)
        torch._foreach_div_(upd, denom)
        torch._foreach_sub_(p32s, upd)


class Adadelta(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._eps, self._rho = epsilon, rho

    def _init_state(self, p):
        return {"avg_squared_grad": _zeros(p), "avg_squared_update": _zeros(p)}

    def _apply(self, grads, states, p32s, lrs, wd, step, hyper):
        rho, eps = self._rho, self._eps
        eg = [s["avg_squared_grad"] for s in states]
        eu = [s["avg_squared_update"] for s in states]
        torch._foreach_mul_(eg, rho)
        torch._foreach_add_(eg, torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - rho))
        upd = torch._foreach_sqrt(torch._foreach_add(eu, eps))
        torch._foreach_div_(upd, torch._foreach_sqrt(torch._foreach_add(eg, eps)))
        torch._foreach_mul_(upd, grads)
        torch._foreach_neg_(upd)
        torch._foreach_mul_(eu, rho)
        torch._foreach_add_(eu, torch._foreach_mul(torch._foreach_mul(upd, upd), 1 - rho))
        torch._foreach_mul_(upd, lrs)
        torch._foreach_add_(p32s, upd)


class RMSProp(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0, centered=False,
                 parameters=None, weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._rho, self._eps, self._momentum, self._centered = rho, epsilon, momentum, centered

    def _init_state(self, p):
        return {"mean_square": _zeros(p), "mean_grad": _zeros(p), "momentum_acc": _zeros(p)}

    def _apply(self, grads, states, p32s, lrs, wd, step, hyper):
        rho = self._rho
        ms = [s["mean_square"] for s in states]
        mg = [s["mean_grad"] for s in states]
        mom = [s["momentum_acc"] for s in states]
        torch._foreach_mul_(ms, rho)
        torch._foreach_add_(ms, torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - rho))
        if self._centered:
            torch._foreach_mul_(mg, rho)
            torch._foreach_add_(mg, torch._foreach_mul(grads, 1 - rho))
            denom = torch._foreach_sub(ms, torch._foreach_mul(mg, mg))
            torch._foreach_add_(denom, self._eps)
        else:
            denom = torch._foreach_add(ms, self._eps)
        torch._foreach_sqrt_(denom)
        upd = torch._foreach_mul(grads, lrs)
        torch._foreach_div_(upd, denom)
        torch._foreach_mul_(mom, self._momentum)
        torch._foreach_add_(mom, upd)
        torch._foreach_sub_(p32s, mom)


class Lamb(Optimizer):
    """``exclude_from_weight_decay_fn`` is accepted and, as in the JAX
    package, not applied: ``lamb_weight_decay`` reaches every parameter."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01, beta1=0.9, beta2=0.999,
                 epsilon=1e-6, parameters=None, grad_clip=None, exclude_from_weight_decay_fn=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, multi_precision)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon
        self._lamb_wd = lamb_weight_decay
        self._exclude_fn = exclude_from_weight_decay_fn
        self._coupled_decay = False

    def _init_state(self, p):
        return {"moment1": _zeros(p), "moment2": _zeros(p)}

    def _apply(self, grads, states, p32s, lrs, wd, step, hyper):
        b1, b2 = self._beta1, self._beta2
        m, v = _moments(states, grads, b1, b2)
        r = torch._foreach_div(m, float(_F32(1) - _F32(b1) ** step))
        denom = torch._foreach_sqrt(torch._foreach_div(v, float(_F32(1) - _F32(b2) ** step)))
        torch._foreach_add_(denom, self._eps)
        torch._foreach_div_(r, denom)
        torch._foreach_add_(r, torch._foreach_mul(p32s, self._lamb_wd))
        # the trust ratio of each parameter, on the device
        w_norm, r_norm = torch._foreach_norm(p32s), torch._foreach_norm(r)
        scale = [torch.where((w > 0) & (q > 0), w / q, torch.ones_like(w)) * lr
                 for w, q, lr in zip(w_norm, r_norm, lrs)]
        torch._foreach_mul_(r, scale)
        torch._foreach_sub_(p32s, r)


class NAdam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
                 momentum_decay=0.004, parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon
        self._psi = momentum_decay

    def _init_state(self, p):
        return {"moment1": _zeros(p), "moment2": _zeros(p),
                "mu_product": torch.ones((), dtype=torch.float32, device=p.device)}

    def _apply(self, grads, states, p32s, lrs, wd, step, hyper):
        b1, b2, psi = self._beta1, self._beta2, self._psi
        mu_t = float(_F32(b1) * (_F32(1) - _F32(0.5) * _F32(0.96) ** (step * _F32(psi))))
        mu_t1 = float(_F32(b1) * (_F32(1) - _F32(0.5)
                                  * _F32(0.96) ** ((step + _F32(1)) * _F32(psi))))
        mu_prod = [s["mu_product"] for s in states]
        torch._foreach_mul_(mu_prod, mu_t)
        m, v = _moments(states, grads, b1, b2)
        # mu_t1 * m / (1 - mu_prod * mu_t1) + (1 - mu_t) * g / (1 - mu_prod)
        c1 = torch._foreach_reciprocal(torch._foreach_add(
            torch._foreach_mul(mu_prod, -mu_t1), 1.0))
        c2 = torch._foreach_reciprocal(torch._foreach_add(torch._foreach_neg(mu_prod), 1.0))
        mhat = torch._foreach_mul(torch._foreach_mul(m, mu_t1), c1)
        torch._foreach_add_(mhat, torch._foreach_mul(torch._foreach_mul(grads, 1 - mu_t), c2))
        denom = torch._foreach_sqrt(torch._foreach_div(v, float(_F32(1) - _F32(b2) ** step)))
        torch._foreach_add_(denom, self._eps)
        torch._foreach_mul_(mhat, lrs)
        torch._foreach_div_(mhat, denom)
        torch._foreach_sub_(p32s, mhat)


class RAdam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
                 parameters=None, weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon

    def _init_state(self, p):
        return {"moment1": _zeros(p), "moment2": _zeros(p)}

    def _apply(self, grads, states, p32s, lrs, wd, step, hyper):
        b1, b2 = self._beta1, self._beta2
        m, v = _moments(states, grads, b1, b2)
        mhat = torch._foreach_div(m, float(_F32(1) - _F32(b1) ** step))
        # the rectification depends on the step alone: a host scalar
        rho_inf = _F32(2.0 / (1 - b2) - 1)
        b2t = _F32(b2) ** step
        rho_t = rho_inf - _F32(2) * step * b2t / (_F32(1) - b2t)
        if rho_t > 5.0:
            r = np.sqrt(((rho_t - 4) * (rho_t - 2) * rho_inf)
                        / ((rho_inf - 4) * (rho_inf - 2) * rho_t))
            denom = torch._foreach_sqrt(torch._foreach_div(v, float(_F32(1) - b2t)))
            torch._foreach_add_(denom, self._eps)
            torch._foreach_mul_(mhat, [float(_F32(lr) * r) for lr in lrs])
            torch._foreach_div_(mhat, denom)
        else:
            torch._foreach_mul_(mhat, lrs)
        torch._foreach_sub_(p32s, mhat)


class ASGD(Optimizer):
    def __init__(self, learning_rate=0.001, batch_num=1, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip, multi_precision)
        self._batch_num = batch_num

    def _init_state(self, p):
        return {"d": _zeros(p),
                "ys": torch.zeros((self._batch_num,) + tuple(p.shape), dtype=torch.float32,
                                  device=p.device)}

    def _apply(self, grads, states, p32s, lrs, wd, step, hyper):
        idx = (int(step) - 1) % self._batch_num
        d = [s["d"] for s in states]
        y = [s["ys"][idx] for s in states]
        torch._foreach_sub_(d, y)
        torch._foreach_add_(d, grads)
        torch._foreach_copy_(y, grads)
        upd = torch._foreach_mul(d, lrs)
        torch._foreach_div_(upd, float(min(step, _F32(self._batch_num))))
        torch._foreach_sub_(p32s, upd)


class Rprop(Optimizer):
    def __init__(self, learning_rate=0.001, learning_rate_range=(1e-5, 50.0),
                 parameters=None, etas=(0.5, 1.2), grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, multi_precision)
        self._lr_range = learning_rate_range
        self._etas = etas

    def _init_state(self, p):
        return {"prev_grad": _zeros(p),
                "lrs": torch.full(p.shape, self.get_lr(), dtype=torch.float32,
                                  device=p.device)}

    def _apply(self, grads, states, p32s, lrs, wd, step, hyper):
        eta_neg, eta_pos = self._etas
        prev = [s["prev_grad"] for s in states]
        rates = [s["lrs"] for s in states]
        sign = torch._foreach_sign(torch._foreach_mul(grads, prev))
        pos = torch._foreach_clamp_min(sign, 0.0)                 # 1 where sign > 0
        neg = torch._foreach_clamp_min(torch._foreach_neg(sign), 0.0)  # 1 where sign < 0
        # factor = eta_pos where sign > 0, eta_neg where sign < 0, else 1
        same = torch._foreach_add(torch._foreach_add(torch._foreach_neg(pos), 1.0),
                                  torch._foreach_neg(neg))
        factor = torch._foreach_add(torch._foreach_mul(pos, eta_pos),
                                    torch._foreach_mul(neg, eta_neg))
        torch._foreach_add_(factor, same)
        torch._foreach_mul_(rates, factor)
        torch._foreach_clamp_min_(rates, float(self._lr_range[0]))
        torch._foreach_clamp_max_(rates, float(self._lr_range[1]))
        # the gradient is dropped where its sign flipped
        g_eff = torch._foreach_mul(grads, torch._foreach_add(torch._foreach_neg(neg), 1.0))
        torch._foreach_copy_(prev, g_eff)
        torch._foreach_sub_(p32s, torch._foreach_mul(rates, torch._foreach_sign(g_eff)))


class LBFGS(Optimizer):
    """L-BFGS (reference: python/paddle/optimizer/lbfgs.py), as the JAX
    package runs it: one two-loop step a call on the flat parameter vector,
    with ``closure()`` giving the loss (and the gradients), the curvature
    history on the host side of the loop. Per-tensor ops: the rule works on
    one flat vector, not on a group; it reads ``s . y`` on the host.
    ``max_iter``, ``max_eval``, the tolerances and ``line_search_fn`` are
    accepted and unused, as in the JAX package (one iteration a call, no
    line search); so are ``weight_decay`` and ``grad_clip``."""

    def __init__(self, learning_rate=1.0, max_iter=20, max_eval=None, tolerance_grad=1e-7,
                 tolerance_change=1e-9, history_size=100, line_search_fn=None,
                 parameters=None, weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._hist = history_size
        self._s, self._y = [], []
        self._prev_flat_g = None
        self._prev_flat_x = None

    @staticmethod
    def _flat(vals):
        return torch.cat([v.reshape(-1).float() for v in vals])

    @torch.no_grad()
    def step(self, closure=None):
        if closure is None:
            raise ValueError("LBFGS.step requires a closure returning the loss")
        with torch.enable_grad():
            loss = closure()
        params = self._params
        g = self._flat([p.grad for p in params])
        x = self._flat(params)  # the pre-update iterate
        if self._prev_flat_g is not None:
            s = x - self._prev_flat_x
            y = g - self._prev_flat_g
            if float(torch.dot(s, y)) > 1e-10:
                self._s.append(s)
                self._y.append(y)
                if len(self._s) > self._hist:
                    self._s.pop(0)
                    self._y.pop(0)
        q = g
        alphas = []
        for s, y in zip(reversed(self._s), reversed(self._y)):
            rho = 1.0 / torch.dot(y, s)
            a = rho * torch.dot(s, q)
            q = q - a * y
            alphas.append((a, rho))
        if self._s:
            q = torch.dot(self._s[-1], self._y[-1]) / torch.dot(self._y[-1], self._y[-1]) * q
        for (a, rho), s, y in zip(reversed(alphas), self._s, self._y):
            b = rho * torch.dot(y, q)
            q = q + (a - b) * s
        new_x = x + self.get_lr() * -q
        off = 0
        for p in params:
            n = p.numel()
            p.copy_(new_x[off:off + n].reshape(p.shape))
            off += n
        self._prev_flat_g = g
        self._prev_flat_x = x
        return loss
