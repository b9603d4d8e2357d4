"""The framework layer of the port: parameters that carry the JAX package's
generated names (below), and the modules ``dtype`` (dtype names and the
default dtype), ``flags`` (``set_flags``/``get_flags``), ``random`` (``seed``
and the generators' states), ``core`` (``to_tensor``), ``enforce`` (the typed
errors) and ``containers`` (``SelectedRows``, ``StringTensor``).

The port has no tensor class of its own: its ``Tensor`` is ``torch.Tensor``,
which every model, engine, optimizer and compiler path takes and returns.

``Parameter`` is the port of ``paddle_tpu/framework/core.py``'s
``Parameter`` naming, ``param_{N}`` from one process-wide counter.
``AdamW`` calls ``apply_decay_param_fun`` with these names, as the JAX
package's ``AdamW.step`` does with ``p.name``.

``torch.Tensor.name`` is a read-only attribute of the C tensor that reads
``None``, so a plain ``torch.nn.Parameter`` cannot carry a name. ``Parameter``
below is a ``torch.nn.Parameter`` whose ``name`` is a Python property stored
in the instance's ``__dict__``, which shadows that attribute. It is the same
tensor to every other reader (state dicts, the optimizer, autograd); it keeps
its name through ``module.to()``, which updates a parameter in place, and
through ``copy.deepcopy``.

As the JAX package's parameters, each carries ``need_clip`` (True: gradient
clipping applies to it) and ``optimize_attr`` (``{"learning_rate": 1.0}``,
the multiplier of the optimizer's learning rate for this parameter).
"""
from __future__ import annotations

import itertools

import torch
from torch import nn

__all__ = ["Parameter", "name_parameters", "Tensor"]

Tensor = torch.Tensor

_counter = itertools.count(1)  # process-wide, as the JAX package's
#: bumped when ``amp.decorate`` recasts parameters in place; a program
#: captured before (``jit/_cuda_graph.py``) refuses to replay after it
PARAM_EPOCH = [0]


class Parameter(nn.Parameter):
    """A trainable tensor named ``param_{N}`` (or ``name``) when it is built."""

    def __new__(cls, data=None, requires_grad=True, name=None):
        p = super().__new__(cls, data, requires_grad)
        p.__dict__["_name"] = name if name is not None else f"param_{next(_counter)}"
        p.need_clip = True
        p.optimize_attr = {"learning_rate": 1.0}
        return p

    @property
    def name(self):
        return self.__dict__["_name"]

    @name.setter
    def name(self, value):
        self.__dict__["_name"] = value

    def __deepcopy__(self, memo):
        if id(self) not in memo:
            twin = type(self)(self.data.clone(memory_format=torch.preserve_format),
                              self.requires_grad, name=self.name)
            twin.need_clip = self.need_clip
            twin.optimize_attr = dict(self.optimize_attr)
            memo[id(self)] = twin
        return memo[id(self)]


def name_parameters(module: nn.Module) -> nn.Module:
    """Make ``module``'s own parameters named ``Parameter``s, in registration
    order (torch's layers, such as ``nn.Linear``, build plain ones). The
    tensors' storage, values and ``requires_grad`` are kept. Returns
    ``module``."""
    for key, p in list(module.named_parameters(recurse=False)):
        if not isinstance(p, Parameter):
            setattr(module, key, Parameter(p, p.requires_grad))
    return module


from . import enforce  # noqa: E402,F401
