"""paddle.quantization of the port: the port of paddle_tpu/quantization/__init__.py.

Fake quantization is tensor algebra with a straight-through estimator:
``quant_dequant`` (the op ``fake_quant_dequant``) and its per-channel form
(``fake_channel_quant_dequant``) return ``x + (q(x) - x).detach()``, with
``q(x) = clip(round(x / s * qmax), -qmax, qmax) * s / qmax``, ``s`` at least
1e-8. ``FakeQuanterWithAbsMax`` keeps a host float scale: the first training
call's absmax, then an EMA (``moving_rate``) or the running max
(``moving_rate=None``); ``FakeQuanterChannelWiseAbsMax`` a float64 numpy
running max per channel. Both read the tensor's absmax to the host on every
training call, as in JAX; that read runs outside a compiled graph
(``torch.compiler.disable``), so under ``jit.to_static`` the graph breaks
there and the output and the running scale equal eager's. Evaluated before
any training call, a quanter warns (and the channel-wise one uses ones).

``QAT.quantize`` wraps each quantable sublayer (``QuantConfig``: the public
``Linear`` and ``Conv2D`` by default, or ``add_type_config``'s types) in a
``_QuantedWrapper``, which fake-quantizes the input and the weight and runs
the inner layer with the quantized weight through
``torch.func.functional_call``, leaving the parameter itself untouched (the
gradient reaches it straight through). ``QAT.convert`` freezes only the
``FakeQuanterWithAbsMax`` quanters (``eval()``): a channel-wise quanter keeps
the mode the model is in, as in JAX. ``PTQ`` uses running-max quanters and
``calibrate`` runs batches in training mode, then converts. ``quanter(name)``
installs a ``QuanterFactory`` maker under ``name`` in this package and in the
decorated class's module, and refuses a name this package already has.
"""
from __future__ import annotations

import sys
import warnings

import numpy as np
import torch

from ..nn.layer.layers import Layer
from ..ops._apply import defop
from .observers import (  # noqa: F401
    AbsmaxChannelWiseObserver,
    AbsmaxObserver,
    GroupWiseWeightObserver,
    HistObserver,
)
from .weight_only import (  # noqa: F401
    WeightOnlyLinear,
    quantize_for_inference,
    weight_dequantize,
    weight_only_linear,
    weight_quantize,
)

__all__ = ["QuantConfig", "QAT", "PTQ", "FakeQuanterWithAbsMax",
           "FakeQuanterChannelWiseAbsMax", "AbsmaxObserver",
           "AbsmaxChannelWiseObserver", "HistObserver",
           "GroupWiseWeightObserver", "quant_dequant", "weight_quantize",
           "weight_dequantize", "weight_only_linear", "WeightOnlyLinear",
           "quantize_for_inference",
           # reference quanter-factory aliases
           "FakeQuanterWithAbsMaxObserver",
           "FakeQuanterChannelWiseAbsMaxObserver"]


def _qdq(x, s, qmax):
    q = torch.clamp(torch.round(x / s * qmax), -qmax, qmax)
    # straight-through estimator: the gradient passes as the identity
    return x + (q * s / qmax - x).detach()


@defop("fake_quant_dequant")
def _fake_qdq(x, scale, bits=8):
    return _qdq(x, torch.clamp(scale, min=1e-8), float(2 ** (bits - 1) - 1))


def quant_dequant(x, scale, bits=8):
    return _fake_qdq(x, scale, bits=bits)


class FakeQuanterWithAbsMax(Layer):
    """QAT quanter (reference quanters.FakeQuanterWithAbsMaxObserver):
    ``moving_rate`` a float, an EMA of the batches' absmax; None, the running
    max (the reference's abs_max PTQ observer)."""

    def __init__(self, quant_bits=8, moving_rate=0.9):
        super().__init__()
        self.quant_bits = quant_bits
        self.moving_rate = moving_rate
        self._scale = 0.0
        self._calibrated = False

    @torch.compiler.disable
    def _host_scale(self, x):
        """Fold this call's absmax into the host scale (training) and return
        the scale to quantize with, a float32 tensor on ``x``'s device."""
        if self.training:
            self._accumulate_scale(float(x.detach().abs().max()))
        elif not self._calibrated:
            warnings.warn("FakeQuanterWithAbsMax evaluated with no calibrated scale; "
                          "run at least one training step first", stacklevel=3)
        return torch.tensor(max(self._scale, 1e-8), dtype=torch.float32, device=x.device)

    def forward(self, x):
        return quant_dequant(x, self._host_scale(x), bits=self.quant_bits)

    def _accumulate_scale(self, cur):
        cur = float(np.asarray(cur))
        if not self._calibrated:
            self._scale = cur
            self._calibrated = True
        elif self.moving_rate is None:
            self._scale = max(self._scale, cur)          # PTQ running absmax
        else:
            self._scale = self.moving_rate * self._scale + (1 - self.moving_rate) * cur


@defop("fake_channel_quant_dequant")
def _fake_qdq_channel(x, scale, bits=8, axis=-1):
    shape = [1] * x.dim()
    shape[axis] = -1
    return _qdq(x, torch.clamp(scale, min=1e-8).reshape(shape), float(2 ** (bits - 1) - 1))


class FakeQuanterChannelWiseAbsMax(Layer):
    """Per-channel quanter (reference
    quanters.FakeQuanterChannelWiseAbsMaxObserver): one scale per slice along
    ``axis``, the running max across training calls."""

    def __init__(self, quant_bits=8, axis=-1):
        super().__init__()
        self.quant_bits = quant_bits
        self.axis = axis
        self._scale = None

    @torch.compiler.disable
    def _host_scale(self, x, ax):
        if self.training:
            cur = np.abs(x.detach().cpu().to(torch.float64).numpy())
            reduce_axes = tuple(i for i in range(cur.ndim) if i != ax)
            cur = cur.max(axis=reduce_axes) if reduce_axes else cur
            self._scale = cur if self._scale is None else np.maximum(self._scale, cur)
        elif self._scale is None:
            warnings.warn("FakeQuanterChannelWiseAbsMax evaluated with no calibrated scale "
                          "(falling back to ones); run at least one training step first",
                          stacklevel=3)
        s = self._scale if self._scale is not None else np.ones(x.shape[ax])
        return torch.tensor(np.maximum(s, 1e-8), dtype=torch.float32, device=x.device)

    def forward(self, x):
        ax = self.axis % x.dim()
        return _fake_qdq_channel(x, self._host_scale(x, ax), bits=self.quant_bits, axis=ax)

    def _accumulate_scale(self, cur):
        cur = np.asarray(cur, np.float64)
        self._scale = cur if self._scale is None else np.maximum(self._scale, cur)


# the reference's factory names resolve to the layer-level quanters here
FakeQuanterWithAbsMaxObserver = FakeQuanterWithAbsMax
FakeQuanterChannelWiseAbsMaxObserver = FakeQuanterChannelWiseAbsMax


class QuantConfig:
    """reference config.QuantConfig: which layer types get which quanters."""

    def __init__(self, activation=None, weight=None):
        self.activation = activation or (lambda: FakeQuanterWithAbsMax())
        self.weight = weight or (lambda: FakeQuanterWithAbsMax())
        self._type_cfg = {}     # layer type -> (activation factory, weight factory)

    def add_type_config(self, layer_types, activation=None, weight=None):
        if not isinstance(layer_types, (list, tuple)):
            layer_types = [layer_types]
        for t in layer_types:
            self._type_cfg[t] = (activation or self.activation, weight or self.weight)

    def quantable_types(self):
        if self._type_cfg:
            return tuple(self._type_cfg)
        from ..nn.layer.common import Linear
        from ..nn.layer.conv import Conv2D

        return (Linear, Conv2D)

    def quanters_for(self, layer):
        """(activation quanter, weight quanter) honoring per-type overrides."""
        for t, (act, wt) in self._type_cfg.items():
            if isinstance(layer, t):
                return act(), wt()
        return self.activation(), self.weight()


class _QuantedWrapper(Layer):
    """Wraps a Linear/Conv: fake-quantizes the input and the weight."""

    def __init__(self, inner, config):
        super().__init__()
        self.inner = inner
        self.act_quanter, self.weight_quanter = config.quanters_for(inner)

    def forward(self, x):
        xq = self.act_quanter(x)
        wq = self.weight_quanter(self.inner.weight)
        return torch.func.functional_call(self.inner, {"weight": wq}, (xq,))


def _swap_quantable(model, config):
    count = 0
    types = config.quantable_types()
    for _, layer in list(model.named_modules(remove_duplicate=False)):
        for name, sub in list(layer._modules.items()):
            if isinstance(sub, types) and not isinstance(sub, _QuantedWrapper):
                layer._modules[name] = _QuantedWrapper(sub, config)
                count += 1
    return count


class QAT:
    """Quantization-aware training entry (reference qat.QAT)."""

    def __init__(self, config=None):
        self.config = config or QuantConfig()

    def quantize(self, model, inplace=True):
        if _swap_quantable(model, self.config) == 0:
            raise ValueError("no quantable layers found")
        return model

    def convert(self, model, inplace=True):
        """Freeze the ``FakeQuanterWithAbsMax`` quanters (module docstring)."""
        for layer in model.modules():
            if isinstance(layer, FakeQuanterWithAbsMax):
                layer.eval()
        return model


class PTQ:
    """Post-training quantization (reference ptq.PTQ): observe, then freeze,
    with running-max quanters (``moving_rate=None``), so one large
    calibration batch is never decayed away."""

    def __init__(self, config=None):
        self.config = config or QuantConfig(
            activation=lambda: FakeQuanterWithAbsMax(moving_rate=None),
            weight=lambda: FakeQuanterWithAbsMax(moving_rate=None))

    def quantize(self, model, inplace=True):
        return QAT(self.config).quantize(model, inplace=inplace)

    def calibrate(self, model, data_iter, steps=None):
        model.train()  # the quanters fold each batch's absmax in
        for i, batch in enumerate(data_iter):
            if steps is not None and i >= steps:
                break
            model(batch if isinstance(batch, torch.Tensor) else batch[0])
        return self.convert(model)

    def convert(self, model, inplace=True):
        return QAT(self.config).convert(model, inplace=inplace)


class BaseQuanter(Layer):
    """reference quantization/base_quanter.py: the extension base for custom
    quanters; subclasses implement forward (the fake-quantized output),
    scales(), zero_points(), quant_axis(), bit_length()."""

    def forward(self, input):  # noqa: A002 - reference arg name
        raise NotImplementedError

    def scales(self):
        raise NotImplementedError

    def zero_points(self):
        raise NotImplementedError

    def quant_axis(self):
        return -1

    def bit_length(self):
        return 8


class BaseObserver(BaseQuanter):
    """reference quantization/base_observer.py: a quanter that calibrates;
    cal_thresholds() finalizes the observed statistics."""

    def cal_thresholds(self):
        raise NotImplementedError


class QuanterFactory:
    """A zero-argument factory holding a quanter's constructor arguments: the
    callable ``QuantConfig(activation=..., weight=...)`` expects.
    ``instance()`` is the same call."""

    def __init__(self, cls, args, kwargs):
        self._cls = cls
        self._args = args
        self._kwargs = kwargs

    def __call__(self):
        return self._cls(*self._args, **self._kwargs)

    instance = __call__

    def __repr__(self):
        return f"QuanterFactory({self._cls.__name__})"


def quanter(class_name):
    """reference quantization/factory.py: declare a factory alias for a
    custom quanter class (module docstring)::

        @quanter("CustomizedQuanter")
        class CustomizedQuanterLayer(BaseQuanter): ...
    """

    def deco(cls):
        def factory(*args, **kwargs):
            return QuanterFactory(cls, args, kwargs)

        factory.__name__ = class_name
        factory.__qualname__ = class_name
        factory.__doc__ = f"Factory for {cls.__name__} (quanter annotation)."
        if globals().get(class_name) is not None:
            raise ValueError(
                f"@quanter({class_name!r}): paddle.quantization already "
                "exports that name; pick another factory name")
        mod = sys.modules.get(cls.__module__)
        if mod is not None and not hasattr(mod, class_name):
            setattr(mod, class_name, factory)
        globals()[class_name] = factory
        return cls

    return deco


__all__ += ["BaseQuanter", "BaseObserver", "quanter", "QuanterFactory"]
