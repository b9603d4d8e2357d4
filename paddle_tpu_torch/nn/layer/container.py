"""Container layers: the port of paddle_tpu/nn/layer/container.py
(``Sequential``, with named pairs, ``LayerList``, ``LayerDict``,
``ParameterList``, ``ParameterDict``), each a ``Layer`` whose sublayers or
parameters are torch's ``_modules``/``_parameters``, keyed as the JAX
containers key them."""
from __future__ import annotations

import collections

from .layers import Layer

__all__ = ["Sequential", "LayerList", "LayerDict", "ParameterList", "ParameterDict"]


class Sequential(Layer):
    def __init__(self, *layers):
        super().__init__()
        if len(layers) == 1 and isinstance(layers[0], collections.OrderedDict):
            for name, layer in layers[0].items():
                self.add_sublayer(name, layer)
        elif len(layers) > 0 and isinstance(layers[0], (list, tuple)):
            for name, layer in layers:
                self.add_sublayer(name, layer)
        else:
            for i, layer in enumerate(layers):
                self.add_sublayer(str(i), layer)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return Sequential(*list(self._modules.values())[idx])
        keys = list(self._modules.keys())
        return self._modules[keys[idx]]

    def __setitem__(self, idx, layer):
        keys = list(self._modules.keys())
        self._modules[keys[idx]] = layer

    def __delitem__(self, idx):
        keys = list(self._modules.keys())
        del self._modules[keys[idx]]

    def __len__(self):
        return len(self._modules)

    def forward(self, x):
        for layer in self._modules.values():
            x = layer(x)
        return x


class LayerList(Layer):
    def __init__(self, sublayers=None):
        super().__init__()
        if sublayers is not None:
            for i, layer in enumerate(sublayers):
                self.add_sublayer(str(i), layer)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return LayerList(list(self._modules.values())[idx])
        if idx < 0:
            idx += len(self._modules)
        return self._modules[str(idx)]

    def __setitem__(self, idx, layer):
        self.add_sublayer(str(idx), layer)

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())

    def append(self, layer):
        self.add_sublayer(str(len(self._modules)), layer)
        return self

    def insert(self, index, layer):
        layers = list(self._modules.values())
        layers.insert(index, layer)
        self._modules.clear()
        for i, sub in enumerate(layers):
            self._modules[str(i)] = sub

    def extend(self, layers):
        for sub in layers:
            self.append(sub)
        return self


class LayerDict(Layer):
    def __init__(self, sublayers=None):
        super().__init__()
        if sublayers is not None:
            self.update(sublayers)

    def __getitem__(self, key):
        return self._modules[key]

    def __setitem__(self, key, layer):
        self.add_sublayer(key, layer)

    def __delitem__(self, key):
        del self._modules[key]

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules)

    def __contains__(self, key):
        return key in self._modules

    def clear(self):
        self._modules.clear()

    def pop(self, key):
        return self._modules.pop(key)

    def keys(self):
        return self._modules.keys()

    def items(self):
        return self._modules.items()

    def values(self):
        return self._modules.values()

    def update(self, sublayers):
        pairs = sublayers.items() if isinstance(sublayers, dict) else sublayers
        for k, v in pairs:
            self[k] = v


class ParameterList(Layer):
    def __init__(self, parameters=None):
        super().__init__()
        if parameters is not None:
            for i, p in enumerate(parameters):
                self.add_parameter(str(i), p)

    def __getitem__(self, idx):
        return self._parameters[str(idx)]

    def __setitem__(self, idx, param):
        self.add_parameter(str(idx), param)

    def __len__(self):
        return len(self._parameters)

    def __iter__(self):
        return iter(self._parameters.values())

    def append(self, parameter):
        self.add_parameter(str(len(self._parameters)), parameter)
        return self


class ParameterDict(Layer):
    def __init__(self, parameters=None):
        super().__init__()
        if parameters is not None:
            pairs = parameters.items() if isinstance(parameters, dict) else parameters
            for k, v in pairs:
                self.add_parameter(k, v)

    def __getitem__(self, key):
        return self._parameters[key]

    def __setitem__(self, key, param):
        self.add_parameter(key, param)

    def __len__(self):
        return len(self._parameters)

    def __iter__(self):
        return iter(self._parameters)

    def keys(self):
        return self._parameters.keys()

    def items(self):
        return self._parameters.items()

    def values(self):
        return self._parameters.values()
