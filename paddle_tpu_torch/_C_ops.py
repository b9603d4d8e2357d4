"""paddle._C_ops: the port of ``paddle_tpu/_C_ops.py``.

Reference analog: the generated Python-C op module (paddle._C_ops), which a
great deal of user code calls directly. The port has no generated layer: its
registry (``ops/_apply.py``) is the op table. ``_C_ops.foo`` resolves on
first use (PEP 562) onto the callable the public namespaces give that name,
in order ``ops`` (the in-place ``foo_`` forms too), ``tensor`` and
``nn.functional``; else onto the registry's ``foo`` through the dispatch.
The legacy ``final_state_foo`` spelling maps to ``foo``.
"""
from __future__ import annotations

_CACHE = {}


def _resolve(name):
    if name in _CACHE:
        return _CACHE[name]
    target = name.removeprefix("final_state_")

    from . import nn, ops, tensor

    for src in (ops, tensor, nn.functional):
        fn = getattr(src, target, None)
        if callable(fn):
            _CACHE[name] = fn
            return fn
    from .ops._apply import apply, get_registry

    # a registered op without a public binding dispatches as it is; an
    # unbound in-place spelling finds nothing (it must not run out of place)
    opdef = get_registry().get(target)
    if opdef is not None:
        def fn(*args, _opdef=opdef, **kwargs):
            return apply(_opdef, *args, **kwargs)

        fn.__name__ = name
        _CACHE[name] = fn
        return fn
    return None


def __getattr__(name):
    fn = _resolve(name)
    if fn is None:
        raise AttributeError(
            f"paddle._C_ops has no op {name!r} (not in the op registry or any "
            "public namespace)")
    return fn


def __dir__():
    from .ops._apply import get_registry

    return sorted(set(get_registry()) | set(_CACHE))
