"""Static-graph capture: the port of paddle_tpu/framework/capture.py, plus the
recording itself.

Under ``static.program_guard`` (or after ``enable_static``) the building code
runs eagerly on placeholder tensors and every call the replay must redo is
recorded into the active ``static.Program``; ``Executor.run`` replays the
record with the feed in the placeholders' place. The JAX package records
only its dispatched ops, because its ``Tensor`` methods dispatch; the port's
tensor is ``torch.Tensor``, whose Python operators never reach the port's
dispatch, so the port records at three places:

  * ``Variable``, the ``torch.Tensor`` subclass of ``static.data``'s
    placeholder and of every recorded output: its ``__torch_function__``
    records any torch call that touches one, on any thread, into that
    thread's active program;
  * ``_CaptureMode``, a ``TorchFunctionMode`` that ``program_guard`` enters on
    its own thread, records the calls on parameters alone (a cast or a
    transposed copy of a weight), so the replay reads the live parameter;
  * the port's op dispatch (``ops/_apply.py``), ``recompute`` and
    ``jit.to_static`` record their call as one entry and run it with the
    recording off, so an op is recorded once, not as the torch calls inside
    it, and a recompute segment replays as a recompute segment.
A call is recorded when one of its arguments is live: a ``Variable``, a
``_SymDim``, or a parameter under grad mode (but not an in-place call on a
parameter: initialisation). Calls on nothing live (a constant table) run once at capture,
as in the JAX package. Each entry keeps the grad mode it was recorded under.

The active program resolves thread-locally first, then to the process-global
default (``enable_static``); ``_ANY`` is one lock-maintained bool, "some
program is active somewhere", which is the only thing the dispatch's hot path
reads. A thread-local entry of None masks the default (the replay runs so).
"""
from __future__ import annotations

import threading
import warnings
import weakref

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._pytree import tree_flatten, tree_unflatten

_TLS = threading.local()
_UNSET = object()
_DEFAULT = [None]      # process-global default program (enable_static)
_LOCK = threading.Lock()
_HOLDERS = weakref.WeakSet()  # live threads holding a non-None TLS program
#: [some capture target exists anywhere]: the dispatch hot path's one read
_ANY = [False]


def active():
    v = getattr(_TLS, "program", _UNSET)
    if v is _UNSET:
        return _DEFAULT[0]
    return v


def _recount_locked():
    dead = [t for t in _HOLDERS if not t.is_alive()]
    for t in dead:
        _HOLDERS.discard(t)
    _ANY[0] = bool(_HOLDERS) or _DEFAULT[0] is not None


def _set_raw(value):
    with _LOCK:
        if value is not _UNSET and value is not None:
            _HOLDERS.add(threading.current_thread())
        else:
            _HOLDERS.discard(threading.current_thread())
        if value is _UNSET:
            try:
                del _TLS.program
            except AttributeError:
                pass
        else:
            _TLS.program = value
        _recount_locked()


def swap(program):
    """Set the calling thread's capture target, returning a token for
    ``restore``, which puts back the thread's raw state (unset, explicit None
    or a program)."""
    token = getattr(_TLS, "program", _UNSET)
    _set_raw(program)
    return token


def restore(token):
    _set_raw(token)


def set_default(program):
    """Set the process-global default program (``enable_static``)."""
    with _LOCK:
        _DEFAULT[0] = program
        _recount_locked()


def _busy():
    return getattr(_TLS, "busy", 0)


class _SymDim(int):
    """A dim read from a captured tensor's ``.shape`` during capture.

    ``static.data`` builds dynamic dims (None/-1) as 1 for the capture pass.
    A dim read from a placeholder's dynamic axis, or from any axis of a
    recorded tensor, carries its (tensor, axis) origin, and ``Executor.run``
    re-resolves it in a recorded call's arguments from the live tensor, so
    ``reshape(x, [x.shape[0], -1])`` and ``B, S = h.shape[:2]`` replay at the
    fed batch. Arithmetic gives a plain (baked) int: on a placeholder's
    dynamic dim with the JAX package's warning."""

    def __new__(cls, val, src, axis, warn=False):
        o = int.__new__(cls, val)
        o._src = src
        o._axis = axis
        o._warn = warn
        return o

    def _degrade(self, op):
        if self._warn:
            warnings.warn(
                f"arithmetic ({op}) on a dynamic placeholder dim bakes the "
                "capture-time value 1 into the program; pass -1 to reshape or "
                "move the computation into the fed tensor instead",
                stacklevel=3)

    def resolve(self, env):
        live = env.get(id(self._src))
        return int(self) if live is None else int(live.shape[self._axis])

    def __reduce__(self):  # pickling drops the symbolic link
        return (int, (int(self),))


def _sym_degrading(name):
    base = getattr(int, name)

    def op(self, *a):
        self._degrade(name)
        return base(int(self), *a)

    return op


for _n in ("__add__", "__radd__", "__sub__", "__rsub__", "__mul__", "__rmul__",
           "__floordiv__", "__rfloordiv__", "__mod__", "__neg__", "__truediv__",
           "__rtruediv__"):
    setattr(_SymDim, _n, _sym_degrading(_n))


class Variable(torch.Tensor):
    """A captured tensor (paddle's static ``Variable``): the placeholder of
    ``static.data`` or the output of a recorded call. Outside capture it is
    a plain tensor to every call. ``name`` is settable (``loss.name =
    "loss"`` for fetch by name)."""

    _dyn_axes = None  # a placeholder's dynamic axes; None: a recorded output

    @property
    def name(self):
        return self.__dict__.get("_var_name")

    @name.setter
    def name(self, value):
        self.__dict__["_var_name"] = value

    @property
    def shape(self):
        with torch._C.DisableTorchFunctionSubclass():
            size = torch.Tensor.shape.__get__(self)
        if _busy() or active() is None:
            return size
        if self._dyn_axes is not None:
            return tuple(_SymDim(s, self, i, warn=True) if i in self._dyn_axes else s
                         for i, s in enumerate(size))
        return tuple(_SymDim(s, self, i) for i, s in enumerate(size))

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        prog = None if _busy() else active()
        if prog is None or _inplace_on_param(func, args, kwargs):
            with torch._C.DisableTorchFunctionSubclass():
                return func(*args, **kwargs)
        if func is torch.Tensor.size:
            shape = args[0].shape
            return shape if len(args) == 1 and "dim" not in kwargs else \
                shape[args[1] if len(args) > 1 else kwargs["dim"]]
        return call(func, args, kwargs, prog)


_SETITEM = torch.Tensor.__setitem__
#: calls on a parameter that hand out its storage for state handling
#: (``p.data.fill_``, ``p.detach().copy_``): never recorded
_PARAM_STATE = (_SETITEM, torch.Tensor.data.__get__, torch.Tensor.detach)


def _inplace_on_param(func, args, kwargs):
    """An in-place call on a parameter (initialisation, ``set_state_dict``):
    never recorded, so a replay cannot re-initialise a trained weight. The
    target is the first argument, positional or (``nn.init``) keyword."""
    target = args[0] if args else next(iter(kwargs.values()), None)
    if not isinstance(target, torch.nn.Parameter):
        return False
    name = getattr(func, "__name__", "")
    return func in _PARAM_STATE or (name.endswith("_") and not name.startswith("__")) or \
        name.startswith("__i")


def wants(args, kwargs):
    """The calling thread's active program if a call on these arguments is
    to be recorded, else None: a call on a ``Variable`` or a ``_SymDim``, or
    on a parameter with grad enabled (under no_grad a parameter-only call is
    state handling, ``set_state_dict``'s copies, not the forward)."""
    if _busy():
        return None
    prog = active()
    if prog is None:
        return None
    flat, _ = tree_flatten((args, kwargs))
    grad = torch.is_grad_enabled()
    for leaf in flat:
        if isinstance(leaf, (Variable, _SymDim)) or (
                grad and isinstance(leaf, torch.nn.Parameter)):
            return prog
    return None


def _wrap(out):
    if isinstance(out, torch.Tensor) and not isinstance(out, Variable):
        with torch._C.DisableTorchFunction():
            return out.as_subclass(Variable)
    return out


def call(fn, args, kwargs, prog, unwrap=False):
    """Run ``fn(*args, **kwargs)`` with the recording off, wrap its tensor
    outputs as ``Variable``s and record the call into ``prog``; a call that
    returns no tensor (a dtype, a Python number) is not recorded, except
    ``__setitem__``. ``unwrap`` hands plain tensors to ``fn`` (Dynamo)."""
    flat, spec = tree_flatten((args, kwargs))
    if unwrap:
        with torch._C.DisableTorchFunction():
            plain = [l.as_subclass(torch.Tensor) if isinstance(l, Variable) else l
                     for l in flat]
        a, k = tree_unflatten(plain, spec)
    else:
        a, k = args, kwargs
    grad = torch.is_grad_enabled()
    _TLS.busy = _busy() + 1
    try:
        with torch._C.DisableTorchFunction():
            out = fn(*a, **k)
    finally:
        _TLS.busy -= 1
    out_flat, out_spec = tree_flatten(out)
    pos = [i for i, o in enumerate(out_flat) if isinstance(o, torch.Tensor)]
    if not pos and fn is not _SETITEM:
        return out
    out_flat = [_wrap(o) if i in pos else o for i, o in enumerate(out_flat)]
    prog._record_op("call", (fn, spec, grad), flat, [(i, out_flat[i]) for i in pos])
    return tree_unflatten(out_flat, out_spec)


class _CaptureMode(TorchFunctionMode):
    """Entered by ``program_guard`` on its thread: records the torch calls on
    parameters alone; a call touching a ``Variable`` goes on to its
    ``__torch_function__``."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not _busy() and not any(issubclass(t, Variable) for t in types):
            prog = wants(args, kwargs)
            if prog is not None and not _inplace_on_param(func, args, kwargs):
                return call(func, args, kwargs, prog)
        return func(*args, **kwargs)
