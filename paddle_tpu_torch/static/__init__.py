"""paddle.static: the port of paddle_tpu/static (capture-replay Program and
Executor, inference export, and the rest of the static surface).

Code inside ``program_guard`` runs eagerly on ``static.data`` placeholders
(dynamic dims built as 1), and every call the replay must redo is recorded
(``framework/capture.py``: the placeholder's ``__torch_function__``, a
``TorchFunctionMode`` on the guard's thread, and the port's op dispatch).
``Executor.run`` replays the record through the normal eager path with the
feed in the placeholders' place: layer parameters are live objects read at
replay time, so ``optimizer.minimize`` registered during the guard trains
them across ``run()`` calls, and the hand-written kernels launch in a
replayed step exactly as in an eager one. ``save_inference_model`` and
``load_inference_model`` ride the port's ``jit.save``/``jit.load``
(``torch.export``), and export a Layer.
"""
from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from ..framework import capture
from ..framework.capture import Variable, _SymDim
from ..framework import dtype as dtype_mod
from ..jit.api import InputSpec  # noqa: F401  (paddle.static.InputSpec)
from ..nn.layer.layers import Layer  # noqa: F401  (as the JAX module exposes it)

Tensor = torch.Tensor

__all__ = [
    "InputSpec", "Program", "Executor", "CompiledProgram", "data",
    "default_main_program", "default_startup_program", "program_guard",
    "save_inference_model", "load_inference_model", "name_scope", "scope_guard",
    "global_scope", "cpu_places", "device_guard", "amp",
]


class Program:
    """paddle's static ``Program``, capture-replay form: the placeholders
    (``_inputs``), the recorded entries (``_ops``), every captured output
    (for fetch by name), the train hooks ``minimize`` registers and the
    parameters ``static.nn`` builders created."""

    def __init__(self):
        self._inputs = {}
        self._ops = []
        self._out_tensors = []
        self._train_hooks = []
        self._parameters = []

    # called by framework.capture while this program is active
    def _record_op(self, kind, payload, t_leaves, outputs):
        self._ops.append((kind, payload, list(t_leaves), list(outputs)))
        self._out_tensors.extend(o[1] if isinstance(o, tuple) else o for o in outputs)

    def clone(self, for_test=False):
        p = Program()
        p._inputs = dict(self._inputs)
        p._ops = list(self._ops)
        p._out_tensors = list(self._out_tensors)
        p._train_hooks = [] if for_test else list(self._train_hooks)
        p._parameters = list(self._parameters)
        if hasattr(self, "_amp_ctx"):
            p._amp_ctx = self._amp_ctx
        return p

    def all_parameters(self):
        """Parameters created by static.nn builders under this program."""
        return list(self._parameters)

    def retarget_train_hook(self, old_opt, new_opt):
        """Point the train hooks of ``old_opt`` at ``new_opt`` (the
        optimizer-wrapper idiom: static.amp's decorate)."""
        self._train_hooks = [(lt, new_opt if opt is old_opt else opt)
                             for lt, opt in self._train_hooks]

    def global_block(self):
        return self

    def list_vars(self):
        return list(self._inputs.values()) + list(self._out_tensors)

    def __repr__(self):
        return f"Program(inputs={list(self._inputs)}, ops={len(self._ops)})"


_MAIN = [Program()]
_STARTUP = [Program()]
_PROG_TLS = threading.local()


def default_main_program():
    """This thread's guarded program, else the process-global default."""
    return getattr(_PROG_TLS, "main", None) or _MAIN[0]


def default_startup_program():
    return getattr(_PROG_TLS, "startup", None) or _STARTUP[0]


@contextlib.contextmanager
def program_guard(main_program, startup_program=None):
    old_main = getattr(_PROG_TLS, "main", None)
    old_start = getattr(_PROG_TLS, "startup", None)
    _PROG_TLS.main = main_program
    if startup_program is not None:
        _PROG_TLS.startup = startup_program
    token = capture.swap(main_program)
    mode = capture._CaptureMode()
    mode.__enter__()
    try:
        yield
    finally:
        mode.__exit__(None, None, None)
        _PROG_TLS.main, _PROG_TLS.startup = old_main, old_start
        capture.restore(token)


def data(name, shape, dtype="float32", lod_level=0):
    """A placeholder ``Variable`` on the default device: dynamic dims (None or
    -1) are 1 for the capture pass, and ``.shape`` returns them as
    ``_SymDim``s that the replay re-resolves from the feed."""
    from .. import resolve_device

    dyn_axes = tuple(i for i, s in enumerate(shape)
                     if s is None or (isinstance(s, int) and s < 0))
    concrete = [1 if i in dyn_axes else int(s) for i, s in enumerate(shape)]
    with torch._C.DisableTorchFunction():
        ph = torch.zeros(concrete, dtype=dtype_mod.convert_dtype(dtype),
                         device=resolve_device(None)).as_subclass(Variable)
    ph._dyn_axes = dyn_axes
    ph.name = name
    default_main_program()._inputs[name] = ph
    return ph


def _as_feed(v, like):
    if not isinstance(v, torch.Tensor):
        v = torch.from_numpy(np.array(v, copy=True))
    return v.to(like.device)


def _to_numpy(t):
    t = t.detach()
    if t.dtype in (torch.bfloat16, torch.float16):
        t = t.float()
    return t.cpu().numpy()


class Executor:
    """paddle's static ``Executor``: ``run(program, feed, fetch_list)``.
    ``fetch_list`` entries are captured tensors, names (a tensor's ``.name``
    or a ``static.data`` input's) or legacy callables over the feed."""

    def __init__(self, place=None):
        self.place = place

    def _resolve(self, program, env, fetch):
        if isinstance(fetch, torch.Tensor):
            return env.get(id(fetch), fetch)
        if isinstance(fetch, str):
            for t in program.list_vars():
                if getattr(t, "name", None) == fetch:
                    return env.get(id(t), t)
            raise KeyError(
                f"fetch {fetch!r}: no captured tensor or input carries that name "
                "(assign `t.name = ...` inside the program_guard)")
        raise TypeError(f"unsupported fetch_list entry {fetch!r}")

    def run(self, program=None, feed=None, fetch_list=None, return_numpy=True):
        if isinstance(program, CompiledProgram):
            program = program.program
        program = program or default_main_program()
        feed = feed or {}
        missing = [n for n in program._inputs if n not in feed]
        if missing:
            raise RuntimeError(f"feed is missing input(s) {missing}; static.data inputs "
                               "must all be fed (reference executor.py feed check)")
        env = {id(ph): _as_feed(feed[name], ph) for name, ph in program._inputs.items()}

        def sub(leaf):
            if isinstance(leaf, torch.Tensor):
                return env.get(id(leaf), leaf)
            if isinstance(leaf, _SymDim):
                return leaf.resolve(env)
            return leaf

        ops_snapshot = list(program._ops)
        token = capture.swap(None)   # the replay records nothing
        amp_stack = contextlib.ExitStack()
        amp_ctx = getattr(program, "_amp_ctx", None)
        if amp_ctx is not None:
            from ..amp.auto_cast import auto_cast

            lists = amp_ctx.get("lists")
            amp_stack.enter_context(auto_cast(
                enable=True, level=amp_ctx["level"], dtype=amp_ctx["dtype"],
                custom_white_list=sorted(lists.white_list) or None,
                custom_black_list=sorted(lists.black_list) or None))
            if amp_ctx.get("master_grad"):
                from ..autograd.master_grad import master_grad

                amp_stack.enter_context(master_grad())
        try:
            for kind, payload, leaves, outputs in ops_snapshot:
                if kind == "call":
                    fn, spec, grad = payload
                    a, k = tree_unflatten([sub(l) for l in leaves], spec)
                    with torch.set_grad_enabled(grad):
                        new = fn(*a, **k)
                    new_flat, _ = tree_flatten(new)
                    for i, orig in outputs:
                        env[id(orig)] = new_flat[i]
                    continue
                if kind == "cond":
                    # static.nn.cond: both branches were captured; re-decide
                    n = payload
                    pred = sub(leaves[0])
                    chosen = leaves[1:1 + n] if bool(pred.reshape(())) else leaves[1 + n:]
                    new = tuple(sub(t) for t in chosen)
                else:  # "pyctrl": static.nn while_loop / static_pylayer
                    new = payload([sub(t) for t in leaves])
                for orig, repl in zip(outputs, new):
                    env[id(orig)] = repl
            # the AMP replay covers the recorded forward only: GradScaler's
            # scale must not run under O2's casts
            amp_stack.close()
            for loss_t, opt in program._train_hooks:
                live = env.get(id(loss_t), loss_t)
                if hasattr(opt, "_amp_train_step"):
                    opt._amp_train_step(live)
                    continue
                live.backward()
                opt.step()
                opt.clear_grad()
            outs = []
            for fetch in fetch_list or []:
                if callable(fetch) and not isinstance(fetch, torch.Tensor):
                    out = fetch({k: _as_feed(v, torch.empty(0)) for k, v in feed.items()})
                else:
                    out = self._resolve(program, env, fetch)
                outs.append(_to_numpy(out) if return_numpy and isinstance(out, torch.Tensor)
                            else out)
        finally:
            amp_stack.close()
            capture.restore(token)
        return outs


class CompiledProgram:
    def __init__(self, program, build_strategy=None):
        self.program = program


def save_inference_model(path_prefix, feed_vars, fetch_vars, executor=None, program=None,
                         **kwargs):
    """Export a Layer for inference through ``jit.save``: pass ``layer=`` (or
    the Layer as ``fetch_vars``) and the inputs as InputSpecs (or
    placeholders)."""
    from .. import jit

    target = kwargs.pop("layer", None)
    if target is None and isinstance(fetch_vars, torch.nn.Module):
        target = fetch_vars
    if target is None:
        raise ValueError("the capture-based save_inference_model exports a Layer: pass "
                         "layer=<Layer> (or fetch_vars=<Layer>) plus feed_vars as InputSpecs")
    spec = feed_vars if isinstance(feed_vars, (list, tuple)) else [feed_vars]
    spec = [s if isinstance(s, InputSpec)
            else InputSpec(list(torch.Tensor.shape.__get__(s)), str(s.dtype).split(".")[-1],
                           getattr(s, "name", None))
            for s in spec]
    jit.save(target, path_prefix, input_spec=spec)
    return path_prefix


def load_inference_model(path_prefix, executor=None, **kwargs):
    """(program, feed_names, fetch_fn): ``fetch_fn`` (a ``TranslatedLayer``)
    runs on tensors."""
    from .. import jit

    translated = jit.load(path_prefix, device=kwargs.get("device"))
    return Program(), [], translated


def name_scope(prefix=None):
    return contextlib.nullcontext()


@contextlib.contextmanager
def scope_guard(scope):
    yield


def global_scope():
    return {}


def cpu_places(device_count=None):
    return ["cpu"] * (device_count or 1)


def device_guard(device=None):
    return contextlib.nullcontext()


def gradients(targets, inputs, target_gradients=None, no_grad_set=None):
    """d targets / d inputs (paddle.grad)."""
    from ..autograd import grad as _grad

    outs = targets if isinstance(targets, (list, tuple)) else [targets]
    ins = inputs if isinstance(inputs, (list, tuple)) else [inputs]
    return list(_grad(outs, ins, grad_outputs=target_gradients, allow_unused=True))


class _NoOptimizer:
    """append_backward without an optimizer: backward only per run()."""

    def __init__(self, params):
        self._params = params

    def step(self):
        pass

    def clear_grad(self):
        pass


def append_backward(loss, parameter_list=None, no_grad_set=None, callbacks=None,
                    checkpoints=None):
    """Under capture, every ``Executor.run`` runs the backward of ``loss``;
    outside it, the backward runs now and (param, grad) pairs come back."""
    prog = capture.active()
    params = parameter_list or []
    if prog is None:
        loss.backward()
        return [(p, p.grad) for p in params]
    prog._train_hooks.append((loss, _NoOptimizer(params)))
    return [(p, None) for p in params]


class BuildStrategy:
    """compiler.BuildStrategy: accepted for parity (no pass to toggle)."""

    class ReduceStrategy:
        AllReduce = 0
        Reduce = 1

    def __init__(self):
        self.memory_optimize = None
        self.enable_inplace = None
        self.fuse_all_optimizer_ops = None
        self.fuse_elewise_add_act_ops = None
        self.reduce_strategy = BuildStrategy.ReduceStrategy.AllReduce
        self.build_cinn_pass = False


def Print(input, first_n=-1, message=None, summarize=20,  # noqa: A002,N802
          print_tensor_name=True, print_tensor_type=True, print_tensor_shape=True,
          print_tensor_layout=True, print_tensor_lod=True, print_phase="both"):
    """static.Print: a host print and a passthrough, recorded, so it prints
    at every replay too."""
    from ..ops._apply import apply_raw

    def fn(x):
        head = f"{message or ''} shape={tuple(x.shape)} dtype={x.dtype}"
        print(f"[static.Print] {head}\n{_to_numpy(x).ravel()[:int(summarize)]}")
        return x

    return apply_raw("static_print", fn, [input])[0]


def py_func(func, x, out=None, backward_func=None, skip_vars_in_backward_input=None):
    """static.py_func: call a host Python function on tensors."""
    xs = x if isinstance(x, (list, tuple)) else [x]
    return func(*xs)


class WeightNormParamAttr:
    """static WeightNormParamAttr: accepted for parity (weight norm itself
    is nn.utils.weight_norm)."""

    def __init__(self, dim=None, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, do_model_average=False, need_clip=True):
        self.dim = dim
        self.name = name
        self.initializer = initializer
        self.trainable = trainable


class ExponentialMovingAverage:
    """Shadow parameters ema = decay * ema + (1 - decay) * param (float32);
    ``apply()``/``restore()`` swap them in and out."""

    def __init__(self, decay=0.999, thres_steps=None, name=None):
        self._decay = decay
        self._shadow = {}
        self._backup = {}
        self._params = []

    @torch.no_grad()
    def update(self, parameters=None):
        if parameters is not None:
            self._params = list(parameters)
        for p in self._params:
            prev = self._shadow.get(id(p))
            v = p.detach().float()
            self._shadow[id(p)] = (v.clone() if prev is None
                                   else self._decay * prev + (1.0 - self._decay) * v)

    @torch.no_grad()
    def apply(self, executor=None, need_restore=True):
        for p in self._params:
            self._backup[id(p)] = p.detach().clone()
            p.copy_(self._shadow[id(p)].to(p.dtype))

    @torch.no_grad()
    def restore(self, executor=None):
        for p in self._params:
            if id(p) in self._backup:
                p.copy_(self._backup.pop(id(p)))


def save(program, model_path, protocol=4, **configs):
    """static.save: persist a Layer-backed program's parameters."""
    from ..framework_io import save as _save

    if not hasattr(program, "state_dict"):
        raise TypeError("static.save expects a Layer-like object here")
    _save(program.state_dict(), model_path + ".pdparams")


def load(program, model_path, executor=None, var_list=None):
    """static.load: restore parameters saved by static.save."""
    from ..framework_io import load as _load

    state = _load(model_path + ".pdparams")
    program.set_state_dict(state)
    return state


def load_program_state(model_path, var_list=None):
    """static.load_program_state -> dict of numpy arrays."""
    from ..framework_io import load as _load

    state = _load(model_path + ".pdparams")
    return {k: _to_numpy(v) if isinstance(v, torch.Tensor) else np.asarray(v)
            for k, v in state.items()}


def set_program_state(program, state_dict):
    """static.set_program_state: push a numpy state dict into the Layer."""
    program.set_state_dict(state_dict)


def normalize_program(program, feed_vars, fetch_vars, **kwargs):
    """The capture-based program is already minimal: a test-mode clone."""
    return program.clone(for_test=True)


def serialize_program(feed_vars, fetch_vars, **kwargs):
    """The pickled IO description (the executable form is jit.save's)."""
    import pickle

    feeds = feed_vars if isinstance(feed_vars, (list, tuple)) else [feed_vars]
    fetches = fetch_vars if isinstance(fetch_vars, (list, tuple)) else [fetch_vars]
    return pickle.dumps({"feed": [getattr(v, "name", None) for v in feeds],
                         "fetch": [getattr(v, "name", None) for v in fetches]})


def serialize_persistables(feed_vars, fetch_vars, executor=None, **kwargs):
    """The Layer's state as pickled numpy arrays."""
    import pickle

    target = kwargs.get("layer")
    if target is None:
        raise ValueError("pass layer=<Layer> (capture-based persistables)")
    return pickle.dumps({k: _to_numpy(v) for k, v in target.state_dict().items()})


def save_to_file(path, content):
    with open(path, "wb") as f:
        f.write(content)


def load_from_file(path):
    with open(path, "rb") as f:
        return f.read()


def deserialize_program(data):
    import pickle

    return pickle.loads(data)


def deserialize_persistables(program, data, executor=None):
    import pickle

    return pickle.loads(data)


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    """A trainable Parameter outside any Layer (XavierUniform, or zeros for
    a bias), on the default device."""
    from .. import resolve_device
    from ..framework import Parameter
    from ..nn.initializer import Constant, XavierUniform

    init = default_initializer or (Constant(0.0) if is_bias else XavierUniform())
    with torch.no_grad():
        val = init([int(s) for s in shape], dtype, device=resolve_device(None))
    return Parameter(val, name=name)


def create_global_var(shape, value, dtype, persistable=False, force_cpu=False, name=None):
    """A filled non-trainable tensor."""
    from .. import resolve_device

    with torch._C.DisableTorchFunction():
        t = torch.full([int(s) for s in shape], value, dtype=dtype_mod.convert_dtype(dtype),
                       device=resolve_device(None)).as_subclass(Variable)
    t.name = name
    t.persistable = persistable
    return t


def accuracy(input, label, k=1, correct=None, total=None):  # noqa: A002
    """Top-k accuracy (paddle.metric.accuracy)."""
    lv = label.reshape(label.shape[0], -1)[:, 0]
    topk = torch.argsort(-input, dim=-1, stable=True)[:, :k]
    return (topk == lv[:, None]).any(-1).float().mean()


def auc(input, label, curve="ROC", num_thresholds=4095, topk=1,  # noqa: A002
        slide_steps=1, ins_tag_weight=None):
    """Batch ROC AUC over ``num_thresholds`` buckets (paddle.metric.Auc's
    trapezoid), returned as (auc, batch_auc, [])."""
    p = _to_numpy(input)
    if p.ndim == 2 and p.shape[1] == 2:
        p = p[:, 1]
    p = p.reshape(-1)
    lab = _to_numpy(label).astype(int).reshape(-1)
    idx = np.clip((p * num_thresholds).astype(int), 0, num_thresholds)
    pos = np.zeros(num_thresholds + 1)
    neg = np.zeros(num_thresholds + 1)
    np.add.at(pos, idx, lab == 1)
    np.add.at(neg, idx, lab == 0)
    value = 0.0
    if pos.sum() and neg.sum():
        tpr = np.concatenate([[0.0], pos[::-1].cumsum() / pos.sum()])
        fpr = np.concatenate([[0.0], neg[::-1].cumsum() / neg.sum()])
        value = float(np.trapezoid(tpr, fpr))
    val = torch.tensor(value, dtype=torch.float32)
    return val, val, []


def ctr_metric_bundle(input, label, ins_tag_weight=None):  # noqa: A002
    """(abserr, sqrerr, prob, q, pos, total) sums of a CTR job."""
    lab = label.to(input.dtype)
    return ((input - lab).abs().sum(), ((input - lab) ** 2).sum(), input.sum(),
            (input * input).sum(), lab.sum(), torch.tensor(float(input.numel())))


def cuda_places(device_ids=None):
    """The card places (``"gpu:N"``)."""
    ids = device_ids if device_ids else [0]
    return [f"gpu:{i}" for i in ids]


def xpu_places(device_ids=None):
    return []


def set_ipu_shard(call_func, index=-1, stage=-1):
    """No-IPU build: identity decorator."""
    return call_func


def ipu_shard_guard(index=-1, stage=-1):
    """No-IPU build: accepted no-op guard."""
    return contextlib.nullcontext()


class IpuStrategy:
    def __init__(self):
        self._opts = {}

    def set_graph_config(self, **kwargs):
        self._opts.update(kwargs)


class IpuCompiledProgram:
    def __init__(self, program=None, scope=None, ipu_strategy=None):
        self.program = program

    def compile(self, feed_list, fetch_list):
        return self.program


from . import nn  # noqa: E402  (static.nn: control flow + builders)
from . import amp  # noqa: E402  (static.amp: mixed precision for capture-replay)

__all__ += [
    "nn",
    "append_backward", "gradients", "BuildStrategy", "Print", "py_func",
    "WeightNormParamAttr", "ExponentialMovingAverage", "save", "load",
    "load_program_state", "set_program_state", "normalize_program",
    "serialize_program", "serialize_persistables", "save_to_file",
    "deserialize_program", "deserialize_persistables", "load_from_file",
    "Variable", "create_parameter", "create_global_var", "accuracy", "auc",
    "ctr_metric_bundle", "cuda_places", "xpu_places", "set_ipu_shard",
    "ipu_shard_guard", "IpuCompiledProgram", "IpuStrategy",
]
