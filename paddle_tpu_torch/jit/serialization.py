"""jit.save / jit.load: a layer's eval forward saved as a program that runs
without the Python model code.

Counterpart of ``paddle_tpu/jit/serialization.py``. There the forward is
traced as a pure function of (state, inputs) and serialized as StableHLO with
``jax.export``; here the same pure function is traced by ``torch.export``
(non-strict), and ``<path>.pdmodel`` is ``torch.export.save``'s archive of
it. The parameters and buffers are inputs of the program, so the archive
holds no weights: ``<path>.pdiparams`` holds them once, as numpy arrays
named ``"P:" + name`` and ``"B:" + name`` (bfloat16 as uint16 bits, the
``paddle.save`` format), beside the JAX package's keys (``state_names``,
``input_names``, ``format_version``, ``op_registry_hash``, ``producer``) and
``platform``, the device type the program was exported for.

The contract, as in the JAX package:

* ``save`` takes ``input_spec`` (``InputSpec``s, example tensors or arrays),
  or the spec a ``to_static``'d forward was given; without either it raises
  ``ValueError``. A dim of ``None`` or below 0 is dynamic (a
  ``torch.export.Dim``, traced with an example of 2): where the trace would
  fix it, ``save`` raises rather than write a program that runs one shape.
* ``load`` refuses a ``format_version`` newer than ``FORMAT_VERSION`` and
  accepts 0 (no version fields). ``op_registry_hash`` is provenance only.
* ``TranslatedLayer`` runs the program: one tensor out, or a tuple when the
  program has several outputs.

What the port adds. The attention path is chosen while the forward is traced
(``_use_kernel``: a CUDA query of 128 rows or more takes the kernel op), so a
program exported on the card calls ``paddle_tpu_torch::flash_attention_fwd``
and one exported on the CPU holds the plain math: a program runs only on the
device type it was exported for, and ``load`` for another raises. ``load``
imports the port's kernel ops before it reads the program, and names any op
of the program that no loaded module defines (a ``paddle_tpu_torch_ext::``
op of a ``cpp_extension`` that is not loaded yet). An artifact of the JAX
package (producer ``"paddle_tpu"``) holds StableHLO, which this package
cannot run: ``load`` refuses it.
"""
from __future__ import annotations

import hashlib
import importlib
import io
import os
import pickle
import re
import zipfile

import numpy as np
import torch
from torch.utils import _pytree as pytree

from .. import resolve_device
from ..framework_io import _BF16_TAG, tensor_from_payload, tensor_payload
from ..ops._builtin_names import BUILTIN_OP_NAMES
from .api import InputSpec, StaticFunction

# Artifact format version, the JAX package's: bump only on layout changes of
# the .pdiparams dict or of the .pdmodel/.pdiparams pairing. The .pdmodel
# payload is torch.export's archive, which torch versions itself. Loaders
# accept every version <= FORMAT_VERSION (0: no version fields) and refuse a
# newer one; tests/fixtures/torch_jit_save_v1/ pins that v1 artifacts load.
FORMAT_VERSION = 1
PRODUCER = "paddle_tpu_torch"

#: the modules whose torch.library ops a saved program may call
_OP_MODULES = ("paddle_tpu_torch.ops.cuda.flash_attention", "paddle_tpu_torch.ops.cuda.axpy")
_OP_NAME = re.compile(rb"torch\.ops\.(paddle_tpu_torch\w*)\.(\w+)")


def _op_registry_hash():
    """The JAX package's hash of its built-in op names (sha256 of the sorted
    names, comma-joined; 16 hex characters). Provenance, not enforced on
    load."""
    names = sorted(BUILTIN_OP_NAMES)
    return hashlib.sha256(",".join(names).encode()).hexdigest()[:16]


def _gather_state(layer):
    """(names, tensors) of the parameters and buffers, named as the JAX
    package names them (``paddle_tpu/jit/api.py`` ``_gather_state``)."""
    if layer is None:
        return [], []
    names, tensors = [], []
    for n, p in layer.named_parameters():
        names.append("P:" + n)
        tensors.append(p)
    for n, b in layer.named_buffers():
        if b is not None:
            names.append("B:" + n)
            tensors.append(b)
    return names, tensors


class _Pure(torch.nn.Module):
    """``(state list, *inputs) -> tuple of output tensors``: the forward with
    the layer's parameters and buffers swapped for the ``state`` arguments.
    The layer is held in a tuple, not as a submodule, so the exported
    program lifts none of its weights."""

    def __init__(self, layer, fwd, keys):
        super().__init__()
        self._held = (layer, fwd, keys)

    def forward(self, state, *inputs):
        layer, fwd, keys = self._held
        if layer is None:
            out = fwd(*inputs)
        else:
            with torch.nn.utils.stateless._reparametrize_module(
                    layer, dict(zip(keys, state))):
                out = fwd(*inputs)
        return tuple(pytree.tree_leaves(out))


def _trace_target(obj):
    """(layer or None, forward function) of a Module, a ``to_static``
    function or a plain function."""
    if isinstance(obj, torch.nn.Module):
        fwd = obj._orig_forward if hasattr(obj, "_orig_forward") else obj.forward
        if isinstance(fwd, StaticFunction):
            fwd = fwd._function
        return obj, fwd
    if isinstance(obj, StaticFunction):
        return obj._layer, obj._function
    if callable(obj):
        return None, obj
    raise TypeError(f"jit.save takes a Module or a function, got {type(obj).__name__}")


def _torch_dtype(d):
    if isinstance(d, torch.dtype):
        return d
    if isinstance(d, str) and isinstance(getattr(torch, d, None), torch.dtype):
        return getattr(torch, d)
    return torch.from_numpy(np.zeros(0, np.dtype(d))).dtype


def _examples(input_spec, device):
    """Example inputs on ``device`` and their dynamic dims (an example of 2
    for each dynamic dim: torch.export fixes dims traced at 0 or 1)."""
    examples, dynamic = [], []
    n_dyn = 0
    for s in input_spec:
        dims = {}
        if isinstance(s, InputSpec):
            shape = []
            for j, d in enumerate(s.shape):
                if d is None or int(d) < 0:
                    n_dyn += 1
                    dims[j] = torch.export.Dim(f"dyn{n_dyn}")
                    shape.append(2)
                else:
                    shape.append(int(d))
            x = torch.zeros(shape, dtype=_torch_dtype(s.dtype), device=device)
        elif isinstance(s, torch.Tensor):
            x = torch.zeros(s.shape, dtype=s.dtype, device=device)
        else:
            arr = np.asarray(s)
            x = torch.zeros(arr.shape, dtype=_torch_dtype(arr.dtype), device=device)
        examples.append(x)
        dynamic.append(dims or None)
    return examples, dynamic, n_dyn


def save(layer, path, input_spec=None, **config):
    """Export ``layer``'s eval forward to ``<path>.pdmodel`` and its state to
    ``<path>.pdiparams`` (module docstring). The program runs on the device
    type of the layer's state (``config["device"]``, else the card, for a
    function without state)."""
    if input_spec is None:
        sf = getattr(layer, "forward", layer)
        if isinstance(sf, StaticFunction):
            input_spec = sf._input_spec
    if input_spec is None:
        raise ValueError("jit.save requires input_spec (list of InputSpec or example "
                         "Tensors) to fix the exported signature")
    target, fwd = _trace_target(layer)
    names, tensors = _gather_state(target)
    device = tensors[0].device if tensors else resolve_device(config.get("device"))
    examples, dynamic, n_dyn = _examples(input_spec, device)
    state = [t.detach() for t in tensors]
    keys = [n[2:] for n in names]
    was_training = target.training if target is not None else False
    if target is not None:
        target.eval()
    try:
        with torch.no_grad():
            program = torch.export.export(
                _Pure(target, fwd, keys), (state, *examples),
                dynamic_shapes=([None] * len(state), tuple(dynamic)) if n_dyn else None,
                strict=False)
    finally:
        if was_training:
            target.train()
    program.example_inputs = None   # the archive would hold the weights again
    # drop what nothing reads, such as the dtype arithmetic the trace records
    # (aten.promote_types returns no tensor, and Dynamo cannot compile it)
    program.graph_module.graph.eliminate_dead_code()
    program.graph_module.recompile()
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    # through a buffer: torch.export wants a file named *.pt2, or a buffer
    buf = io.BytesIO()
    torch.export.save(program, buf)
    with open(path + ".pdmodel", "wb") as f:
        f.write(buf.getvalue())
    stored = {}
    for n, t in zip(names, tensors):
        data, dtype = tensor_payload(t)
        stored[n] = data if dtype != _BF16_TAG else {"data": data, "dtype": dtype}
    input_names = [getattr(s, "name", None) or f"input_{i}"
                   for i, s in enumerate(input_spec)]
    with open(path + ".pdiparams", "wb") as f:
        pickle.dump({"state_names": names, "state": stored,
                     "input_names": input_names,
                     "format_version": FORMAT_VERSION,
                     "op_registry_hash": _op_registry_hash(),
                     "producer": PRODUCER,
                     "platform": device.type,
                     "torch_version": torch.__version__}, f, protocol=4)


def _input(x, device):
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.asarray(x, order="C"))
    return x.to(device)


class TranslatedLayer(torch.nn.Module):
    """A loaded program callable like the layer it was saved from (paddle's
    ``jit.load`` result). The state tensors live on ``device``; inputs may be
    tensors or arrays and are moved there."""

    def __init__(self, program, state_vals, input_names=None, device=None):
        super().__init__()
        self._program = program
        # in a list: the program's module is no submodule (it has no
        # train/eval of its own)
        self._run = [program.module()]
        self._state_vals = list(state_vals)
        self._input_names = list(input_names or [])  # paddle.inference handles
        self._device = torch.device(device) if device is not None else (
            self._state_vals[0].device if self._state_vals else torch.device("cpu"))

    def forward(self, *inputs):
        with torch.no_grad():
            outs = self._run[0](self._state_vals, *(_input(x, self._device) for x in inputs))
        return outs[0] if len(outs) == 1 else tuple(outs)


def _missing_ops(pdmodel):
    """``ns::name`` of each op of the port's namespaces that the program calls
    and no loaded module defines."""
    with zipfile.ZipFile(pdmodel) as z:
        found = set()
        for name in z.namelist():
            if name.endswith(".json") and "/models/" in name:
                found.update(_OP_NAME.findall(z.read(name)))
    return sorted(f"{ns.decode()}::{op.decode()}" for ns, op in found
                  if not hasattr(getattr(torch.ops, ns.decode()), op.decode()))


def _program_platform(program):
    """The device type of the program's inputs, for artifacts without
    ``platform``."""
    for node in program.graph.nodes:
        val = node.meta.get("val")
        if node.op == "placeholder" and isinstance(val, torch.Tensor):
            return val.device.type
    return None


def load(path, device=None, **config):
    """The program ``save`` wrote at ``path``, as a ``TranslatedLayer`` on
    ``device`` (the card unless ``"cpu"``), which must be of the type the
    program was exported for."""
    with open(path + ".pdiparams", "rb") as f:
        meta = pickle.load(f)
    ver = int(meta.get("format_version", 0))  # 0 = pre-versioning artifact
    if ver > FORMAT_VERSION:
        raise RuntimeError(
            f"jit.load: artifact {path!r} has format version {ver}, newer "
            f"than this build's {FORMAT_VERSION} (producer "
            f"{meta.get('producer', 'unknown')!r}, op registry "
            f"{meta.get('op_registry_hash', '?')}) — load it with the "
            "build that produced it, or re-export")
    dev = resolve_device(device)
    pdmodel = path + ".pdmodel"
    if meta.get("producer") == "paddle_tpu" or not zipfile.is_zipfile(pdmodel):
        raise RuntimeError(
            f"jit.load: artifact {path!r} was written by producer "
            f"{meta.get('producer', 'unknown')!r}: its .pdmodel is not a torch.export "
            "archive (the JAX package writes StableHLO, which this package cannot run "
            "without jax); re-export the model with paddle_tpu_torch.jit.save")
    for mod in _OP_MODULES:
        importlib.import_module(mod)
    missing = _missing_ops(pdmodel)
    if missing:
        raise RuntimeError(
            f"jit.load: the program {pdmodel!r} calls {', '.join(missing)}, which no "
            "loaded module defines: load the extension that registers it (for a "
            "cpp_extension op, cpp_extension.load(...).def_op(...)) before jit.load")
    try:
        with open(pdmodel, "rb") as f:
            program = torch.export.load(io.BytesIO(f.read()))
    except Exception as e:
        raise RuntimeError(
            f"jit.load: could not deserialize {pdmodel!r} with torch {torch.__version__} "
            f"(written by torch {meta.get('torch_version', '?')}): {e}") from e
    platform = meta.get("platform") or _program_platform(program)
    if platform is not None and platform != dev.type:
        raise RuntimeError(
            f"jit.load: {path!r} was exported for {platform} and cannot run on {dev}: "
            "the attention path (kernel op or plain math) was fixed when it was traced; "
            f"load it with device={platform!r}, or save the model again on {dev.type}")
    state = meta["state"]
    vals = []
    for n in meta["state_names"]:
        v = state[n]
        vals.append(tensor_from_payload(v["data"], v["dtype"], dev) if isinstance(v, dict)
                    else tensor_from_payload(v, str(np.asarray(v).dtype), dev))
    return TranslatedLayer(program, vals, input_names=meta.get("input_names"), device=dev)
