"""paddle.static.nn: control flow and the declarative layer builders (the
port of paddle_tpu/static/nn.py).

Control flow runs in two modes here:

* eager: the predicate is read and one branch runs on the autograd tape,
  as the reference's dygraph branches do.
* under ``jit.to_static`` (Dynamo) on a tensor predicate: ``torch.cond`` and
  torch's ``while_loop``, Dynamo's own control-flow operators, where the JAX
  package stages ``lax.cond`` and ``lax.while_loop`` (both branches traced;
  the loop forward-only, as XLA's).
* static capture (``program_guard``): ``cond`` builds both branches into the
  Program and records a select entry re-decided against the feed at every
  ``Executor.run``; ``while_loop`` and ``static_pylayer`` record one entry
  re-executed per run (loop state must flow through ``loop_vars``).

The builders (fc, embedding, conv and norm layers, ...) build the port's
layers once per call site and register their parameters on the active
Program, so ``optimizer.minimize(loss)`` with no parameter list trains them.
Sequence ops work on dense padded ``[batch, time, ...]`` tensors, masked by
an optional ``seq_lens``.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from .. import ops
from ..framework import Parameter
from ..framework import capture as _capture
from ..framework.capture import Variable
from ..nn import functional as F
from ..ops._apply import apply_raw, defop

__all__ = [
    "fc", "batch_norm", "bilinear_tensor_product", "embedding", "case",
    "cond", "static_pylayer", "conv2d", "conv2d_transpose", "conv3d",
    "conv3d_transpose", "data_norm", "deform_conv2d", "group_norm",
    "instance_norm", "layer_norm", "nce", "prelu", "py_func", "row_conv",
    "spectral_norm", "switch_case", "while_loop", "sparse_embedding",
    "sequence_conv", "sequence_softmax", "sequence_pool",
    "sequence_first_step", "sequence_last_step", "sequence_expand",
]


def _is_tensor(x):
    return isinstance(x, torch.Tensor)


def _concrete_bool(pred):
    t = torch.as_tensor(pred)
    if t.numel() != 1:
        raise ValueError(f"condition input's numel should be 1, got shape {tuple(t.shape)}")
    return bool(t.reshape(()))


def _as_var(t):
    with torch._C.DisableTorchFunction():
        return t.as_subclass(Variable)


# -- control flow -------------------------------------------------------------
def cond(pred, true_fn=None, false_fn=None, name=None, return_names=None):
    """``true_fn()`` if ``pred`` else ``false_fn()``; under program capture
    both branches are built and a select entry re-decides per run."""
    if true_fn is None and false_fn is None:
        return None
    for fn, nm in ((true_fn, "true_fn"), (false_fn, "false_fn")):
        if fn is not None and not callable(fn):
            raise TypeError(f"The {nm} in cond must be callable")
    tfn = true_fn if true_fn is not None else (lambda: None)
    ffn = false_fn if false_fn is not None else (lambda: None)
    if torch.compiler.is_compiling() and _is_tensor(pred):
        if pred.numel() != 1:
            raise ValueError(f"condition input's numel should be 1, got shape "
                             f"{tuple(pred.shape)}")
        return torch.cond(pred.reshape(()), tfn, ffn, ())
    prog = _capture.active()
    if prog is not None and isinstance(pred, Variable) and not _capture._busy():
        return _captured_cond(prog, pred, tfn, ffn)
    return tfn() if _concrete_bool(pred) else ffn()


def _captured_cond(prog, pred, true_fn, false_fn):
    # both branches run (and record) during capture: the reference's
    # net-building semantics for static cond
    t_flat, t_tree = tree_flatten(true_fn())
    f_flat, f_tree = tree_flatten(false_fn())
    if t_tree != f_tree:
        raise TypeError("true_fn and false_fn must return the same nest structure "
                        f"(got {t_tree} vs {f_tree})")
    if not t_flat:
        return tree_unflatten(t_flat, t_tree)
    if not all(_is_tensor(x) for x in t_flat + f_flat):
        raise TypeError("cond branches must return tensors under capture")
    outs = [_as_var(t) for t in t_flat]
    prog._record_op("cond", len(t_flat), [pred] + t_flat + f_flat, outs)
    return tree_unflatten(outs, t_tree)


def while_loop(cond, body, loop_vars, is_test=False, name=None):  # noqa: A002
    """``while cond(*vars): vars = body(*vars)``; under capture one entry
    re-executed per run (vars the loop changes must be loop vars)."""
    if not callable(cond) or not callable(body):
        raise TypeError("cond and body in while_loop must be callable")
    if not isinstance(loop_vars, (list, tuple)) or not loop_vars:
        raise ValueError("loop_vars must be a non-empty list/tuple")
    loop_vars = list(loop_vars)
    flat, tree = tree_flatten(loop_vars)
    t_idx = [i for i, x in enumerate(flat) if _is_tensor(x)]
    if torch.compiler.is_compiling() and t_idx:
        return _traced_while(cond, body, flat, tree, t_idx)
    prog = _capture.active()
    if prog is not None and not _capture._busy():
        return _captured_while(prog, cond, body, flat, tree, t_idx)
    return _eager_while(cond, body, loop_vars)


def _eager_while(cond, body, loop_vars):  # noqa: A002
    args = list(loop_vars)
    n = len(args)
    while _concrete_bool(cond(*args)):
        out = body(*args)
        args = list(out) if isinstance(out, (list, tuple)) else [out]
        if len(args) != n:
            raise ValueError(f"body must return the same arity as loop_vars ({n}), "
                             f"got {len(args)}")
    return args


def _traced_while(cond, body, flat, tree, t_idx):  # noqa: A002
    from torch._higher_order_ops.while_loop import while_loop as _while_op

    def rebuild(vals):
        buf = list(flat)
        for i, v in zip(t_idx, vals):
            buf[i] = v
        return tree_unflatten(buf, tree)

    def c(*vals):
        r = cond(*rebuild(vals))
        return torch.as_tensor(r).reshape(()).to(torch.bool)

    def b(*vals):
        out = body(*rebuild(vals))
        oflat, _ = tree_flatten(list(out) if isinstance(out, (list, tuple)) else [out])
        return tuple(oflat[i] if _is_tensor(oflat[i]) else torch.as_tensor(oflat[i])
                     for i in t_idx)

    res = _while_op(c, b, tuple(flat[i] for i in t_idx))
    return rebuild(res)


def _captured_while(prog, cond, body, flat, tree, t_idx):  # noqa: A002
    def runner(live):
        buf = list(flat)
        for i, t in zip(t_idx, live):
            buf[i] = t
        result = _eager_while(cond, body, tree_unflatten(buf, tree))
        rflat, _ = tree_flatten(result)
        return tuple(rflat[i] if _is_tensor(rflat[i]) else torch.as_tensor(rflat[i])
                     for i in t_idx)

    # nothing runs now (the placeholders hold no data yet): the outputs are
    # the loop vars' capture-time values, as the JAX package's
    outs = [_as_var(flat[i]) for i in t_idx]
    prog._record_op("pyctrl", runner, [flat[i] for i in t_idx], outs)
    buf = list(flat)
    for i, o in zip(t_idx, outs):
        buf[i] = o
    return tree_unflatten(buf, tree)


def case(pred_fn_pairs, default=None, name=None):
    """The fn of the first true pred, else ``default`` (or the last pair's
    fn); composed from ``cond``."""
    if not isinstance(pred_fn_pairs, (list, tuple)) or not pred_fn_pairs:
        raise TypeError("pred_fn_pairs must be a non-empty list/tuple")
    pairs = []
    for item in pred_fn_pairs:
        if not isinstance(item, (list, tuple)) or len(item) != 2:
            raise TypeError("each pred_fn_pair must be a (pred, fn) 2-tuple")
        pred, fn = item
        if not callable(fn):
            raise TypeError("fn in pred_fn_pairs must be callable")
        pairs.append((pred, fn))
    if default is None:
        pairs, (_, default) = pairs[:-1], pairs[-1]
        if not pairs:
            return default()

    def chain(i):
        if i == len(pairs):
            return default
        pred, fn = pairs[i]
        return lambda: cond(pred, fn, chain(i + 1))

    return chain(0)()


def switch_case(branch_index, branch_fns, default=None, name=None):
    """Dispatch on an int scalar: ``branch_fns`` a dict {int: fn}, a list of
    (int, fn) or a list of fns (keys 0..n-1); a miss takes ``default`` (or
    the last fn)."""
    if isinstance(branch_fns, dict):
        items = sorted(branch_fns.items(), key=lambda kv: kv[0])
    else:
        branch_fns = list(branch_fns)
        if branch_fns and callable(branch_fns[0]):
            items = list(enumerate(branch_fns))
        else:
            items = sorted(((int(k), f) for k, f in branch_fns), key=lambda kv: kv[0])
    for k, f in items:
        if not isinstance(k, (int, np.integer)):
            raise TypeError(f"branch key must be int, got {type(k).__name__}")
        if not callable(f):
            raise TypeError("branch fns must be callable")
    keys = [int(k) for k, _ in items]
    if len(set(keys)) != len(keys):
        raise ValueError(f"duplicate branch keys {keys}")
    idx = torch.as_tensor(branch_index)
    pairs = [(ops.equal(idx, torch.tensor(k, dtype=idx.dtype, device=idx.device)), f)
             for k, f in items]
    if default is None:
        default = items[-1][1]
    return case(pairs, default=default)


def static_pylayer(forward_fn, inputs, backward_fn=None, name=None):
    """A forward fn with a user-supplied backward (one autograd Function whose
    backward calls ``backward_fn``); under capture one re-executed entry, so
    the custom backward applies at replay too."""
    from ..autograd.py_layer import PyLayer

    inputs = list(inputs)

    class _StaticPyLayer(PyLayer):
        @staticmethod
        def forward(ctx, *args):
            return forward_fn(*args)

        @staticmethod
        def backward(ctx, *grads):
            return backward_fn(*grads)

    if backward_fn is None:
        with torch.no_grad():
            return forward_fn(*inputs)

    prog = _capture.active()
    if prog is None or _capture._busy():
        return _StaticPyLayer.apply(*inputs)
    token = _capture.swap(None)
    try:
        out = _StaticPyLayer.apply(*inputs)
    finally:
        _capture.restore(token)
    flat, tree = tree_flatten(out)
    t_pos = [i for i, o in enumerate(flat) if _is_tensor(o)]
    outs = [_as_var(o) if _is_tensor(o) else o for o in flat]

    def runner(live):
        rflat, _ = tree_flatten(_StaticPyLayer.apply(*live))
        return tuple(rflat[i] for i in t_pos)

    prog._record_op("pyctrl", runner, inputs, [outs[i] for i in t_pos])
    return tree_unflatten(outs, tree)


def py_func(func, x, out=None, backward_func=None, skip_vars_in_backward_input=None):
    """static.nn.py_func: the same host-call shim as static.py_func."""
    from . import py_func as _pf

    return _pf(func, x, out=out, backward_func=backward_func,
               skip_vars_in_backward_input=skip_vars_in_backward_input)


# -- declarative builders -----------------------------------------------------
_UNIQUE = [0]


def _uname(base):
    _UNIQUE[0] += 1
    return f"{base}_{_UNIQUE[0]}"


def _register(layer_or_params, base):
    """Register builder-created parameters on the active Program, so
    ``minimize`` with no parameter list finds them."""
    prog = _capture.active()
    params = (list(layer_or_params.parameters()) if hasattr(layer_or_params, "parameters")
              else list(layer_or_params))
    name = _uname(base)
    for i, p in enumerate(params):
        if not p.name:
            p.name = f"{name}.w_{i}"
        if prog is not None:
            prog._parameters.append(p)
    return params


def _act(activation, out):
    if activation is None:
        return out
    fn = getattr(F, activation, None)
    if fn is None:
        raise ValueError(f"unknown activation {activation!r}")
    return fn(out)


def _xavier(shape, x):
    from ..nn.initializer import XavierUniform

    with torch.no_grad():
        return XavierUniform()(list(shape), x.dtype, device=x.device)


def _dims(x):
    return torch.Tensor.shape.__get__(x) if isinstance(x, Variable) else x.shape


def fc(x, size, num_flatten_dims=1, weight_attr=None, bias_attr=None, activation=None,
       name=None):
    """Flatten the trailing dims, one weight per input (the inputs' products
    summed), a shared bias, an optional activation."""
    xs = x if isinstance(x, (list, tuple)) else [x]
    outs, params = [], []
    for xi in xs:
        shape = list(_dims(xi))
        nfd = num_flatten_dims if num_flatten_dims >= 0 else len(shape) + num_flatten_dims
        in_dim = int(np.prod(shape[nfd:]))
        w = Parameter(_xavier((in_dim, size), xi))
        params.append(w)
        # leading dims pass through; the first becomes -1, so the product is
        # batch-size polymorphic at replay
        lead = [int(s) for s in shape[:nfd]]
        if lead:
            lead[0] = -1
        outs.append(ops.matmul(ops.reshape(xi, lead + [in_dim]), w))
    out = outs[0]
    for o in outs[1:]:
        out = ops.add(out, o)
    if bias_attr is not False:
        b = Parameter(torch.zeros(size, dtype=out.dtype, device=out.device))
        out = ops.add(out, b)
        params.append(b)
    _register(params, name or "fc")
    return _act(activation, out)


def embedding(input, size, is_sparse=False, is_distributed=False,  # noqa: A002
              padding_idx=None, param_attr=None, dtype="float32", name=None):
    """A lookup table of ``size`` [rows, width]."""
    from ..framework import dtype as dtype_mod

    like = torch.empty(0, dtype=dtype_mod.convert_dtype(dtype), device=input.device)
    w = Parameter(_xavier([int(s) for s in size], like))
    _register([w], name or "embedding")
    return F.embedding(input, w, padding_idx=padding_idx)


def sparse_embedding(input, size, padding_idx=None, param_attr=None,  # noqa: A002
                     dtype="float32", **kwargs):
    """The parameter-server table as a dense device parameter: the same lookup."""
    return embedding(input, size, padding_idx=padding_idx, param_attr=param_attr,
                     dtype=dtype)


def batch_norm(input, act=None, is_test=False, momentum=0.9,  # noqa: A002
               epsilon=1e-5, param_attr=None, bias_attr=None, data_layout="NCHW",
               in_place=False, name=None, moving_mean_name=None,
               moving_variance_name=None, do_model_average_for_mean_and_var=True,
               use_global_stats=False):
    from .. import nn

    ch_axis = 1 if data_layout in ("NCHW", "NCDHW", "NCL") else -1
    layer = nn.BatchNorm(int(_dims(input)[ch_axis]), momentum=momentum,
                                 epsilon=epsilon, data_format=data_layout)
    if is_test or use_global_stats:
        layer.eval()
    _register(layer, name or "batch_norm")
    return _act(act, layer(input))


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,  # noqa: A002
               epsilon=1e-5, param_attr=None, bias_attr=None, act=None, name=None):
    from .. import nn

    normalized_shape = [int(s) for s in _dims(input)[begin_norm_axis:]]
    layer = nn.LayerNorm(normalized_shape, epsilon=epsilon,
                                 weight_attr=None if scale else False,
                                 bias_attr=None if shift else False)
    _register(layer, name or "layer_norm")
    return _act(act, layer(input))


def group_norm(input, groups, epsilon=1e-5, param_attr=None,  # noqa: A002
               bias_attr=None, act=None, data_layout="NCHW", name=None):
    from .. import nn

    ch_axis = 1 if data_layout == "NCHW" else -1
    layer = nn.GroupNorm(num_groups=groups, num_channels=int(_dims(input)[ch_axis]),
                                 epsilon=epsilon)
    _register(layer, name or "group_norm")
    return _act(act, layer(input))


def instance_norm(input, epsilon=1e-5, param_attr=None, bias_attr=None,  # noqa: A002
                  name=None):
    from .. import nn

    cls = {3: nn.InstanceNorm1D, 4: nn.InstanceNorm2D, 5: nn.InstanceNorm3D}[input.dim()]
    layer = cls(int(_dims(input)[1]), epsilon=epsilon)
    _register(layer, name or "instance_norm")
    return layer(input)


def data_norm(input, act=None, epsilon=1e-5, param_attr=None,  # noqa: A002
              data_layout="NCHW", in_place=False, name=None, moving_mean_name=None,
              moving_variance_name=None, do_model_average_for_mean_and_var=True,
              slot_dim=-1, sync_stats=False, summary_decay_rate=0.9999999,
              enable_scale_and_shift=False):
    """Normalisation by accumulated batch statistics (CTR style)."""
    d = int(_dims(input)[-1])
    kw = dict(dtype=input.dtype, device=input.device)
    batch_size = Parameter(torch.full((d,), 1e4, **kw))
    batch_sum = Parameter(torch.zeros(d, **kw))
    batch_sq = Parameter(torch.full((d,), 1e4, **kw))
    for p in (batch_size, batch_sum, batch_sq):
        p.requires_grad_(False)
    _register([batch_size, batch_sum, batch_sq], name or "data_norm")
    mean = ops.divide(batch_sum, batch_size)
    scale = ops.rsqrt(ops.add(ops.divide(batch_sq, batch_size),
                              torch.tensor(epsilon, **kw)))
    return _act(act, ops.multiply(ops.subtract(input, mean), scale))


def _conv(builder_cls, input, num_filters, filter_size, stride, padding,  # noqa: A002
          dilation, groups, bias_attr, act, data_format, name, base):
    layer = builder_cls(
        in_channels=int(_dims(input)[1 if data_format.startswith("NC") else -1]),
        out_channels=num_filters, kernel_size=filter_size, stride=stride,
        padding=padding, dilation=dilation, groups=groups or 1,
        bias_attr=bias_attr, data_format=data_format)
    _register(layer, name or base)
    return _act(act, layer(input))


def conv2d(input, num_filters, filter_size, stride=1, padding=0,  # noqa: A002
           dilation=1, groups=None, param_attr=None, bias_attr=None,
           use_cudnn=True, act=None, name=None, data_format="NCHW"):
    from .. import nn

    return _conv(nn.Conv2D, input, num_filters, filter_size, stride, padding,
                 dilation, groups, bias_attr, act, data_format, name, "conv2d")


def conv3d(input, num_filters, filter_size, stride=1, padding=0,  # noqa: A002
           dilation=1, groups=None, param_attr=None, bias_attr=None,
           use_cudnn=True, act=None, name=None, data_format="NCDHW"):
    from .. import nn

    return _conv(nn.Conv3D, input, num_filters, filter_size, stride, padding,
                 dilation, groups, bias_attr, act, data_format, name, "conv3d")


def _transpose_conv(cls, base, input, num_filters, filter_size, padding, stride,  # noqa: A002
                    dilation, groups, bias_attr, act, name, data_format):
    if filter_size is None:
        raise ValueError("filter_size is required (output_size-only inference "
                         "is not provided)")
    return _conv(cls, input, num_filters, filter_size, stride, padding, dilation,
                 groups, bias_attr, act, data_format, name, base)


def conv2d_transpose(input, num_filters, output_size=None, filter_size=None,  # noqa: A002
                     padding=0, stride=1, dilation=1, groups=None, param_attr=None,
                     bias_attr=None, use_cudnn=True, act=None, name=None,
                     data_format="NCHW"):
    from .. import nn

    return _transpose_conv(nn.Conv2DTranspose, "conv2d_transpose", input, num_filters,
                           filter_size, padding, stride, dilation, groups, bias_attr,
                           act, name, data_format)


def conv3d_transpose(input, num_filters, output_size=None, filter_size=None,  # noqa: A002
                     padding=0, stride=1, dilation=1, groups=None, param_attr=None,
                     bias_attr=None, use_cudnn=True, act=None, name=None,
                     data_format="NCDHW"):
    from .. import nn

    return _transpose_conv(nn.Conv3DTranspose, "conv3d_transpose", input, num_filters,
                           filter_size, padding, stride, dilation, groups, bias_attr,
                           act, name, data_format)


def _pair(v):
    return v if isinstance(v, int) else v[0]


@defop("vision.deform_conv2d")
def _deform_conv2d(x, offset, weight, bias=None, stride=1, padding=0, dilation=1,
                   mask=None):
    """Deformable conv v1/v2 (the JAX package's vision.ops._deform_conv2d):
    bilinear samples at every kernel tap's offset location, then one
    contraction with the weight."""
    N, Cin, H, W = x.shape
    Cout, _, kh, kw = weight.shape
    s, p, d = _pair(stride), _pair(padding), _pair(dilation)
    Ho = (H + 2 * p - d * (kh - 1) - 1) // s + 1
    Wo = (W + 2 * p - d * (kw - 1) - 1) // s + 1
    xp = torch.nn.functional.pad(x, (p, p, p, p))
    Hp, Wp = H + 2 * p, W + 2 * p
    flat = xp.reshape(N, Cin, Hp * Wp)
    base_y = (torch.arange(Ho, device=x.device) * s)[None, :, None]
    base_x = (torch.arange(Wo, device=x.device) * s)[None, None, :]

    def gather(yi, xi):
        idx = (yi * Wp + xi)[:, None].expand(N, Cin, Ho, Wo).reshape(N, Cin, -1)
        return torch.gather(flat, 2, idx).reshape(N, Cin, Ho, Wo)

    cols = []
    for iy in range(kh):
        for ix in range(kw):
            tap = iy * kw + ix
            yy = base_y + iy * d + offset[:, 2 * tap]
            xx = base_x + ix * d + offset[:, 2 * tap + 1]
            y0 = torch.floor(yy).long().clamp(0, Hp - 1)
            y1 = (y0 + 1).clamp(0, Hp - 1)
            x0 = torch.floor(xx).long().clamp(0, Wp - 1)
            x1 = (x0 + 1).clamp(0, Wp - 1)
            wy = (yy - y0).clamp(0, 1)[:, None]
            wx = (xx - x0).clamp(0, 1)[:, None]
            val = (gather(y0, x0) * (1 - wy) * (1 - wx) + gather(y0, x1) * (1 - wy) * wx
                   + gather(y1, x0) * wy * (1 - wx) + gather(y1, x1) * wy * wx)
            if mask is not None:
                val = val * mask[:, tap, None]
            cols.append(val)
    col = torch.stack(cols, 2).reshape(N, Cin * kh * kw, Ho * Wo)
    out = torch.einsum("oc,ncp->nop", weight.reshape(Cout, -1).float(), col.float())
    out = out.reshape(N, Cout, Ho, Wo)
    if bias is not None:
        out = out + bias[None, :, None, None]
    return out.to(x.dtype)


def deform_conv2d(input, offset, mask, num_filters, filter_size, stride=1,  # noqa: A002
                  padding=0, dilation=1, groups=1, deformable_groups=1,
                  im2col_step=1, param_attr=None, bias_attr=None, name=None):
    if groups != 1 or deformable_groups != 1:
        raise NotImplementedError(
            "deform_conv2d supports groups=1 and deformable_groups=1")
    ks = filter_size if isinstance(filter_size, (list, tuple)) else (filter_size, filter_size)
    c_in = int(_dims(input)[1])
    weight = Parameter(_xavier((num_filters, c_in, int(ks[0]), int(ks[1])), input))
    params = [weight]
    bias = None
    if bias_attr is not False:
        bias = Parameter(torch.zeros(num_filters, dtype=input.dtype, device=input.device))
        params.append(bias)
    _register(params, name or "deform_conv2d")
    return _deform_conv2d(input, offset, weight, bias, stride=stride, padding=padding,
                          dilation=dilation, mask=mask)


def bilinear_tensor_product(x, y, size, act=None, name=None, param_attr=None,
                            bias_attr=None):
    from .. import nn

    layer = nn.Bilinear(int(_dims(x)[-1]), int(_dims(y)[-1]), size,
                                bias_attr=bias_attr)
    _register(layer, name or "bilinear_tensor_product")
    return _act(act, layer(x, y))


def prelu(x, mode="all", param_attr=None, data_format="NCHW", name=None):
    """PReLU with one alpha (all), one a channel (channel) or one an element."""
    dims = _dims(x)
    if mode == "all":
        shape = (1,)
    elif mode == "channel":
        shape = (int(dims[1 if data_format == "NCHW" else -1]),)
    elif mode == "element":
        shape = tuple(int(s) for s in dims[1:])
    else:
        raise ValueError(f"mode must be all/channel/element, got {mode!r}")
    alpha = Parameter(torch.full(shape, 0.25, dtype=x.dtype, device=x.device))
    _register([alpha], name or "prelu")
    return F.prelu(x, alpha, data_format=data_format)


def row_conv(input, future_context_size, param_attr=None, act=None):  # noqa: A002
    """Lookahead conv over time, [B, T, D]: out[t] = sum_i x[t + i] * w[i]."""
    k = int(future_context_size)
    d = int(_dims(input)[-1])
    w = Parameter(torch.full((k + 1, d), 1.0 / (k + 1), dtype=input.dtype, device=input.device))
    _register([w], "row_conv")
    t_len = int(_dims(input)[1])
    zeros_row = ops.zeros_like(ops.slice(input, [1], [0], [1]))
    padded = ops.concat([input, ops.tile(zeros_row, [1, k, 1])], axis=1)
    out = None
    for i in range(k + 1):
        term = ops.multiply(ops.slice(padded, [1], [i], [i + t_len]),
                            ops.slice(w, [0], [i], [i + 1]))
        out = term if out is None else ops.add(out, term)
    return _act(act, out)


def spectral_norm(weight, dim=0, power_iters=1, eps=1e-12, name=None):
    """A weight over its largest singular value, by power iteration from a
    fixed u (seed 0; it cannot match the JAX package's threefry draw)."""
    w = weight
    shape = [int(s) for s in _dims(w)]
    perm = None
    if dim != 0:
        perm = [dim] + [i for i in range(len(shape)) if i != dim]
        w = ops.transpose(w, perm)
        shape = [shape[q] for q in perm]
    h = shape[0]
    mat = ops.reshape(w, [h, -1])
    u = torch.randn(h, generator=torch.Generator().manual_seed(0)).to(mat.device, mat.dtype)
    epsilon = torch.tensor(eps, dtype=mat.dtype, device=mat.device)
    v = None
    for _ in range(max(1, power_iters)):
        v = ops.matmul(mat, u, transpose_x=True)
        v = ops.divide(v, ops.add(ops.norm(v), epsilon))
        u = ops.matmul(mat, v)
        u = ops.divide(u, ops.add(ops.norm(u), epsilon))
    sigma = ops.matmul(u, ops.matmul(mat, v))
    out = ops.divide(w, ops.add(sigma, epsilon))
    if perm is not None:
        out = ops.transpose(out, list(np.argsort(perm)))
    return out


def nce(input, label, num_total_classes, sample_weight=None,  # noqa: A002
        param_attr=None, bias_attr=None, num_neg_samples=None, name=None,
        sampler="uniform", custom_dist=None, seed=0, is_sparse=False):
    """Noise-contrastive estimation: per-example loss [B, 1] against
    ``num_neg_samples`` uniform negatives drawn afresh at every call (and
    every replay: the draw is a recorded op)."""
    d = int(_dims(input)[-1])
    k = int(num_neg_samples or 10)
    w = Parameter(_xavier((num_total_classes, d), input))
    bias = Parameter(torch.zeros(num_total_classes, dtype=input.dtype, device=input.device))
    _register([w, bias], name or "nce")
    lab = ops.cast(ops.reshape(label, [-1, 1]), "int64")
    # fresh uniform negatives each call (and each replay: one recorded
    # entry), from the device's default generator
    (neg,) = apply_raw("nce_negative_sample", lambda lab: torch.randint(
        0, num_total_classes, (lab.shape[0], k), device=lab.device), [lab])
    idx = ops.concat([lab, neg], axis=1)
    w_rows = ops.reshape(ops.gather(w, ops.reshape(idx, [-1])), [-1, 1 + k, d])
    b_rows = ops.reshape(ops.gather(bias, ops.reshape(idx, [-1])), [-1, 1 + k])
    logits = ops.add(ops.squeeze(ops.matmul(w_rows, ops.unsqueeze(input, axis=-1)), axis=-1),
                     b_rows)
    # positive column -> softplus(-x), negative columns -> softplus(x)
    pos = F.softplus(ops.scale(ops.slice(logits, [1], [0], [1]), -1.0))
    negl = F.softplus(ops.slice(logits, [1], [1], [1 + k]))
    return ops.add(ops.sum(pos, axis=1, keepdim=True), ops.sum(negl, axis=1, keepdim=True))


# -- sequence ops: dense padded [batch, time, ...] (+ optional seq_lens) ------
def _time_mask(x, seq_lens):
    """[B, T] mask from per-row lengths (None: all valid), through the
    recorded sequence_mask op, so the replay uses the fed lengths."""
    if seq_lens is None:
        return None
    lens = torch.as_tensor(seq_lens) if not _is_tensor(seq_lens) else seq_lens
    return F.sequence_mask(lens, maxlen=int(_dims(x)[1]),
                           dtype=str(x.dtype).replace("torch.", ""))


def _const(x, value):
    return torch.tensor(value, dtype=x.dtype, device=x.device)


def sequence_conv(input, num_filters, filter_size=3, filter_stride=1,  # noqa: A002
                  padding=True, padding_start=None, bias_attr=None, param_attr=None,
                  act=None, name=None):
    """Context-window projection over time: the window's frames
    concatenated, then one fc."""
    if filter_stride != 1:
        raise NotImplementedError("sequence_conv supports stride 1 "
                                  "(reference kernel has the same limit)")
    t = int(_dims(input)[1])
    k = int(filter_size)
    start = -((k - 1) // 2) if padding_start is None else int(padding_start)
    cols = []
    zeros_row = ops.zeros_like(ops.slice(input, [1], [0], [1]))
    for i in range(k):
        off = start + i
        if off <= -t or off >= t:
            shifted = ops.tile(zeros_row, [1, t, 1])
        elif off < 0:
            shifted = ops.concat([ops.tile(zeros_row, [1, -off, 1]),
                                  ops.slice(input, [1], [0], [t + off])], axis=1)
        elif off == 0:
            shifted = input
        else:
            shifted = ops.concat([ops.slice(input, [1], [off], [t]),
                                  ops.tile(zeros_row, [1, off, 1])], axis=1)
        cols.append(shifted)
    window = ops.concat(cols, axis=-1)  # [B, T, k*D]
    return fc(window, num_filters, num_flatten_dims=2, bias_attr=bias_attr, activation=act,
              name=name or "sequence_conv")


def _masked_fill_neg(x, m):
    return ops.add(ops.multiply(x, m),
                   ops.multiply(ops.subtract(_const(x, 1.0), m), _const(x, -1e9)))


def sequence_softmax(input, use_cudnn=False, name=None, seq_lens=None):  # noqa: A002
    """Softmax over time within each sequence, padding masked."""
    mask = _time_mask(input, seq_lens)
    x = input
    if mask is not None:
        x = _masked_fill_neg(x, mask if x.dim() == 2 else ops.unsqueeze(mask, axis=-1))
    return F.softmax(x, axis=1)


def sequence_pool(input, pool_type="average", is_test=False, pad_value=0.0,  # noqa: A002
                  seq_lens=None):
    """max / average / sum / sqrt / first / last over time."""
    pool_type = pool_type.lower()
    mask = _time_mask(input, seq_lens)
    x = input
    if mask is not None and pool_type in ("average", "sum", "sqrt", "max"):
        m = ops.unsqueeze(mask, axis=-1) if x.dim() > 2 else mask
        x = _masked_fill_neg(x, m) if pool_type == "max" else ops.multiply(x, m)
    if pool_type == "max":
        return ops.max(x, axis=1)
    if pool_type == "sum":
        return ops.sum(x, axis=1)
    if pool_type in ("average", "mean", "sqrt"):
        s = ops.sum(x, axis=1)
        if mask is not None:
            n = ops.sum(mask, axis=1, keepdim=x.dim() > 2)
        else:
            n = _const(x, float(int(_dims(input)[1])))
        if pool_type == "sqrt":
            return ops.divide(s, ops.sqrt(n))
        return ops.divide(s, n)
    if pool_type == "first":
        return sequence_first_step(input)
    if pool_type == "last":
        return sequence_last_step(input, seq_lens=seq_lens)
    raise ValueError(f"unknown pool_type {pool_type!r}")


def sequence_first_step(input):  # noqa: A002
    return ops.squeeze(ops.slice(input, [1], [0], [1]), axis=1)


def sequence_last_step(input, seq_lens=None):  # noqa: A002
    t = int(_dims(input)[1])
    if seq_lens is None:
        return ops.squeeze(ops.slice(input, [1], [t - 1], [t]), axis=1)
    lens = torch.as_tensor(seq_lens) if not _is_tensor(seq_lens) else seq_lens
    idx = ops.subtract(ops.cast(lens, "int64"),
                       torch.tensor(1, dtype=torch.int64, device=lens.device))
    # one-hot contraction over time: gather-free and differentiable
    m = ops.cast(F.one_hot(idx, t), str(input.dtype).replace("torch.", ""))  # [B, T]
    for _ in range(input.dim() - 2):
        m = ops.unsqueeze(m, axis=-1)
    return ops.sum(ops.multiply(input, m), axis=1)


def sequence_expand(x, y, ref_level=-1, name=None):
    """Each row of x broadcast along y's time axis: [B, D] -> [B, T_y, D]."""
    t = int(_dims(y)[1])
    xe = x if x.dim() == 3 else ops.unsqueeze(x, axis=1)
    return ops.tile(xe, [1, t] + [1] * (xe.dim() - 2))
