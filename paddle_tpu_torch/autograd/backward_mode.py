"""``paddle.autograd.backward`` and ``paddle.grad``: the port of the entry
points of ``paddle_tpu/autograd/tape.py``.

PyTorch's engine stands in for the JAX tape. ``grad(no_grad_vars=...)``
keeps the JAX rule: no cotangent flows through a listed tensor. Each listed
tensor's gradient is replaced by zeros on its way through (a tensor hook),
and an input counts as used only where a path from the outputs reaches it
without crossing a listed tensor, so an input reached only through them is
unused (``None`` with ``allow_unused``, else the JAX error).
"""
from __future__ import annotations

import torch

from . import master_grad


def _as_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def backward(tensors, grad_tensors=None, retain_graph=False):
    """paddle.autograd.backward: accumulate into the leaves' ``.grad``."""
    tensors = _as_list(tensors)
    if grad_tensors is not None:
        grad_tensors = _as_list(grad_tensors)
    torch.autograd.backward(tensors, grad_tensors, retain_graph=retain_graph)


def _edge(t):
    e = torch.autograd.graph.get_gradient_edge(t)
    return (e.node, e.output_nr)


def _reached(outputs, blocked, alive):
    """The gradient edges (id(node), output_nr) that a walk from ``outputs``
    reaches without crossing an edge in ``blocked``. Every node met is kept
    in ``alive``, so that its Python object, and so its id, stays the one
    ``get_gradient_edge`` gives for it."""
    seen_nodes, edges = set(), set()
    stack = []
    for o in outputs:
        if o.requires_grad:
            e = _edge(o)
            if (id(e[0]), e[1]) not in blocked:
                edges.add((id(e[0]), e[1]))
                stack.append(e[0])
    while stack:
        node = stack.pop()
        if node is None or id(node) in seen_nodes:
            continue
        seen_nodes.add(id(node))
        alive.append(node)
        for nxt, nr in node.next_functions:
            if nxt is None or (id(nxt), nr) in blocked:
                continue
            edges.add((id(nxt), nr))
            stack.append(nxt)
    return edges


def grad(outputs, inputs, grad_outputs=None, retain_graph=None, create_graph=False,
         only_inputs=True, allow_unused=False, no_grad_vars=None):
    """paddle.grad over ``torch.autograd.grad``: a list of gradients, ``None``
    for an unused input when ``allow_unused`` (else ``RuntimeError``)."""
    outputs = _as_list(outputs)
    inputs = _as_list(inputs)
    if grad_outputs is not None:
        grad_outputs = _as_list(grad_outputs)
    retain = create_graph if retain_graph is None else retain_graph
    with master_grad.engine_edges_only():
        return _grad(outputs, inputs, grad_outputs, retain, create_graph, allow_unused,
                     no_grad_vars)


def _grad(outputs, inputs, grad_outputs, retain, create_graph, allow_unused, no_grad_vars):
    skip = [t for t in _as_list(no_grad_vars)] if no_grad_vars is not None else []
    skip = [t for t in skip if isinstance(t, torch.Tensor) and t.requires_grad]
    if not skip:
        return list(torch.autograd.grad(outputs, inputs, grad_outputs=grad_outputs,
                                        retain_graph=retain, create_graph=create_graph,
                                        allow_unused=allow_unused))
    skip_edges, input_edges = [_edge(t) for t in skip], [_edge(t) for t in inputs]
    blocked = {(id(n), nr) for n, nr in skip_edges}
    alive = []  # the walk's nodes, held while their ids are compared
    used = _reached(outputs, blocked, alive)
    in_edges = [(id(n), nr) for n, nr in input_edges]
    for i, e in enumerate(in_edges):
        if e not in used and not allow_unused:
            raise RuntimeError(
                f"One of the differentiated tensors (input {i}) appears unused in the "
                "graph; pass allow_unused=True to return None for it.")
    handles = [t.register_hook(torch.zeros_like) for t in skip]
    try:
        got = torch.autograd.grad(outputs, inputs, grad_outputs=grad_outputs,
                                  retain_graph=retain, create_graph=create_graph,
                                  allow_unused=True)
    finally:
        for h in handles:
            h.remove()
    return [g if e in used else None for e, g in zip(in_edges, got)]


no_grad = torch.no_grad
enable_grad = torch.enable_grad
set_grad_enabled = torch.set_grad_enabled
is_grad_enabled = torch.is_grad_enabled
