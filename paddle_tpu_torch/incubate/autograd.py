"""paddle.incubate.autograd for the port: the functional transforms
(``autograd/functional.py``) and the prim entry points of
``paddle_tpu/incubate/autograd.py``. The prim flag only gates the entry
points, as in the JAX package: torch's autograd works on its own primitives
whatever it says."""
from ..autograd.functional import Hessian, Jacobian, hessian, jacobian, jvp, vjp  # noqa: F401

__all__ = ["jvp", "vjp", "Jacobian", "Hessian", "jacobian", "hessian", "enable_prim",
           "disable_prim", "prim_enabled", "forward_grad", "grad"]

_PRIM_ENABLED = [False]


def enable_prim():
    _PRIM_ENABLED[0] = True


def disable_prim():
    _PRIM_ENABLED[0] = False


def prim_enabled():
    return _PRIM_ENABLED[0]


def forward_grad(outputs, inputs, grad_inputs=None):
    """Forward-mode gradients of a callable ``outputs`` (its ``jvp``); built
    tensors raise, as in the JAX package."""
    if callable(outputs):
        return jvp(outputs, inputs, grad_inputs)[1]
    raise NotImplementedError(
        "forward_grad over already-built tensors is the reference's static-prim "
        "mode; pass the function: forward_grad(fn, xs, vs)")


def grad(outputs, inputs, grad_outputs=None):
    """Reverse-mode gradients: a callable through ``vjp``, tensors through
    ``paddle.grad``."""
    if callable(outputs):
        return vjp(outputs, inputs, grad_outputs)[1]
    from ..autograd import grad as tape_grad

    return tape_grad(outputs, inputs, grad_outputs=grad_outputs)
