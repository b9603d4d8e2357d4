"""Typed enforce errors and the check helpers: the port of
``paddle_tpu/framework/enforce.py``.

Reference analog: phi/core/enforce.h (the PADDLE_ENFORCE* macros with the
typed error codes of phi/core/errors.h) and the "[Hint: ...]" message format
users grep for. The classes keep the JAX package's bases, so an
``InvalidArgumentError`` is both an ``EnforceNotMet`` and a ``ValueError``,
and its ``code`` strings. Nothing here touches a tensor: ``enforce_shape``
and ``enforce_dtype`` read ``.shape`` and ``.dtype`` (a ``torch.dtype``
prints as ``torch.float32``, so ``"float32"`` matches it as a substring,
as it matches the JAX package's numpy dtypes).
"""
from __future__ import annotations


class EnforceNotMet(RuntimeError):
    """Base of all enforce failures (enforce.h EnforceNotMet)."""

    code = "ENFORCE_NOT_MET"


class InvalidArgumentError(EnforceNotMet, ValueError):
    code = "INVALID_ARGUMENT"


class NotFoundError(EnforceNotMet, LookupError):
    code = "NOT_FOUND"


class OutOfRangeError(EnforceNotMet, IndexError):
    code = "OUT_OF_RANGE"


class AlreadyExistsError(EnforceNotMet):
    code = "ALREADY_EXISTS"


class ResourceExhaustedError(EnforceNotMet, MemoryError):
    code = "RESOURCE_EXHAUSTED"


class PreconditionNotMetError(EnforceNotMet):
    code = "PRECONDITION_NOT_MET"


class PermissionDeniedError(EnforceNotMet, PermissionError):
    code = "PERMISSION_DENIED"


class ExecutionTimeoutError(EnforceNotMet, TimeoutError):
    code = "EXECUTION_TIMEOUT"


class UnimplementedError(EnforceNotMet, NotImplementedError):
    code = "UNIMPLEMENTED"


class UnavailableError(EnforceNotMet):
    code = "UNAVAILABLE"


class FatalError(EnforceNotMet):
    code = "FATAL"


def _fmt(msg, hint):
    return f"{msg}\n  [Hint: {hint}]" if hint else msg


def enforce(cond, msg="enforce failed", hint=None,
            exc=InvalidArgumentError):
    """PADDLE_ENFORCE(cond, ...): raise `exc` with the reference's message
    shape when cond is falsy."""
    if not cond:
        raise exc(_fmt(msg, hint))


def enforce_eq(a, b, msg=None, hint=None, exc=InvalidArgumentError):
    if a != b:
        raise exc(_fmt(msg or f"expected {a!r} == {b!r}", hint))


def enforce_ne(a, b, msg=None, hint=None, exc=InvalidArgumentError):
    if a == b:
        raise exc(_fmt(msg or f"expected {a!r} != {b!r}", hint))


def enforce_gt(a, b, msg=None, hint=None, exc=InvalidArgumentError):
    if not a > b:
        raise exc(_fmt(msg or f"expected {a!r} > {b!r}", hint))


def enforce_ge(a, b, msg=None, hint=None, exc=InvalidArgumentError):
    if not a >= b:
        raise exc(_fmt(msg or f"expected {a!r} >= {b!r}", hint))


def enforce_lt(a, b, msg=None, hint=None, exc=InvalidArgumentError):
    if not a < b:
        raise exc(_fmt(msg or f"expected {a!r} < {b!r}", hint))


def enforce_le(a, b, msg=None, hint=None, exc=InvalidArgumentError):
    if not a <= b:
        raise exc(_fmt(msg or f"expected {a!r} <= {b!r}", hint))


def enforce_shape(x, expected, name="tensor"):
    """Shape check with per-dim wildcards (None/-1 = any), the common
    InferMeta-style validation."""
    shape = tuple(getattr(x, "shape", x))
    expected = tuple(expected)
    ok = len(shape) == len(expected) and all(
        e in (None, -1) or int(s) == int(e)
        for s, e in zip(shape, expected))
    if not ok:
        raise InvalidArgumentError(_fmt(
            f"{name} has shape {list(shape)}, expected {list(expected)}",
            "None/-1 dims match anything"))
    return shape


def enforce_dtype(x, allowed, name="tensor"):
    dt = str(getattr(x, "dtype", x))
    allowed_s = [str(a) for a in (
        allowed if isinstance(allowed, (list, tuple, set)) else [allowed])]
    if not any(a in dt for a in allowed_s):
        raise InvalidArgumentError(
            f"{name} has dtype {dt}, expected one of {allowed_s}")
    return dt


__all__ = [
    "EnforceNotMet", "InvalidArgumentError", "NotFoundError",
    "OutOfRangeError", "AlreadyExistsError", "ResourceExhaustedError",
    "PreconditionNotMetError", "PermissionDeniedError",
    "ExecutionTimeoutError", "UnimplementedError", "UnavailableError",
    "FatalError", "enforce", "enforce_eq", "enforce_ne", "enforce_gt",
    "enforce_ge", "enforce_lt", "enforce_le", "enforce_shape",
    "enforce_dtype",
]
