"""paddle._legacy_C_ops: resolves as ``_C_ops`` does (the port of
``paddle_tpu/_legacy_C_ops.py``; the registry is the one op table)."""
from ._C_ops import __dir__, __getattr__  # noqa: F401
