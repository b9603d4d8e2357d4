"""Operators of the port: the op registry (``_apply``) and the operators that
need more than plain PyTorch (``cuda``)."""
