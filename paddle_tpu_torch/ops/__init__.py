"""Operators of the port that need more than plain PyTorch."""
