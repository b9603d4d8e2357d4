"""Fused-op surface of the port (counterpart of paddle_tpu.incubate)."""
