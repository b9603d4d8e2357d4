"""Distributed training of the port (counterpart of paddle_tpu.distributed);
only the single-device recompute is ported so far."""
