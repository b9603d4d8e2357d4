"""Distributed training and serving support of the port (counterpart of
paddle_tpu.distributed): the single-device recompute and the hang watchdog
(``watchdog.py``) are ported so far."""
