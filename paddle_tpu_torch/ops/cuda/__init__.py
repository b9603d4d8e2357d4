"""Hand-written CUDA kernels for Hopper (``sm_90a``), one module per kernel:
the wrapper, its plain PyTorch version and its launch counter."""
