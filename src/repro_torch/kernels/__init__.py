"""Hand-written CUDA kernels for Hopper (``sm_90a``) with their plain
PyTorch versions; see ``ops`` for the public entry points."""
