"""Hand-written CUDA kernels for Hopper (``csrc/``), their plain PyTorch
versions (``ref.py``) and the wrappers that pick between them (``ops.py``).
Importing this package builds nothing: the first kernel launch does."""
