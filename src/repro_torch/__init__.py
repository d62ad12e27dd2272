"""MEERKAT in PyTorch for NVIDIA Hopper: the port of ``repro`` (JAX/Pallas).

Same module layout as ``repro``; it imports nothing of it.  Kernels are
hand-written CUDA C++ for ``sm_90a`` (``kernels/csrc``); entry points run on
the CUDA card unless the caller passes ``device="cpu"``.
"""
