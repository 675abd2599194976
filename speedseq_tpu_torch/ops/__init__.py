"""Hand-written CUDA kernels for Hopper (csrc/) and their wrappers.

- sw_banded: banded affine Smith-Waterman, score-only and with in-kernel
  traceback, each with a plain PyTorch twin;
- sv_cluster: the serial cluster sweep over sorted LUMPY evidence, with
  a plain PyTorch twin;
- nvcc_build: the nvcc + ctypes build both use.
"""
