"""Hand-written CUDA kernels for Hopper (csrc/) and their wrappers.

- sw_banded: banded affine Smith-Waterman, score-only and with in-kernel
  traceback, each with a plain PyTorch twin;
- sv_cluster: the serial cluster sweep over sorted LUMPY evidence, with
  a plain PyTorch twin;
- seed_chain: the align step's hash seeding and NMS chaining of both
  ends in one launch, with the plain composition as its twin;
- nvcc_build: the nvcc + ctypes build they use.
"""
