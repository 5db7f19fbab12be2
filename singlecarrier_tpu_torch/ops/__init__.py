"""Kernels of the port: CUDA C++ for sm_90a beside plain PyTorch twins."""
