"""The port's kernels: hand-written CUDA for Hopper (``csrc/``), their
ctypes wrappers, the plain PyTorch versions (``ref``) and the device
dispatch (``ops``)."""
