"""Force and rebin kernels: plain PyTorch versions and the wrappers of the
hand-written CUDA kernels (csrc/)."""
