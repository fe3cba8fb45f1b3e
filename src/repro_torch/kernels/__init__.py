"""Hand-written Hopper kernels of the port (CUDA C++ under ``csrc/``),
their wrappers and plain PyTorch versions.  Nothing is built at import."""
