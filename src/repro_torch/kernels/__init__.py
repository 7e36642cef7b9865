"""Hand-written Hopper kernels of the port, one package per TPU kernel
family of ``src/repro/kernels/``: ``ref.py`` holds the plain PyTorch
version, ``ops.py`` the wrapper that launches the kernel for CUDA tensors,
and ``csrc/`` the CUDA source.  ``_build`` compiles the sources with nvcc
at first use."""
