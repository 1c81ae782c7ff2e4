"""Hand-written Hopper kernels of the port, one package per kernel.

Each ``<name>/ops.py`` holds the kernel's wrapper (launches the CUDA
kernel built from ``csrc/<name>.cu`` for CUDA tensors), its plain
PyTorch version (used for CPU tensors and as the reference the kernel
is held against on the card) and an integer launch counter."""
