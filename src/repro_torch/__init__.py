"""PyTorch/CUDA port of the NeuroVectorizer system for an NVIDIA H100.

Mirrors ``src/repro``'s layout.  The tiled matmul and the flash-attention
forward run as hand-written CUDA C++ kernels (``csrc/``) on CUDA tensors;
CPU tensors take each kernel's plain PyTorch version.  This package never
imports JAX or the JAX package.
"""
