"""Hand-written CUDA kernels (``csrc/``) with their plain PyTorch versions.

Each wrapper runs its plain version for CPU tensors and launches its kernel
for CUDA tensors (or raises); ``build.py`` compiles the sources at first use.
"""
