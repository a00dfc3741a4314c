"""PyTorch + CUDA port of the serving data plane.

A package of its own beside the JAX reference package: it imports neither
``jax`` nor anything of ``repro``, and keeps its own copies of the pieces it
shares with it (configs, the simulated cloud, the serving frontend).
Entry points run on ``device="cuda"`` unless the caller passes another.
"""
