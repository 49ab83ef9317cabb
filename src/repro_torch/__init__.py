"""PyTorch + CUDA port of the Zampling system, beside the JAX package.

Modules mirror ``repro``'s names.  The port imports torch and numpy,
never jax and nothing of ``repro``.
"""
