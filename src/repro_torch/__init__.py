"""PyTorch / CUDA port of the SSM and hybrid LM serving stack.

The JAX package ``repro`` is the reference this package is held against;
this package imports ``torch`` and never ``jax`` nor ``repro``.
"""
