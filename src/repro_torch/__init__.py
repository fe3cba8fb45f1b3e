"""PyTorch/CUDA port of the BaPipe pipeline system.

Mirrors the layout of the JAX package ``repro`` (``configs``, ``core``,
``models``, ``kernels``, ``pipeline``, ``launch``) so each module has an
obvious counterpart there.  The port imports ``torch`` only; it never
imports ``jax`` or anything of ``repro``.  Entry points run on ``cuda``
unless the caller passes ``device="cpu"``.
"""
