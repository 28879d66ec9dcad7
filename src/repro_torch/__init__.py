"""PyTorch/CUDA port of the JExplore workload stack.

Mirrors the subpackage layout of the JAX package ``repro`` (``configs``,
``models``, ``kernels``, ``serve``, ``launch``), so each module here names its
reference by the same relative path.  This package imports ``torch``, numpy
and the standard library only: never ``jax`` and never ``repro``.
"""
