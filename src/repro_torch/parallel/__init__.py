"""Parallelism (port of ``repro/parallel``): the sharding policy, gradient
compression (``ef_compress_tree``, ``psum_int8``) and the GPipe pipeline."""
