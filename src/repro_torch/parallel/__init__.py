"""Parallelism (port of ``repro/parallel``).  So far the gradient compression;
sharding and the pipeline come with ROADMAP slice 7b."""
