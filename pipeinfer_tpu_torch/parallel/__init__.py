"""Parallelism: pipeline stages.

Torch counterpart of pipeinfer_tpu.parallel: the reference's MPI pipeline
(ggml-mpi.c) becomes layer-range stages driven by the host, each with its
own cache slab. The JAX package's tensor-parallel, fused-pipeline and
multi-host modules are not ported (ROADMAP.md queue 1, "Multi-device").
"""
