"""Parallelism: pipeline stages, in one process or across processes.

Torch counterpart of pipeinfer_tpu.parallel: the reference's MPI pipeline
(ggml-mpi.c) becomes layer-range stages driven by the host, each with its
own cache slab (stages), or stage workers in their own processes joined by
TCP (dcn). The JAX package's tensor-parallel, fused-pipeline and
multi-host modules are not ported (ROADMAP.md queue 1, "Multi-device").
"""
