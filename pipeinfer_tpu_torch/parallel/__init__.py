"""Parallelism: pipeline stages, tensor parallelism, the fused pipeline
and multi-process meshes.

Torch counterpart of pipeinfer_tpu.parallel: the reference's MPI pipeline
(ggml-mpi.c) becomes layer-range stages driven by the host, each with its
own cache slab (stages), or stage workers in their own processes joined by
TCP (dcn). The JAX package's shard_map programs run over a device mesh
with explicit collectives (mesh): weights tensor-sharded over a 'model'
axis (tp), the pp x tp x dp microbatch step (pipefused), and meshes whose
coordinates belong to several processes (multihost).
"""
