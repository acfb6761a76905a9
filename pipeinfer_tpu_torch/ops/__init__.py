"""Compute ops: layer primitives, the quantized matmul and cell attention.
The hand-written CUDA kernels live in ``csrc/`` and are built by
``ops.cuda_build`` at first use."""
