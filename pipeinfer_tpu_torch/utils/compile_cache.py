"""The persistent kernel-build cache and parallel warm-up.

Torch counterpart of pipeinfer_tpu.utils.compile_cache. On the TPU the
startup cost is XLA compiling every jitted step variant, and that module
attacks it twice: a persistent on-disk compilation cache shared by every
process on the machine, and parallel ahead-of-time warm-up. The port
compiles no programs: its startup cost is ``nvcc`` building the kernels in
csrc/, and ops/cuda_build.py already does both there (libraries keyed by a
hash of their sources in one build directory that every process of the
checkout shares, and all ``nvcc`` runs started together). What is left:

- ``enable`` points that build directory at ``PIPEINFER_CACHE_DIR`` when
  it is set (for example one directory shared by several checkouts) and
  otherwise leaves it at ``build/cuda/`` in the checkout; the variable it
  sets is inherited by the processes this one starts (parallel.dcn's stage
  workers);
- ``shape_of`` and ``warm_parallel`` as in the JAX package.

CUDA graphs, which would replace the JAX package's compiled step programs,
belong to the work that makes the port faster (ROADMAP.md).
"""

from __future__ import annotations

import concurrent.futures as cf
import os
from pathlib import Path

from ..ops import cuda_build


def enable(cache_dir: str | None = None) -> str:
    """Point the kernel build directory at cache_dir, else at
    PIPEINFER_CACHE_DIR when that is set (idempotent); returns the build
    directory. PIPEINFER_NO_COMPILE_CACHE=1 makes this a no-op, as in the
    JAX package."""
    if os.environ.get("PIPEINFER_NO_COMPILE_CACHE"):
        return "(persistent compilation cache disabled)"
    d = cache_dir or os.environ.get("PIPEINFER_CACHE_DIR")
    if d:
        Path(d).mkdir(parents=True, exist_ok=True)
        os.environ["PIPEINFER_CUDA_BUILD_DIR"] = str(d)
    return str(cuda_build.build_dir())


def shape_of(x):
    """The (shape, dtype) of every tensor in a nested dict/list/tuple
    (the JAX package's ShapeDtypeStruct tree)."""
    if isinstance(x, dict):
        return {k: shape_of(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(shape_of(v) for v in x)
    if hasattr(x, "shape") and hasattr(x, "dtype"):
        return tuple(x.shape), x.dtype
    return x


def warm_parallel(jobs, max_workers: int = 8, log=None):
    """Execute (name, thunk) warm-up jobs concurrently on a thread pool.
    Returns [(name, None or the exception it raised)] in job order; each
    is logged as ok or with its error when `log` is given."""

    def one(job):
        name, thunk = job
        try:
            thunk()
            return name, None
        except Exception as e:  # reported to the caller, which decides
            return name, e

    results = []
    with cf.ThreadPoolExecutor(max_workers=max_workers) as ex:
        for name, err in ex.map(one, jobs):
            if log:
                log(f"warm {name}: {'ok' if err is None else err}")
            results.append((name, err))
    return results
