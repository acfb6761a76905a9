"""The port's utils/compile_cache.py: ``enable`` points the kernel build
directory of ops/cuda_build.py at PIPEINFER_CACHE_DIR (or an argument),
leaves build/cuda/ otherwise and honours PIPEINFER_NO_COMPILE_CACHE, as
the JAX package's enable does for its XLA cache; ``shape_of`` and
``warm_parallel`` behave as the JAX package's. The kernel build itself
needs nvcc and runs on the card (chip_smoke.py)."""

import threading

import numpy as np
import pytest
import torch

from pipeinfer_tpu.utils import compile_cache as j_cc
from pipeinfer_tpu_torch.ops import cuda_build
from pipeinfer_tpu_torch.utils import compile_cache


@pytest.fixture
def clean_env(monkeypatch):
    """No cache variable set; whatever enable() sets is undone after the
    test (setenv records the variable's first state, then delenv drops it)."""
    for var in ("PIPEINFER_CACHE_DIR", "PIPEINFER_NO_COMPILE_CACHE", "PIPEINFER_CUDA_BUILD_DIR"):
        monkeypatch.setenv(var, "")
        monkeypatch.delenv(var)
    return monkeypatch


def test_enable_leaves_the_checkout_build_dir(clean_env):
    assert compile_cache.enable() == str(cuda_build.build_dir())
    assert cuda_build.build_dir() == cuda_build.CSRC.parent.parent / "build" / "cuda"


@pytest.mark.parametrize("how", ["env", "argument"])
def test_enable_points_the_build_dir_at_the_cache(clean_env, tmp_path, how):
    d = tmp_path / "kernels"
    if how == "env":
        clean_env.setenv("PIPEINFER_CACHE_DIR", str(d))
        got = compile_cache.enable()
    else:
        got = compile_cache.enable(str(d))
    assert got == str(d) and d.is_dir() and cuda_build.build_dir() == d
    # a library's path lies in the cache: every process pointed there shares it
    assert cuda_build._lib_path("qmatmul_i4g").parent == d
    assert compile_cache.enable() == str(d)  # idempotent


def test_enable_honours_no_compile_cache(clean_env, tmp_path):
    clean_env.setenv("PIPEINFER_NO_COMPILE_CACHE", "1")
    clean_env.setenv("PIPEINFER_CACHE_DIR", str(tmp_path / "unused"))
    assert compile_cache.enable() == j_cc.enable() == "(persistent compilation cache disabled)"
    assert not (tmp_path / "unused").exists()
    assert cuda_build.build_dir() == cuda_build.CSRC.parent.parent / "build" / "cuda"


def test_shape_of_is_the_tree_of_shapes_and_dtypes():
    tree = {"a": torch.zeros(2, 3), "b": [torch.ones(4, dtype=torch.int32), 7]}
    assert compile_cache.shape_of(tree) == {"a": ((2, 3), torch.float32),
                                            "b": [((4,), torch.int32), 7]}
    j = j_cc.shape_of({"a": np.zeros((2, 3), np.float32)})
    assert j["a"].shape == compile_cache.shape_of({"a": torch.zeros(2, 3)})["a"][0]


def test_warm_parallel_runs_every_job_and_reports_failures():
    seen, lock = [], threading.Lock()
    barrier = threading.Barrier(3, timeout=30)  # three jobs in flight at once

    def job(i):
        def run():
            barrier.wait()
            with lock:
                seen.append(i)
            if i == 1:
                raise ValueError("boom")
        return run

    logged = []
    res = compile_cache.warm_parallel([(f"j{i}", job(i)) for i in range(3)], max_workers=3,
                                      log=logged.append)
    assert sorted(seen) == [0, 1, 2]
    assert [n for n, _ in res] == ["j0", "j1", "j2"]
    assert res[0][1] is None and isinstance(res[1][1], ValueError) and res[2][1] is None
    assert logged == ["warm j0: ok", "warm j1: boom", "warm j2: ok"]
