"""The synthetic bench pair (testmodel.build_bench_pair), with its
synthetic SPM vocabulary, built once into a cache directory and reused by
later runs."""

from __future__ import annotations

import time
from pathlib import Path

from ..gguf.constants import GGMLQuantType
from . import testmodel


def cached_bench_pair(cache_dir: str | Path, scale: str, qtype_name: str, eps: float,
                      log=print) -> tuple[Path, Path]:
    """(target, draft) GGUF paths of the bench pair at `scale`, quantized
    to `qtype_name` with draft disagreement `eps` and a synthetic SPM
    vocabulary, under cache_dir; built (atomically, via temporary names)
    only when missing. The directory name says "vocab": pairs cached
    without a vocabulary are not reused."""
    d = Path(cache_dir) / f"{scale}_{qtype_name}_eps{eps}_vocab"
    t_path, d_path = d / "target.gguf", d / "draft.gguf"
    if not (t_path.exists() and d_path.exists()):
        d.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        t_tmp, d_tmp = t_path.with_suffix(".tmp"), d_path.with_suffix(".tmp")
        testmodel.build_bench_pair(t_tmp, d_tmp, scale=scale, eps=eps,
                                   qtype=GGMLQuantType[qtype_name], vocab=True)
        t_tmp.replace(t_path)
        d_tmp.replace(d_path)
        log(f"built {scale} {qtype_name} pair (eps={eps}) in {time.perf_counter() - t0:.1f} s")
    return t_path, d_path
