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


def cached_llama_live(target: str | Path, log=print) -> Path:
    """The live llama model (testmodel.build_llama_live) of a cached bench
    pair's target, beside it as live2.gguf, built only when missing."""
    path = Path(target).with_name(f"live{testmodel.LLAMA_LIVE_LAYERS}.gguf")
    if not path.exists():
        tmp = path.with_suffix(".tmp")
        testmodel.build_llama_live(tmp, target, log=log)
        tmp.replace(path)
    return path


def cached_mpt_pair(cache_dir: str | Path, eps: float, scale: str = "mpt7b",
                    n_layers: int | None = None, log=print) -> tuple[Path, Path, Path]:
    """(target, draft, live) GGUF paths of the MPT bench pair at `scale`
    (testmodel.build_mpt_bench_pair, with its synthetic vocabulary and its
    2-layer live model; the target n_layers deep, default the scale's)
    under cache_dir, built only when missing."""
    d = Path(cache_dir) / (f"{scale}_Q4_K_eps{eps}_vocab" + (f"_d{n_layers}" if n_layers else ""))
    paths = [d / "target.gguf", d / "draft.gguf", d / "live2.gguf"]
    if not all(p.exists() for p in paths):
        d.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        tmps = [p.with_suffix(".tmp") for p in paths]
        testmodel.build_mpt_bench_pair(tmps[0], tmps[1], scale=scale, eps=eps, vocab=True,
                                       live_path=tmps[2], n_layers=n_layers)
        for t, p in zip(tmps, paths):
            t.replace(p)
        log(f"built the {scale} Q4_K pair (eps={eps}) and its live model in "
            f"{time.perf_counter() - t0:.1f} s")
    return paths[0], paths[1], paths[2]


def cut_depth(src: str | Path, dst: str | Path, n_layers: int, log=print) -> Path:
    """A copy of the GGUF model `src` holding only its first n_layers
    layers (the tensors' bytes as they are, block_count rewritten), written
    to dst unless it is there already; src itself when it has no more than
    n_layers. On a bench pair, whose layers add nothing to the residual,
    the copy's greedy stream is the full model's."""
    from ..gguf.constants import Keys
    from ..gguf.reader import GGUFReader
    from ..gguf.writer import GGUFWriter

    dst = Path(dst)
    if dst.exists():
        return dst
    t0 = time.perf_counter()
    with GGUFReader(src) as r:
        block_count = Keys.BLOCK_COUNT.format(arch=r.architecture)
        if int(r.metadata[block_count]) <= n_layers:
            return Path(src)
        w = GGUFWriter(dst.with_suffix(".tmp"), r.architecture)
        for key, val in r.metadata.items():
            if key not in (Keys.ARCHITECTURE, Keys.ALIGNMENT):
                w.add_kv(key, n_layers if key == block_count else val)
        for name, info in r.tensors.items():
            if not name.startswith("blk.") or int(name.split(".")[1]) < n_layers:
                w.add_tensor(name, bytes(r.tensor_bytes(name)), shape=info.shape,
                             qtype=info.qtype)
        w.write()
    dst.with_suffix(".tmp").replace(dst)
    log(f"cut {Path(src).name} to {n_layers} layers in {time.perf_counter() - t0:.1f} s")
    return dst


def cached_mmproj(cache_dir: str | Path, scale: str = "vit_l14_336", seed: int = 0,
                  log=print) -> Path:
    """The mmproj GGUF of testmodel.build_mmproj(scale, seed) under
    cache_dir (about 1.3 GB in f32 at vit_l14_336), built only when
    missing."""
    path = Path(cache_dir) / f"mmproj_{scale}_seed{seed}.gguf"
    if not path.exists():
        path.parent.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        tmp = path.with_suffix(".tmp")
        testmodel.build_mmproj(tmp, scale, seed)
        tmp.replace(path)
        log(f"built the {scale} mmproj in {time.perf_counter() - t0:.1f} s")
    return path
