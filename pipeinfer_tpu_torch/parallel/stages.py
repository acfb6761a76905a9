"""Host-driven pipeline stages: the PipeInfer target topology.

Torch counterpart of pipeinfer_tpu.parallel.stages (ref: ggml-mpi.c ring
+ llama.cpp:9941-9977 worker loop): the target is cut into layer ranges;
each stage owns its layer slab and its own KV-cache slab, and the host
enqueues the stages' steps one after another, each handing its f32 hidden
states to the next, so several microbatches can be in flight across the
stage depth (the async controller's run deque maps onto this). The last
stage's output is copied to pinned host memory behind it
(``runtime.context.to_host_async``), and ``AsyncHandle.ready()`` on that
copy is the head's iprobe.

KV sequence operations fan out to every stage's cache (the counterpart of
the reference's pipelined KV transactions, llama.cpp:9238-9359), enqueued
without host synchronization; one host mirror of (pos, seq) serves the
cell allocation of all stages.

On one card the stages share the device, as the JAX package's ``--stages
N`` does when it repeats its device list, and all of them run on PyTorch's
current stream (the kernels' split-K scratch and tickets are kept per
stream). With tp > 1 a flat device list is grouped into per-stage
tensor-parallel sub-meshes (parallel/tp.py): each stage's weights and
cache are sharded over its group, its step runs models.staged
.stage_forward_tp, and the boundary activation is replicated onto the
next group's devices (the JAX package's device_put onto the next stage's
NamedSharding).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..device import resolve
from ..models import staged
from ..models.config import ModelConfig
from ..runtime import kv_cache as kv
from ..runtime.context import CellContext, _params_to, h2d
from . import tp as tpmod


def split_ranges(n_layers: int, weights: Sequence[float]) -> list[tuple[int, int]]:
    """Weighted layer ranges (ref: ggml_mpi_split_range ggml-mpi.c:523-559;
    the --mpi-layer-split fractions UX)."""
    total = sum(weights)
    ranges = []
    start = 0
    for i, w in enumerate(weights):
        n = round(n_layers * w / total) if i < len(weights) - 1 else n_layers - start
        n = max(1, min(n, n_layers - start - (len(weights) - 1 - i)))
        ranges.append((start, start + n))
        start += n
    if start != n_layers:
        raise ValueError(f"split {list(weights)} does not cover {n_layers} layers: {ranges}")
    return ranges


class StagedInferenceContext(CellContext):
    """InferenceContext-compatible engine over pipeline stages.

    Exposes the decode and seq-op surface the speculation controller and
    the lookahead decoder use, so both run unchanged over 1..N stages:
    CellContext's host mirror allocates for every stage, and its seq ops
    fan out to each stage's cache slab (each shard's, under TP)."""

    FIRST_STAGE_GLOBALS = ("tok_embd", "tok_norm", "tok_norm_b", "pos_embd")
    LAST_STAGE_GLOBALS = ("output_norm", "output_norm_b", "output")

    def __init__(
        self,
        params,
        cfg: ModelConfig,
        *,
        n_cells: int = 1024,
        devices: Sequence | None = None,
        split: Sequence[float] | None = None,
        cache_dtype=torch.bfloat16,
        tp: int = 1,
    ):
        """devices: one device per stage, or with tp > 1 a flat list
        grouped into per-stage sub-meshes of tp devices (default: one
        stage on ``cuda``, which raises without CUDA; the CPU tests pass
        ``["cpu"] * n``). A device may repeat: stages and shards on one
        card share it. split: stage weights (default even)."""
        self.local_cfg = staged.local_cfg(cfg, tp)
        self.cfg = cfg
        self.tp = tp
        n_cells = kv.round_pool(n_cells)
        self.n_cells = n_cells
        devices = [resolve(d) for d in (devices or [None])]
        if len(devices) % tp:
            raise ValueError(f"{len(devices)} devices do not group into tp={tp} sub-meshes")
        self.groups = [devices[i: i + tp] for i in range(0, len(devices), tp)]
        self.devices = [g[0] for g in self.groups]
        self.meshes = [tpmod.tp_mesh(g) if tp > 1 else None for g in self.groups]
        n_stages = len(self.groups)
        split = split or [1.0 / n_stages] * n_stages
        if len(split) != n_stages:
            raise ValueError(f"{len(split)} stage weights for {n_stages} stages")
        self.ranges = split_ranges(cfg.n_layers, split)
        self.stage_params = []
        self.stage_caches = []  # per stage: its KVCache, or its shards' list under TP
        for dev, mesh, (lo, hi) in zip(self.devices, self.meshes, self.ranges):
            sp = {"layers": params["layers"][lo:hi]}
            if lo == 0:
                sp.update({k: params[k] for k in self.FIRST_STAGE_GLOBALS if k in params})
            if hi == cfg.n_layers:
                sp.update({k: params[k] for k in self.LAST_STAGE_GLOBALS if k in params})
            cache = kv.create(hi - lo, n_cells, cfg.n_kv_heads, cfg.head_dim, cache_dtype,
                              device=dev)
            if mesh is None:
                self.stage_params.append(_params_to(sp, dev))
                self.stage_caches.append(cache)
            else:
                self.stage_params.append(tpmod.shard_params(sp, cfg, mesh)[0])
                self.stage_caches.append(tpmod.shard_cache(cache, mesh))
        self.caches = [c for sc in self.stage_caches
                       for c in (sc if isinstance(sc, list) else [sc])]
        self._init_cells(n_cells)

    @property
    def n_stages(self) -> int:
        return len(self.devices)

    def _stage_step(self, si: int, x, ins: tuple, topk: int | None) -> torch.Tensor:
        """Stage si's step on x (tokens for stage 0, else the previous
        stage's f32 hidden states, on any device) and the padded inputs
        (pos, seq, cell_idx, valid, seq_bits) on the stage's device."""
        first, last = si == 0, si == self.n_stages - 1
        kw = dict(first=first, last=last, topk=topk if last else None)
        if self.meshes[si] is None:
            return staged.stage_forward(self.stage_params[si], self.cfg, self.stage_caches[si],
                                        x.to(self.devices[si]), *ins, **kw)
        return _staged_step_tp(self.local_cfg, self.meshes[si])(
            self.stage_params[si], self.stage_caches[si], x, *ins, **kw)

    def _dispatch(self, arrays: tuple, topk: int | None) -> torch.Tensor:
        """Enqueue every stage's step on the padded input arrays, each
        stage handing its f32 hidden states to the next; returns the last
        stage's output on its device."""
        on_dev: dict = {}
        x = None
        for si, dev in enumerate(self.devices):
            if dev not in on_dev:
                on_dev[dev] = [h2d(a, dev) for a in arrays]
            tokens, *ins = on_dev[dev]
            x = self._stage_step(si, tokens if si == 0 else x, tuple(ins), topk)
        return x

    def precompile(self, *, buckets=(1, 8, 32), topk: int | None = None, max_workers: int = 6,
                   log=None, **_ignored) -> dict[str, float]:
        """Warm every stage's step at each bucket, one warm_parallel job per
        stage (pipeinfer_tpu/parallel/stages.py:314-385; the port compiles
        nothing, but this builds and loads the kernels and PyTorch's lazy
        state). Every row is invalid, so a step writes only its stage's
        trash cell, which is never visible; a stage's buckets run in turn
        in its job, so no two threads touch one cache. Returns seconds per
        job; a job's failure raises."""
        import time

        from ..utils.compile_cache import warm_parallel

        took = {}

        def job(si, name):
            def run():
                t0 = time.perf_counter()
                dev = self.devices[si]
                for b in buckets:
                    z = h2d(np.zeros(b, np.int32), dev)
                    x = z if si == 0 else torch.zeros(b, self.cfg.n_embd, device=dev)
                    ins = (z, z, h2d(np.full(b, self.trash_cell, np.int32), dev),
                           h2d(np.zeros(b, bool), dev),
                           h2d(np.zeros((b, kv.SEQ_WORDS), np.int32), dev))
                    self._stage_step(si, x, ins, topk)
                self._sync()
                took[name] = time.perf_counter() - t0
            return run

        names = [f"stage{si}/step{list(buckets)},topk={topk if si == self.n_stages - 1 else None}"
                 for si in range(self.n_stages)]
        for name, err in warm_parallel([(n, job(si, n)) for si, n in enumerate(names)],
                                       max_workers=max_workers, log=log):
            if err is not None:
                raise RuntimeError(f"warm-up {name} failed") from err
        return {n: took[n] for n in names}


def _staged_step_tp(lcfg: ModelConfig, mesh):
    """The TP-inside-a-stage step (pipeinfer_tpu/parallel/stages.py:432-464):
    stage_forward_tp over the stage's sub-mesh."""
    def step(shards, caches, x, pos, seq, cell_idx, valid, seq_bits, *, first, last, topk):
        return staged.stage_forward_tp(shards, lcfg, caches, x, pos, seq, cell_idx, valid,
                                       seq_bits, first=first, last=last, topk=topk, mesh=mesh)

    return step
