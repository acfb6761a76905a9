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
stream). Tensor-parallel stages (tp > 1) are not ported (ROADMAP.md queue
1, "Multi-device").
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..device import resolve
from ..models import staged
from ..models.config import ModelConfig
from ..runtime import kv_cache as kv
from ..runtime.context import CellContext, _params_to, h2d


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
    fan out to each stage's cache slab."""

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
        """devices: one device per stage (default: one stage on ``cuda``,
        which raises without CUDA; the CPU tests pass ``["cpu"] * n``). A
        device may repeat: stages on one card share it. split: stage
        weights (default even)."""
        self.local_cfg = staged.local_cfg(cfg, tp)  # raises for tp > 1
        self.cfg = cfg
        self.tp = tp
        n_cells = kv.round_pool(n_cells)
        self.n_cells = n_cells
        self.devices = [resolve(d) for d in (devices or [None])]
        n_stages = len(self.devices)
        split = split or [1.0 / n_stages] * n_stages
        if len(split) != n_stages:
            raise ValueError(f"{len(split)} stage weights for {n_stages} stages")
        self.ranges = split_ranges(cfg.n_layers, split)
        self.stage_params = []
        self.caches = []
        for dev, (lo, hi) in zip(self.devices, self.ranges):
            sp = {"layers": params["layers"][lo:hi]}
            if lo == 0:
                sp.update({k: params[k] for k in self.FIRST_STAGE_GLOBALS if k in params})
            if hi == cfg.n_layers:
                sp.update({k: params[k] for k in self.LAST_STAGE_GLOBALS if k in params})
            self.stage_params.append(_params_to(sp, dev))
            self.caches.append(kv.create(hi - lo, n_cells, cfg.n_kv_heads, cfg.head_dim,
                                         cache_dtype, device=dev))
        self._init_cells(n_cells)

    @property
    def n_stages(self) -> int:
        return len(self.devices)

    def _dispatch(self, arrays: tuple, topk: int | None) -> torch.Tensor:
        """Enqueue every stage's step on the padded input arrays, each
        stage handing its f32 hidden states to the next; returns the last
        stage's output on its device."""
        on_dev: dict = {}
        x = None
        for si, dev in enumerate(self.devices):
            if dev not in on_dev:
                on_dev[dev] = [h2d(a, dev) for a in arrays]
            tokens, pos, seq, cell_idx, valid, seq_bits = on_dev[dev]
            last = si == self.n_stages - 1
            x = staged.stage_forward(
                self.stage_params[si], self.cfg, self.caches[si],
                tokens if si == 0 else x.to(dev), pos, seq, cell_idx, valid, seq_bits,
                first=si == 0, last=last, topk=topk if last else None)
        return x
