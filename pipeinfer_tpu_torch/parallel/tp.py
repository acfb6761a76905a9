"""Tensor parallelism for quantized weights: per-shard params and the step
and draft-chain builders used by InferenceContext(mesh=...) and the staged
pipeline's per-stage sub-meshes.

Torch counterpart of pipeinfer_tpu.parallel.tp (ref: SURVEY §2.3 TP row).
Scheme, as there: every 2-D weight is sharded along its OUTPUT dimension
(whole quantized rows), so packed Q*_K planes split without requantization
and each shard stays a weight the kernels take; activations are
re-assembled with tiled all-gathers (parallel.mesh), a few KB at decode
batch sizes. K/V shard over heads; the cell metadata (pos, seq bitmask)
is replicated, so every sequence op runs on each shard's cache as on one
device's.

The JAX package stores sharded leaves SHARD-STACKED with a leading [tp]
axis that shard_map squeezes. The port keeps one param tree per local
shard, each on its shard's device, and every shard plane a contiguous
copy: the kernels read their planes through raw pointers and check their
alignment (ops/qmatmul.py:_aligned), and a column slice of an N-last plane
is neither contiguous nor aligned.
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch

from ..models import staged
from ..models.config import ModelConfig
from ..ops.qmatmul import PLANES, QuantTensor
from ..runtime import kv_cache as kv
from ..runtime.context import _params_to
from .mesh import Mesh

# slots sharded along their output dim (plus their biases)
_SHARD_W = {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "output"}
_SHARD_B = {"bq", "bk", "bv", "bo", "b_gate", "b_up", "b_down"}
# fused qkv: GGUF's block order [Q-rows; K-rows; V-rows] with head-ordered
# rows per segment, so each segment splits on head boundaries and the
# shard keeps its own fused [q_i; k_i; v_i] layout (generic.layer_step
# slices it with the shard-local dims)
_FUSED_QKV = {"wqkv", "bqkv"}

# matmul layouts whose every plane keeps N (the output dim) as its LAST
# axis: they shard along output columns without touching a packed byte's K
# structure (ref: ggml-mpi.c:523-587 splits quantized slabs the same way)
_N_LAST_LAYOUTS = ("k_major", "i8", "i8g", "i4g", "k4")


def tp_mesh(devices: Sequence, ranks: Sequence[int] | None = None) -> Mesh:
    """A 1-axis 'model' mesh over `devices` (a device may repeat; ranks:
    the owning process of each, default this one)."""
    return Mesh(list(devices), ("model",), ranks)


def _check_layout(qt: QuantTensor) -> None:
    if qt.layout not in _N_LAST_LAYOUTS:
        raise NotImplementedError(f"TP sharding needs an N-last matmul layout, got {qt.layout!r}")


def _stack_qt(qt: QuantTensor, tp: int) -> list[QuantTensor]:
    """[rows, N] planes -> tp shards of [rows, N/tp] (whole output columns),
    each plane a contiguous copy."""
    n, k = qt.shape
    if n % tp:
        raise ValueError(f"output dim {n} not divisible by tp={tp}")
    _check_layout(qt)
    w = n // tp

    def cut(plane, i):
        return None if plane is None else plane[:, i * w: (i + 1) * w].contiguous()

    return [QuantTensor(**{f: cut(getattr(qt, f), i) for f in PLANES}, qtype=qt.qtype,
                        shape=(w, k), layout=qt.layout) for i in range(tp)]


def _stack_dense(w: torch.Tensor, tp: int) -> list[torch.Tensor]:
    """[N, K] dense or [N] bias -> tp shards of [N/tp, ...]."""
    if w.shape[0] % tp:
        raise ValueError(f"output dim {w.shape[0]} not divisible by tp={tp}")
    return [p.contiguous() for p in w.split(w.shape[0] // tp)]


def _qkv_segs(cfg: ModelConfig) -> tuple[int, int, int]:
    kv_dim = cfg.n_kv_heads * cfg.head_dim
    return (cfg.n_heads * cfg.head_dim, kv_dim, kv_dim)


def _seg_bounds(segs, n: int, tp: int) -> np.ndarray:
    bounds = np.cumsum([0, *segs])
    if bounds[-1] != n or any(s % tp for s in segs):
        raise ValueError(f"segments {tuple(segs)} of {n} rows do not split {tp} ways")
    return bounds


def _stack_dense_segs(w: torch.Tensor, tp: int, segs) -> list[torch.Tensor]:
    """Fused [Q;K;V] (or [gate;up]) rows -> tp shards of (q+k+v)/tp rows:
    split each segment by tp, re-fuse per shard in segment order."""
    b = _seg_bounds(segs, w.shape[0], tp)
    parts = [_stack_dense(w[b[i]: b[i + 1]], tp) for i in range(len(segs))]
    return [torch.cat([parts[s][i] for s in range(len(segs))], dim=0) for i in range(tp)]


def _stack_qt_segs(qt: QuantTensor, tp: int, segs) -> list[QuantTensor]:
    """Fused-segment QuantTensor: every plane is [rows_k, N]; the N axis
    splits per segment and re-fuses per shard, scale and bias planes
    alongside."""
    n, k = qt.shape
    b = _seg_bounds(segs, n, tp)
    _check_layout(qt)

    def cut(plane, i):
        if plane is None:
            return None
        return torch.cat([plane[:, b[s] + i * (b[s + 1] - b[s]) // tp:
                                b[s] + (i + 1) * (b[s + 1] - b[s]) // tp]
                          for s in range(len(segs))], dim=1).contiguous()

    return [QuantTensor(**{f: cut(getattr(qt, f), i) for f in PLANES}, qtype=qt.qtype,
                        shape=(n // tp, k), layout=qt.layout) for i in range(tp)]


def _shard_leaf(slot: str, w, tp: int, cfg: ModelConfig | None = None):
    """Returns (the tp shards, True) for a sharded slot, else (w, False)."""
    if slot in _FUSED_QKV or slot == "wgu":
        segs = (cfg.n_ff, cfg.n_ff) if slot == "wgu" else _qkv_segs(cfg)
        if isinstance(w, QuantTensor):
            return _stack_qt_segs(w, tp, segs), True
        return _stack_dense_segs(w, tp, segs), True
    if slot in _SHARD_W:
        if isinstance(w, QuantTensor):
            return _stack_qt(w, tp), True
        return _stack_dense(w, tp), True
    if slot in _SHARD_B:
        return _stack_dense(w, tp), True
    return w, False


def shard_params(params, cfg: ModelConfig, mesh: Mesh) -> tuple[list[dict], dict]:
    """Shard a loaded params tree over mesh axis 'model'.

    Returns (one param tree per local shard, each on its shard's device;
    specs): specs matches the tree with True where a leaf is sharded (the
    counterpart of the JAX package's PartitionSpec tree)."""
    tp = mesh.shape["model"]
    stacked, specs = {}, {}
    for key, v in params.items():
        if key == "layers":
            stacked["layers"], specs["layers"] = [], []
            for lp in v:
                pairs = {slot: _shard_leaf(slot, w, tp, cfg) for slot, w in lp.items()}
                stacked["layers"].append({s: p[0] for s, p in pairs.items()})
                specs["layers"].append({s: p[1] for s, p in pairs.items()})
        else:
            stacked[key], specs[key] = _shard_leaf(key, v, tp, cfg)
    shards = [_params_to(unstack_local(stacked, specs, mesh.index(c, "model")), dev)
              for c, dev in zip(mesh.local, mesh.local_devices)]
    return shards, specs


def unstack_local(params, specs, shard: int):
    """Shard `shard`'s tree: each sharded leaf's entry `shard`, the
    replicated leaves as they are (the JAX package squeezes its local
    [1, ...] shard axis inside shard_map)."""
    out = {k: (v[shard] if specs[k] else v) for k, v in params.items() if k != "layers"}
    out["layers"] = [{s: (w[shard] if sl[s] else w) for s, w in lp.items()}
                     for lp, sl in zip(params["layers"], specs["layers"])]
    return out


# -- sharded KV cache --------------------------------------------------------


def cache_spec() -> dict[str, int | None]:
    """The dim each KVCache field is sharded along (None: replicated): K
    and V [L, KVH, C, D] over heads, the cell metadata replicated."""
    return {"k": 1, "v": 1, "pos": None, "seq": None}


def shard_cache(cache: kv.KVCache, mesh: Mesh) -> list[kv.KVCache]:
    """One cache slab per local shard, on its device: its block of the KV
    heads and its own copy of the metadata (seq ops update each shard's
    slab in place, so no two shards may share a tensor)."""
    tp = mesh.shape["model"]
    out = []
    for c, dev in zip(mesh.local, mesh.local_devices):
        i = mesh.index(c, "model")
        fields = {}
        for name, dim in cache_spec().items():
            t = getattr(cache, name)
            if dim is not None:
                w = t.shape[dim] // tp
                t = t.narrow(dim, i * w, w)
            fields[name] = t.to(dev, copy=True).contiguous()
        out.append(kv.KVCache(**fields, hot=cache.hot))
    return out


# -- step builders -----------------------------------------------------------


@functools.lru_cache(maxsize=64)
def build_tp_step(cfg: ModelConfig, topk: int | None, mesh: Mesh):
    """The one-stage TP step: fn(shards, caches, tokens, pos, seq, cell_idx,
    valid, seq_bits) -> logits [T, V] (or the sparse pack with topk) on the
    first local shard's device. The JAX package jits a shard_map; here the
    shards' kernels are launched in turn on each device's current stream.
    Cached per (config, topk, mesh), as the JAX package caches its jitted
    steps, so a decode step does not rebuild the shard-local config."""
    lcfg = staged.local_cfg(cfg, mesh.shape["model"])

    def step(shards, caches, tokens, pos, seq, cell_idx, valid, seq_bits):
        return staged.stage_forward_tp(shards, lcfg, caches, tokens, pos, seq, cell_idx, valid,
                                       seq_bits, first=True, last=True, topk=topk, mesh=mesh)

    return step


def build_tp_chain(cfg: ModelConfig, depth: int, n_cand: int, mesh: Mesh,
                   samp: tuple | None = None):
    """The TP draft chain: fn(shards, caches, root, pos0, seq_id, cells,
    gen) -> (tokens int32 [depth], packs), the decode steps of
    runtime.context.chain_loop (greedy, n_cand = 0 or the `samp` Gumbel
    draws from `gen`) each run as a TP step. Every shard computes the same
    logits row; the next token is taken from the first local shard's copy
    and handed to every shard."""
    from ..runtime.context import chain_loop

    lcfg = staged.local_cfg(cfg, mesh.shape["model"])

    def chain(shards, caches, root, pos0, seq_id, cells, gen=None):
        def logits(tok, pos, seq, cell, one):
            return staged.stage_forward_tp(shards, lcfg, caches, tok, pos, seq, cell, one, None,
                                           first=True, last=True, topk=None, mesh=mesh)

        return chain_loop(logits, mesh.local_devices[0], root, pos0, seq_id, cells, depth,
                          samp, gen, n_cand)

    return chain
