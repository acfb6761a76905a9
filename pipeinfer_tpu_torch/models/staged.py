"""Stage-sliced decoder forward for the host-driven pipeline.

Torch counterpart of pipeinfer_tpu.models.staged. The model is cut into
layer ranges (the --mpi-layer-split counterpart, ref: ggml-mpi.c:523-587);
each stage runs its slab over its own cache. Stage 0 embeds (+ bloom's
token-embedding norm, starcoder's learned positions), the last stage
applies the final norm and the head (and the packed sparse-logits head);
middle stages map hidden states to hidden states, handed on in f32 as the
reference relays them (ref: ggml-mpi.c:451-487, :710-721).

All nine architectures run through the shared trait-driven layer body
(models.generic.layer_step). Under tensor parallelism a stage runs
stage_forward_tp over its sub-mesh's shards with a shard-local config
(local_cfg): models.generic.layer_step_tp between the gathers, the ALiBi
slopes cut per shard, and the vocab-sharded head gathered before the
sparse pack.
"""

from __future__ import annotations

import dataclasses

import torch

from ..runtime import kv_cache as kv
from ..runtime.context import sparse_pack
from .config import ModelConfig
from .generic import _norm, layer_step, layer_step_tp, slopes_for
from .llama import embed, linear, rope_kwargs


def stage_forward(stage_params, cfg: ModelConfig, cache: kv.KVCache, x, pos, seq, cell_idx, valid,
                  seq_bits, *, first: bool, last: bool, topk: int | None,
                  output_hidden: bool = False) -> torch.Tensor:
    """One stage of one step. x: int32 tokens [T] (first stage) or f32
    hidden [T, E]. Returns f32 hidden [T, E] (not last), logits [T,
    n_vocab] or, with topk, the packed sparse head [T, 2*topk+1]; the last
    stage with output_hidden returns the output-normed hidden states [T,
    E] f32 instead of logits. The stage's cache is updated in place."""
    h, mask = _stage_in(stage_params, cfg, cache, x, pos, seq, cell_idx, valid, seq_bits, first)
    slopes = slopes_for(cfg, h.device)
    rope_kw = rope_kwargs(cfg)
    for li, lp in enumerate(stage_params["layers"]):
        h = layer_step(h, lp, li, cfg, cache, cell_idx, mask, pos, seq, valid, rope_kw, slopes)

    if not last:
        return h.float()  # the f32 activation relay
    out = _norm(h, stage_params["output_norm"], stage_params.get("output_norm_b"), cfg)
    if output_hidden:
        return out.float()
    logits = linear(out, stage_params["output"]).float()
    return logits if topk is None else sparse_pack(logits, topk)


def _stage_in(sp, cfg: ModelConfig, cache: kv.KVCache, x, pos, seq, cell_idx, valid, seq_bits,
              first: bool):
    """A stage's input hidden states [T, E] f32 (embedded on the first
    stage) and its attention mask, after claiming the step's cells."""
    if first:
        h = embed(x, sp["tok_embd"])
        if cfg.tok_norm:
            h = _norm(h, sp["tok_norm"], sp.get("tok_norm_b"), cfg)
        if cfg.pos_embd:
            h = h + sp["pos_embd"][pos.long()].to(h.dtype)
    else:
        h = x.float()
    kv.write_meta(cache, cell_idx, pos, seq, valid, seq_bits)
    mask = kv.attn_mask(cache, pos, seq)
    return h, torch.where(valid[:, None], mask, kv.MASK_VALUE)


def stage_forward_tp(shard_params: list, cfg: ModelConfig, caches: list, x, pos, seq, cell_idx,
                     valid, seq_bits, *, first: bool, last: bool, topk: int | None, mesh,
                     output_hidden: bool = False) -> torch.Tensor:
    """stage_forward over the local shards of `mesh`'s 'model' axis: the
    JAX package's shard_map body (tp_axis="model"), written as a loop over
    the shards between the collectives. cfg is shard-local (local_cfg);
    shard_params[i] and caches[i] are shard i's (parallel.tp.shard_params,
    shard_cache). The inputs may lie on any device: each shard gets its
    own copy. Returns the first local shard's copy of the replicated
    output, as stage_forward returns it."""
    tp = mesh.shape["model"]
    ins = list(zip(*(mesh.replicate(a) for a in (x, pos, seq, cell_idx, valid, seq_bits))))
    hs, masks = zip(*(_stage_in(sp, cfg, c, *i, first)
                      for sp, c, i in zip(shard_params, caches, ins)))
    slopes = [slopes_for(cfg, dev, tp, mesh.index(c, "model"))
              for c, dev in zip(mesh.local, mesh.local_devices)]
    layer_ins = [(i[3], m, i[1], i[2], i[4]) for i, m in zip(ins, masks)]
    rope_kw = rope_kwargs(cfg)
    hs = list(hs)
    for li in range(len(shard_params[0]["layers"])):
        hs = layer_step_tp(hs, [sp["layers"][li] for sp in shard_params], li, cfg, caches,
                           layer_ins, rope_kw, slopes, mesh)
    if not last:
        return hs[0].float()
    out = [_norm(h, sp["output_norm"], sp.get("output_norm_b"), cfg)
           for h, sp in zip(hs, shard_params)]
    if output_hidden:
        return out[0].float()
    # the head is vocab-sharded: gather the full rows before the top-k pack
    logits = mesh.all_gather([linear(o, sp["output"]).float() for o, sp in zip(out, shard_params)],
                             "model", dim=1)[0]
    return logits if topk is None else sparse_pack(logits, topk)


def local_cfg(cfg: ModelConfig, tp: int) -> ModelConfig:
    """The shard-local view of the config under tp-way tensor parallelism:
    heads divided by tp (pipeinfer_tpu/models/staged.py:107-117)."""
    if tp == 1:
        return cfg
    if cfg.n_heads % tp or cfg.n_kv_heads % tp:
        raise ValueError(f"heads {cfg.n_heads}/{cfg.n_kv_heads} not divisible by tp={tp}")
    return dataclasses.replace(cfg, n_heads=cfg.n_heads // tp, n_kv_heads=cfg.n_kv_heads // tp)
