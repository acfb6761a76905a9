"""Stage-sliced decoder forward for the host-driven pipeline.

Torch counterpart of pipeinfer_tpu.models.staged. The model is cut into
layer ranges (the --mpi-layer-split counterpart, ref: ggml-mpi.c:523-587);
each stage runs its slab over its own cache. Stage 0 embeds (+ bloom's
token-embedding norm, starcoder's learned positions), the last stage
applies the final norm and the head (and the packed sparse-logits head);
middle stages map hidden states to hidden states, handed on in f32 as the
reference relays them (ref: ggml-mpi.c:451-487, :710-721).

All nine architectures run through the shared trait-driven layer body
(models.generic.layer_step). The JAX package's tensor-parallel stages are
not ported (ROADMAP.md queue 1, "Multi-device").
"""

from __future__ import annotations

import torch

from ..runtime import kv_cache as kv
from ..runtime.context import sparse_pack
from .config import ModelConfig
from .generic import _norm, layer_step, slopes_for
from .llama import embed, linear, rope_kwargs


def stage_forward(stage_params, cfg: ModelConfig, cache: kv.KVCache, x, pos, seq, cell_idx, valid,
                  seq_bits, *, first: bool, last: bool, topk: int | None,
                  output_hidden: bool = False) -> torch.Tensor:
    """One stage of one step. x: int32 tokens [T] (first stage) or f32
    hidden [T, E]. Returns f32 hidden [T, E] (not last), logits [T,
    n_vocab] or, with topk, the packed sparse head [T, 2*topk+1]; the last
    stage with output_hidden returns the output-normed hidden states [T,
    E] f32 instead of logits. The stage's cache is updated in place."""
    if first:
        h = embed(x, stage_params["tok_embd"])
        if cfg.tok_norm:
            h = _norm(h, stage_params["tok_norm"], stage_params.get("tok_norm_b"), cfg)
        if cfg.pos_embd:
            h = h + stage_params["pos_embd"][pos.long()].to(h.dtype)
    else:
        h = x.float()

    kv.write_meta(cache, cell_idx, pos, seq, valid, seq_bits)
    mask = kv.attn_mask(cache, pos, seq)
    mask = torch.where(valid[:, None], mask, kv.MASK_VALUE)

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


def local_cfg(cfg: ModelConfig, tp: int) -> ModelConfig:
    """The shard-local view of the config under tp-way tensor parallelism:
    the config itself at tp = 1, the only width the port runs."""
    if tp != 1:
        raise NotImplementedError(
            f'tensor-parallel stages (tp={tp}) are not ported: ROADMAP.md queue 1, "Multi-device"')
    return cfg
