"""Generic multi-architecture decoder forward.

Torch counterpart of pipeinfer_tpu.models.generic: one configurable layer
covering the reference's non-llama graph functions (ref: llama.cpp
build_falcon :4106, build_starcoder :4229, build_persimmon :4329,
build_refact :4540, build_bloom :4632, build_mpt :4727, build_stablelm
:4827, build_baichuan :3985), driven by trait fields on ModelConfig:

- norm_rms / layernorm (+biases), embedding norm (bloom tok_norm),
  learned absolute positions (starcoder pos_embd);
- fused attn_qkv (+clamp for mpt) or split wq/wk/wv; optional Q/K
  layernorm (persimmon);
- RoPE norm/neox/partial (stablelm/persimmon n_rot) or ALiBi
  (mpt/bloom/refact/baichuan-13b) with ggml slope bucketing, fused into
  the cell-attention kernel on the card;
- parallel residual with FFN fed from the attention norm (falcon) or
  sequential residual with its own ffn_norm;
- gated SiLU (llama family), exact-erf GELU or relu-squared FFN, with
  biases.

Under tensor parallelism (parallel/tp.py) ``layer_step_tp`` runs the same
body over a mesh's local shards, each with a shard-local config (heads
divided by tp) and output-sharded weights, and re-assembles the
activations with tiled all-gathers where the JAX package's ``tp_axis``
branches do. The cache is updated in place, as in models/llama.py.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from ..ops import layers as L
from ..runtime import kv_cache as kv
from .config import ModelConfig
from .llama import Params, linear


def _norm(x, w, b, cfg: ModelConfig):
    if cfg.norm_rms:
        return L.rms_norm(x, w, cfg.norm_eps)
    return L.layer_norm(x, w, b, cfg.norm_eps)


def slopes_for(cfg: ModelConfig, device: torch.device, tp: int = 1,
               shard: int = 0) -> torch.Tensor | None:
    """The ALiBi slopes [H] on `device`, or None for a model without ALiBi.
    Under tp-way tensor parallelism cfg is shard-local and the slopes are
    shard `shard`'s block of the tp * H global heads' (the JAX package's
    dynamic_slice of the full table, models/staged.py:62-70). Made once
    per (heads, bias, shard, device): a fresh upload from host memory each
    step would wait for the work queued before it."""
    if cfg.max_alibi_bias <= 0:
        return None
    return _slopes(cfg.n_heads, cfg.max_alibi_bias, tp, shard, str(device))


@functools.lru_cache(maxsize=64)
def _slopes(n_heads: int, max_bias: float, tp: int, shard: int, device: str) -> torch.Tensor:
    full = kv.alibi_slopes(n_heads * tp, max_bias, device=device)
    return full[shard * n_heads: (shard + 1) * n_heads].contiguous()


def _attention(h, lp, li, cfg: ModelConfig, cache: kv.KVCache, cell_idx, mask, pos, seq, valid,
               rope_kw, slopes):
    """A layer's attention up to its output projection, on hidden h [T, E]:
    (the attention norm's output [T, E], the attention [T, H * D] over the
    heads of cfg)."""
    t = h.shape[0]
    kv_dim = cfg.n_kv_heads * cfg.head_dim

    attn_norm_out = _norm(h, lp["attn_norm"], lp.get("attn_norm_b"), cfg)
    if "attn_norm_2" in lp:  # falcon-40B: a separate norm feeds attention
        a = _norm(h, lp["attn_norm_2"], lp.get("attn_norm_2_b"), cfg)
    else:
        a = attn_norm_out

    if "wqkv" in lp:
        qkv = linear(a, lp["wqkv"], lp.get("bqkv"))
        if cfg.clamp_kqv > 0:
            qkv = qkv.clamp(-cfg.clamp_kqv, cfg.clamp_kqv)
        n_embd_q = cfg.n_heads * cfg.head_dim
        q = qkv[:, :n_embd_q]
        k = qkv[:, n_embd_q: n_embd_q + kv_dim]
        v = qkv[:, n_embd_q + kv_dim: n_embd_q + 2 * kv_dim]
    else:
        q = linear(a, lp["wq"], lp.get("bq"))
        k = linear(a, lp["wk"], lp.get("bk"))
        v = linear(a, lp["wv"], lp.get("bv"))
    q = q.reshape(t, cfg.n_heads, cfg.head_dim)
    k = k.reshape(t, cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(t, cfg.n_kv_heads, cfg.head_dim)

    if "q_norm" in lp:  # persimmon Q/K layernorm
        q = L.layer_norm(q, lp["q_norm"], lp.get("q_norm_b"), cfg.norm_eps)
        k = L.layer_norm(k, lp["k_norm"], lp.get("k_norm_b"), cfg.norm_eps)

    if cfg.rope_mode != "none":
        q = L.apply_rope(q, pos, cfg.rope_dims, **rope_kw)
        k = L.apply_rope(k, pos, cfg.rope_dims, **rope_kw)

    kv.write_tokens(cache, li, cell_idx, k, v)
    attn = kv.attend(q, cache, li, mask, pos, seq, valid, scale=cfg.attn_scale, alibi=slopes)
    return attn_norm_out, attn.reshape(t, cfg.n_heads * cfg.head_dim)


def layer_step(h, lp, li, cfg: ModelConfig, cache: kv.KVCache, cell_idx, mask, pos, seq, valid,
               rope_kw, slopes):
    """One decoder layer on hidden h [T, E]: the trait-driven body shared
    by the single-device forward and the staged pipeline. Returns h."""
    attn_norm_out, attn = _attention(h, lp, li, cfg, cache, cell_idx, mask, pos, seq, valid,
                                     rope_kw, slopes)
    attn_out = linear(attn, lp["wo"], lp.get("bo"))

    if cfg.parallel_residual:
        # falcon: the FFN reads the attention norm's output; both add to the input
        return h + attn_out + _ffn(attn_norm_out, lp, cfg)
    h = h + attn_out
    f_in = _norm(h, lp["ffn_norm"], lp.get("ffn_norm_b"), cfg)
    return h + _ffn(f_in, lp, cfg)


def layer_step_tp(hs: list, lps: list, li, cfg: ModelConfig, caches: list, ins: list, rope_kw,
                  slopes: list, mesh) -> list:
    """layer_step over the local shards of `mesh`'s 'model' axis (the JAX
    package's tp_axis branches, pipeinfer_tpu/models/generic.py:102-108
    and :190-194). cfg is shard-local; per shard: hidden hs[i] [T, E]
    (replicated), layer weights lps[i] (every weight output-sharded),
    cache slab caches[i] (its heads), ins[i] = (cell_idx, mask, pos, seq,
    valid) and slopes[i]. The attention and the FFN's middle are gathered
    before their output-sharded projections and the projections after
    them. Returns the new hidden states, one per shard."""
    def gathered(xs):
        return mesh.all_gather(xs, "model", dim=1)

    parts = [_attention(h, lp, li, cfg, c, *i, rope_kw, s)
             for h, lp, c, i, s in zip(hs, lps, caches, ins, slopes)]
    attn = gathered([a for _, a in parts])
    attn_out = gathered([linear(a, lp["wo"], lp.get("bo")) for a, lp in zip(attn, lps)])

    def ffn(xs):
        mid = gathered([_ffn_mid(x, lp, cfg) for x, lp in zip(xs, lps)])
        return gathered([linear(m, lp["w_down"], lp.get("b_down")) for m, lp in zip(mid, lps)])

    if cfg.parallel_residual:
        f = ffn([n for n, _ in parts])
        return [h + a + x for h, a, x in zip(hs, attn_out, f)]
    hs = [h + a for h, a in zip(hs, attn_out)]
    f = ffn([_norm(h, lp["ffn_norm"], lp.get("ffn_norm_b"), cfg) for h, lp in zip(hs, lps)])
    return [h + x for h, x in zip(hs, f)]


def forward(
    params: Params,
    cfg: ModelConfig,
    cache: kv.KVCache,
    tokens: torch.Tensor,  # int32 [T]
    pos: torch.Tensor,  # int32 [T]
    seq: torch.Tensor,  # int32 [T]
    cell_idx: torch.Tensor,  # int32 [T]
    valid: torch.Tensor,  # bool [T]
    seq_bits: torch.Tensor | None = None,
    output_hidden: bool = False,  # return normed hidden states, not logits
) -> tuple[torch.Tensor, kv.KVCache]:
    """One decode/prefill step of any architecture: the pipeline's one
    stage that is both first and last. Returns (logits [T, n_vocab] f32,
    or the output-normed hidden states [T, E] f32 with output_hidden,
    cache)."""
    from .staged import stage_forward  # staged builds on layer_step above

    return stage_forward(params, cfg, cache, tokens, pos, seq, cell_idx, valid, seq_bits,
                         first=True, last=True, topk=None, output_hidden=output_hidden), cache


def _ffn(x, lp, cfg: ModelConfig):
    """ref: llm_build_ffn (llama.cpp:3637-3700): gated SiLU, sequential
    exact-erf GELU, or relu-squared (persimmon LLM_FFN_RELU_SQR)."""
    return linear(_ffn_mid(x, lp, cfg), lp["w_down"], lp.get("b_down"))


def _ffn_mid(x, lp, cfg: ModelConfig):
    """The FFN up to w_down: the activation of the up projection."""
    if "wgu" in lp:  # load-time fused gate+up (one kernel call); split at
        #              the actual half-width: a TP shard's wgu is 2*n_ff/tp wide
        gu = linear(x, lp["wgu"])
        half = gu.shape[1] // 2
        mid = L.silu(gu[:, :half]) * gu[:, half:]
    else:
        up = linear(x, lp["w_up"], lp.get("b_up"))
        if "w_gate" in lp:
            mid = L.silu(linear(x, lp["w_gate"], lp.get("b_gate"))) * up
        elif cfg.ffn_act == "relu2":
            r = up.float().clamp_min(0.0)
            mid = (r * r).to(up.dtype)
        else:
            mid = F.gelu(up.float(), approximate="none").to(up.dtype)
    return mid
