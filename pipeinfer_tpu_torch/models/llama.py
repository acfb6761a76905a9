"""Llama-family forward pass.

Torch counterpart of pipeinfer_tpu.models.llama (ref: llama.cpp:3872-3984
`llm_build_llama`): RMSNorm -> GQA attention with adjacent-pair RoPE ->
residual -> RMSNorm -> SwiGLU FFN -> residual, with K/V written into the
sequence-aware cell cache and tree-attention masking.

Weights are QuantTensors (the i4g / i8g kernels) or dense tensors. The
cache is updated IN PLACE (the JAX package donated it through jit); the
forward returns the same cache object it was given.
"""

from __future__ import annotations

from typing import Any

import torch

from ..ops import layers as L
from ..ops.qmatmul import QuantTensor, dequant_rows, qmatmul
from ..runtime import kv_cache as kv
from .config import ModelConfig

Params = dict[str, Any]


def linear(x: torch.Tensor, w, bias=None) -> torch.Tensor:
    """x [T, K] @ W[N, K]^T (+ bias) for QuantTensor or dense weights."""
    if isinstance(w, QuantTensor):
        y = qmatmul(x, w)
    else:
        # in the weight's precision, accumulated in f32 (f32 reference
        # models stay exact)
        y = (x.to(w.dtype) @ w.T).float()
    if bias is not None:
        y = y + bias.float()
    return y


def embed(tokens: torch.Tensor, w) -> torch.Tensor:
    if isinstance(w, QuantTensor):
        return dequant_rows(w, tokens, torch.float32)
    return w[tokens.long()].float()


def rope_kwargs(cfg: ModelConfig) -> dict:
    """apply_rope's keyword arguments for a config."""
    return dict(
        mode=cfg.rope_mode,
        freq_base=cfg.rope_base,
        freq_scale=cfg.rope_scale,
        yarn_ext_factor=cfg.yarn_ext_factor,
        yarn_attn_factor=cfg.yarn_attn_factor,
        yarn_beta_fast=cfg.yarn_beta_fast,
        yarn_beta_slow=cfg.yarn_beta_slow,
        n_orig_ctx=cfg.n_ctx_orig or cfg.n_ctx_train,
    )


def forward(
    params: Params,
    cfg: ModelConfig,
    cache: kv.KVCache,
    tokens: torch.Tensor,  # int32 [T]
    pos: torch.Tensor,  # int32 [T]
    seq: torch.Tensor,  # int32 [T] primary sequence slot per token
    cell_idx: torch.Tensor,  # int32 [T] destination cache cells
    valid: torch.Tensor,  # bool [T] false for padding
    seq_bits: torch.Tensor | None = None,  # int32 [T, SEQ_WORDS] membership
    output_hidden: bool = False,  # return normed hidden states, not logits
    embd: torch.Tensor | None = None,  # f32 [T, E]: direct embedding input
    # (the llama_batch.embd path, ref llama.h: multimodal image tokens)
) -> tuple[torch.Tensor, kv.KVCache]:
    """One decode/prefill step. Returns (logits [T, n_vocab] f32, cache)."""
    t = tokens.shape[0]
    h = embed(tokens, params["tok_embd"]) if embd is None else embd.float()

    # claim cells + mask once for all layers
    kv.write_meta(cache, cell_idx, pos, seq, valid, seq_bits)
    mask = kv.attn_mask(cache, pos, seq)
    mask = torch.where(valid[:, None], mask, kv.MASK_VALUE)

    rope_kw = rope_kwargs(cfg)

    n_embd_q = cfg.n_heads * cfg.head_dim
    kv_dim = cfg.n_kv_heads * cfg.head_dim
    for li, lp in enumerate(params["layers"]):
        a = L.rms_norm(h, lp["attn_norm"], cfg.norm_eps)
        if "wqkv" in lp:  # load-time fused projections (one kernel call)
            qkv = linear(a, lp["wqkv"])
            q = qkv[:, :n_embd_q].reshape(t, cfg.n_heads, cfg.head_dim)
            k = qkv[:, n_embd_q: n_embd_q + kv_dim].reshape(t, cfg.n_kv_heads, cfg.head_dim)
            v = qkv[:, n_embd_q + kv_dim:].reshape(t, cfg.n_kv_heads, cfg.head_dim)
        else:
            q = linear(a, lp["wq"]).reshape(t, cfg.n_heads, cfg.head_dim)
            k = linear(a, lp["wk"]).reshape(t, cfg.n_kv_heads, cfg.head_dim)
            v = linear(a, lp["wv"]).reshape(t, cfg.n_kv_heads, cfg.head_dim)
        if cfg.rope_mode != "none":
            q = L.apply_rope(q, pos, cfg.rope_dims, **rope_kw)
            k = L.apply_rope(k, pos, cfg.rope_dims, **rope_kw)
        kv.write_tokens(cache, li, cell_idx, k, v)
        attn = kv.attend(q, cache, li, mask, pos, seq, valid, scale=cfg.attn_scale)
        h = h + linear(attn.reshape(t, n_embd_q), lp["wo"])

        f = L.rms_norm(h, lp["ffn_norm"], cfg.norm_eps)
        if "wgu" in lp:
            gu = linear(f, lp["wgu"])
            half = gu.shape[1] // 2
            gate = L.silu(gu[:, :half])
            up = gu[:, half:]
        else:
            gate = L.silu(linear(f, lp["w_gate"]))
            up = linear(f, lp["w_up"])
        h = h + linear(gate * up, lp["w_down"])

    out = L.rms_norm(h, params["output_norm"], cfg.norm_eps)
    if output_hidden:
        return out.float(), cache
    return linear(out, params["output"]).float(), cache
