"""Differentiable batched training forward for the llama family.

Port of pipeinfer_tpu.models.train (ref: common/train.cpp +
examples/finetune / train-text-from-scratch): a pure [B, T] causal forward
over dense f32 weights, recomputed per layer in the backward pass
(torch.utils.checkpoint, the counterpart of jax.checkpoint) so activations
stay small, no KV cache. The products are torch matmuls on both devices:
the JAX training forward calls no Pallas kernel, and no kernel has a
backward. TF32 is left at PyTorch's default (off), so the card computes in
true f32 as the CPU does.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..ops import layers as L
from .config import ModelConfig


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [M, K] @ W[N, K]^T: every product of the training forward."""
    return x @ w.T


def causal_mask(t: int, device) -> torch.Tensor:
    """[t, t] additive mask: 0 on and below the diagonal, -1e9 above."""
    keep = torch.tril(torch.ones((t, t), dtype=torch.bool, device=device))
    return torch.where(keep, 0.0, -1e9)


def rope_tables(cfg: ModelConfig, t: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) [t, rope_dims // 2] of positions 0..t-1, in f32."""
    half = cfg.rope_dims // 2
    inv_freq = cfg.rope_base ** (-2.0 * torch.arange(half, device=device) / cfg.rope_dims)
    pos = torch.arange(t, device=device, dtype=torch.float32)
    theta = pos[:, None] * inv_freq[None, :] * cfg.rope_scale
    return torch.cos(theta), torch.sin(theta)


def _layer(h, lp, cfg: ModelConfig, cos, sin, mask):
    b, t, e = h.shape
    a = L.rms_norm(h, lp["attn_norm"], cfg.norm_eps)
    af = a.reshape(b * t, e)
    q = _mm(af, lp["wq"]).reshape(b, t, cfg.n_heads, cfg.head_dim)
    k = _mm(af, lp["wk"]).reshape(b, t, cfg.n_kv_heads, cfg.head_dim)
    v = _mm(af, lp["wv"]).reshape(b, t, cfg.n_kv_heads, cfg.head_dim)
    q = _rope(q, cos, sin)
    k = _rope(k, cos, sin)
    gsize = cfg.n_heads // cfg.n_kv_heads
    qg = q.reshape(b, t, cfg.n_kv_heads, gsize, cfg.head_dim)
    scores = torch.einsum("bikgd,bjkd->bkgij", qg, k) * cfg.attn_scale
    scores = scores + mask[None, None, None, :, :]
    p = torch.softmax(scores, dim=-1)
    attn = torch.einsum("bkgij,bjkd->bikgd", p, v).reshape(b * t, cfg.n_heads * cfg.head_dim)
    h = h + _mm(attn, lp["wo"]).reshape(b, t, e)
    f = L.rms_norm(h, lp["ffn_norm"], cfg.norm_eps).reshape(b * t, e)
    gate = L.silu(_mm(f, lp["w_gate"]))
    up = _mm(f, lp["w_up"])
    h = h + _mm(gate * up, lp["w_down"]).reshape(b, t, e)
    return h


def _rope(x, cos, sin):
    # adjacent-pair (ggml "norm") rotation, batched
    b, t, hh, d = x.shape
    x0 = x[..., 0::2]
    x1 = x[..., 1::2]
    c = cos[None, :, None, :]
    s = sin[None, :, None, :]
    r0 = x0 * c - x1 * s
    r1 = x0 * s + x1 * c
    return torch.stack([r0, r1], dim=-1).reshape(b, t, hh, d)


def forward_train(params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    """tokens [B, T] -> logits [B, T, V] (f32, fully differentiable)."""
    b, t = tokens.shape
    dev = params["tok_embd"].device
    h = params["tok_embd"][tokens.to(dev).long()]
    cos, sin = rope_tables(cfg, t, dev)
    mask = causal_mask(t, dev)
    for lp in params["layers"]:
        h = checkpoint(_layer, h, lp, cfg, cos, sin, mask, use_reentrant=False)
    out = L.rms_norm(h, params["output_norm"], cfg.norm_eps)
    return _mm(out.reshape(b * t, -1), params["output"]).reshape(b, t, -1)


def lm_loss(params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    """Causal next-token cross-entropy."""
    tokens = tokens.to(params["tok_embd"].device).long()
    logits = forward_train(params, cfg, tokens[:, :-1])
    targets = tokens[:, 1:]
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.take_along_dim(logp, targets[..., None], dim=-1)[..., 0]
    return nll.mean()
