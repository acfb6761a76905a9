"""Transformer layer primitives: norms, RoPE, activation glue.

Torch counterpart of pipeinfer_tpu.ops.layers with the same ggml numerics:

- RMSNorm in float32 with eps inside the rsqrt (ggml_rms_norm);
- RoPE "norm" mode rotates adjacent pairs (x[2i], x[2i+1]); "neox" mode
  rotates (x[i], x[i+d/2]) halves;
- linear rope scaling via freq_scale, NTK via freq_base, YaRN ramp per ggml
  rope_yarn.
"""

from __future__ import annotations

import math

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps) * weight.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def _rope_angles(
    pos: torch.Tensor,  # [T] int32
    n_dims: int,
    freq_base: float,
    freq_scale: float,
    *,
    yarn_ext_factor: float = 0.0,
    yarn_attn_factor: float = 1.0,
    yarn_beta_fast: float = 32.0,
    yarn_beta_slow: float = 1.0,
    n_orig_ctx: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables [T, n_dims/2] with linear + YaRN scaling
    (ref: ggml.c rope_yarn / ggml_rope_yarn_corr_dims)."""
    half = n_dims // 2
    idx = torch.arange(half, dtype=torch.float32, device=pos.device)
    inv_freq = freq_base ** (-2.0 * idx / n_dims)
    theta_extrap = pos.float()[:, None] * inv_freq[None, :]
    mscale = yarn_attn_factor
    if yarn_ext_factor != 0.0 and n_orig_ctx > 0:
        def corr_dim(n_rot):
            return (n_dims * math.log(n_orig_ctx / (n_rot * 2 * math.pi))) / (
                2 * math.log(freq_base)
            )

        low = max(0.0, math.floor(corr_dim(yarn_beta_fast)))
        high = min(half * 2 - 1.0, math.ceil(corr_dim(yarn_beta_slow)))
        ramp = ((idx - low) / max(high - low, 1e-3)).clamp(0.0, 1.0)
        ramp_mix = (1.0 - ramp) * yarn_ext_factor
        theta_interp = freq_scale * theta_extrap
        theta = theta_interp * (1.0 - ramp_mix) + theta_extrap * ramp_mix
        mscale = yarn_attn_factor * (1.0 + 0.1 * math.log(1.0 / freq_scale))
    else:
        theta = freq_scale * theta_extrap
    return torch.cos(theta) * mscale, torch.sin(theta) * mscale


def apply_rope(
    x: torch.Tensor,  # [T, H, D]
    pos: torch.Tensor,  # [T]
    n_dims: int | None = None,
    *,
    mode: str = "norm",
    freq_base: float = 10000.0,
    freq_scale: float = 1.0,
    **yarn,
) -> torch.Tensor:
    """Rotate the first n_dims of each head. mode="norm": adjacent pairs
    (ggml llama convention); mode="neox": split halves."""
    t, h, d = x.shape
    if n_dims is None:
        n_dims = d
    cos, sin = _rope_angles(pos, n_dims, freq_base, freq_scale, **yarn)
    cos = cos[:, None, :]
    sin = sin[:, None, :]
    xf = x.float()
    rot, rest = xf[..., :n_dims], xf[..., n_dims:]
    if mode == "norm":
        x0 = rot[..., 0::2]
        x1 = rot[..., 1::2]
        out = torch.stack([x0 * cos - x1 * sin, x0 * sin + x1 * cos], dim=-1)
        out = out.reshape(t, h, n_dims)
    elif mode == "neox":
        half = n_dims // 2
        x0 = rot[..., :half]
        x1 = rot[..., half:]
        out = torch.cat([x0 * cos - x1 * sin, x0 * sin + x1 * cos], dim=-1)
    else:
        raise ValueError(f"unknown rope mode {mode}")
    if rest.shape[-1]:
        out = torch.cat([out, rest], dim=-1)
    return out.to(x.dtype)
