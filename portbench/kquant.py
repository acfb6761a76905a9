"""Q4_K and Q6_K encoders in plain torch, run where the weights are made.

The benchmark draws its weights on the card and stores them as ggml k-quant
payloads (``block_q4_K``: 144 bytes, ``block_q6_K``: 210 bytes per 256
values), the bytes that both the program and the reference read. The
encoders are direct: per 32-value sub-block a min/max affine grid for Q4_K,
per 16-value sub-block an absmax grid for Q6_K, with the block scales
rounded to f16 before the sub-block scales are fitted to them. They are not
llama.cpp's search, and need not be: any valid payload is a weight, and the
reference decodes the bytes themselves.
"""

from __future__ import annotations

import torch

QK_K = 256
Q4_K_BYTES = 144
Q6_K_BYTES = 210


def _f16_bytes(x: torch.Tensor) -> torch.Tensor:
    """f16 values [nb] -> their little-endian bytes [nb, 2] uint8."""
    return x.to(torch.float16).contiguous().view(torch.uint8).reshape(-1, 2)


def _inv(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x > 0, 1.0 / torch.where(x > 0, x, torch.ones_like(x)), torch.zeros_like(x))


def encode_q4_k(w: torch.Tensor) -> torch.Tensor:
    """w f32 [N, K] (K % 256 == 0) -> Q4_K payload uint8 [N, K / 256 * 144]."""
    n, k = w.shape
    x = w.float().reshape(-1, 8, 32)  # [nb, sub-block, value]
    nb = x.shape[0]
    gmin = x.amin(dim=2).clamp_max(0.0)
    sc_f = (x.amax(dim=2) - gmin).clamp_min(0.0) / 15.0
    m_f = -gmin
    d = (sc_f.amax(dim=1) / 63.0).half().float()
    dmin = (m_f.amax(dim=1) / 63.0).half().float()
    sc = torch.round(sc_f * _inv(d)[:, None]).clamp(0, 63)
    m = torch.round(m_f * _inv(dmin)[:, None]).clamp(0, 63)
    step = d[:, None] * sc
    q = torch.round((x + (dmin[:, None] * m)[:, :, None]) * _inv(step)[:, :, None]).clamp(0, 15)
    sc, m, q = sc.to(torch.uint8), m.to(torch.uint8), q.to(torch.uint8)

    out = torch.empty(nb, Q4_K_BYTES, dtype=torch.uint8, device=w.device)
    out[:, 0:2] = _f16_bytes(d)
    out[:, 2:4] = _f16_bytes(dmin)
    # get_scale_min_k4's 6-bit packing (ggml-quants.c)
    out[:, 0 + 4:4 + 4] = (sc[:, :4] & 63) | ((sc[:, 4:] >> 4) << 6)
    out[:, 4 + 4:8 + 4] = (m[:, :4] & 63) | ((m[:, 4:] >> 4) << 6)
    out[:, 8 + 4:12 + 4] = (sc[:, 4:] & 0xF) | ((m[:, 4:] & 0xF) << 4)
    q = q.reshape(nb, 4, 2, 32)  # 64-value chunks: sub-block 2j in the low nibbles
    out[:, 16:] = (q[:, :, 0] | (q[:, :, 1] << 4)).reshape(nb, 128)
    return out.reshape(n, k // QK_K * Q4_K_BYTES)


def encode_q6_k(w: torch.Tensor) -> torch.Tensor:
    """w f32 [N, K] (K % 256 == 0) -> Q6_K payload uint8 [N, K / 256 * 210]."""
    n, k = w.shape
    x = w.float().reshape(-1, 16, 16)
    nb = x.shape[0]
    sc_f = x.abs().amax(dim=2) / 31.0  # quants span [-32, 31]
    d = (sc_f.amax(dim=1) / 127.0).half().float()
    sc = torch.round(sc_f * _inv(d)[:, None]).clamp(0, 127)
    step = d[:, None] * sc
    q = (torch.round(x * _inv(step)[:, :, None]).clamp(-32, 31) + 32).to(torch.uint8)
    q = q.reshape(nb, 2, 4, 32)  # [block, half of 128, quarter of 32, value]

    out = torch.empty(nb, Q6_K_BYTES, dtype=torch.uint8, device=w.device)
    for half in range(2):
        g0, g1, g2, g3 = (q[:, half, j] for j in range(4))
        out[:, 64 * half:64 * half + 32] = (g0 & 0xF) | ((g2 & 0xF) << 4)
        out[:, 64 * half + 32:64 * half + 64] = (g1 & 0xF) | ((g3 & 0xF) << 4)
        out[:, 128 + 32 * half:128 + 32 * half + 32] = (
            (g0 >> 4) | ((g1 >> 4) << 2) | ((g2 >> 4) << 4) | ((g3 >> 4) << 6))
    out[:, 192:208] = sc.to(torch.int8).view(torch.uint8)
    out[:, 208:210] = _f16_bytes(d)
    return out.reshape(n, k // QK_K * Q6_K_BYTES)


ENCODERS = {"Q4_K": encode_q4_k, "Q6_K": encode_q6_k}
