"""Q4_K and Q6_K decoders of the reference, in plain torch (ggml's
``dequantize_row_q4_K`` and ``dequantize_row_q6_K``)."""

from __future__ import annotations

import torch


def _f16(b: torch.Tensor) -> torch.Tensor:
    """[nb, 2] uint8 little-endian -> f32 [nb]."""
    return b.contiguous().view(torch.float16).reshape(-1).float()


def q4_k(raw: torch.Tensor, n: int, k: int) -> torch.Tensor:
    """Q4_K payload (uint8, N * K / 256 * 144 bytes) -> f32 [N, K]."""
    b = raw.reshape(-1, 144)
    d, dmin = _f16(b[:, 0:2]), _f16(b[:, 2:4])
    s = b[:, 4:16].int()
    sc = torch.cat([s[:, 0:4] & 63, (s[:, 8:12] & 0xF) | ((s[:, 0:4] >> 6) << 4)], dim=1)
    m = torch.cat([s[:, 4:8] & 63, (s[:, 8:12] >> 4) | ((s[:, 4:8] >> 6) << 4)], dim=1)
    qs = b[:, 16:].reshape(-1, 4, 32).int()
    q = torch.stack([qs & 0xF, qs >> 4], dim=2).reshape(-1, 8, 32).float()  # sub-block order
    y = (d[:, None] * sc.float())[:, :, None] * q - (dmin[:, None] * m.float())[:, :, None]
    return y.reshape(n, k)


def q6_k(raw: torch.Tensor, n: int, k: int) -> torch.Tensor:
    """Q6_K payload (uint8, N * K / 256 * 210 bytes) -> f32 [N, K]."""
    b = raw.reshape(-1, 210)
    ql = b[:, 0:128].reshape(-1, 2, 64).int()
    qh = b[:, 128:192].reshape(-1, 2, 32).int()
    sc = b[:, 192:208].contiguous().view(torch.int8).float()
    d = _f16(b[:, 208:210])
    lo, hi = ql[:, :, :32], ql[:, :, 32:]
    q = torch.stack([
        (lo & 0xF) | ((qh & 3) << 4),
        (hi & 0xF) | (((qh >> 2) & 3) << 4),
        (lo >> 4) | (((qh >> 4) & 3) << 4),
        (hi >> 4) | (((qh >> 6) & 3) << 4),
    ], dim=2).float() - 32.0  # [nb, half, quarter, 32]
    y = (d[:, None] * sc)[:, :, None] * q.reshape(-1, 16, 16)
    return y.reshape(n, k)


DECODERS = {"Q4_K": q4_k, "Q6_K": q6_k}
