"""The yardstick: the H100's published peaks and the operations and bytes
each kernel's work needs, counted from shapes.

Peaks (NVIDIA H100 SXM data sheet, dense, at the 700 W limit): 3.35e12
bytes/s of HBM, 1979e12 int8 operations/s, 989e12 bf16 FLOP/s. A kernel's
least time is max(bytes / HBM, operations / peak), each input byte counted
once and each output byte once, whatever the kernel reads again.
"""

from __future__ import annotations

HBM_BPS = 3.35e12
PEAK_INT8_OPS = 1979e12
PEAK_BF16_FLOPS = 989e12


def least_s(nbytes: float, ops: float, peak: float) -> float:
    return max(nbytes / HBM_BPS, ops / peak)


def i4g_work(m: int, n: int, kp: int) -> tuple[float, float]:
    """(bytes, operations) of one i4g call: x quantized [M, Kp] s8 with its
    per-128-row sums [M, Kp/128] and scales [Kp/128] (f32), the weight's
    nibbles [Kp/2, N] with step and wmin [Kp/128, N] (f32), out [M, N]
    f32; 2 M N Kp operations."""
    g = kp // 128
    nbytes = m * kp + 4 * m * g + 4 * g + kp // 2 * n + 2 * 4 * g * n + 4 * m * n
    return float(nbytes), 2.0 * m * n * kp


def cell_attn_work(rows: int, visible: int, pairs: int, n_heads: int, n_kv_heads: int,
                   head_dim: int, kv_bytes: int = 2) -> tuple[float, float]:
    """(bytes, FLOPs) of one layer's cell attention: q and out [rows, H, D]
    f32, K and V [visible cells, KVH, D] of the cache's element size for the
    cells some query can see, and 4 H D FLOPs per visible (query, cell)
    pair (scores and the weighted sum)."""
    nbytes = 2 * 4 * rows * n_heads * head_dim + 2 * kv_bytes * visible * n_kv_heads * head_dim
    return float(nbytes), 4.0 * n_heads * head_dim * pairs


def matmul_params(mb) -> int:
    """Weights the target's products read per token: every layer's
    projections and the head (the embedding is a gather)."""
    per_layer = sum(n * k for _, n, k in mb.slots())
    return mb.n_layers * per_layer + mb.n_vocab * mb.n_embd


def token_flops(mb, context: int) -> float:
    """Target FLOPs of one token at `context` cells: 2 per weight of its
    products, plus 4 H D per cell of attention in every layer."""
    return 2.0 * matmul_params(mb) + 4.0 * mb.n_layers * mb.n_heads * mb.head_dim * context
