"""Sequence-aware KV cell cache with tree attention, as in-place torch ops.

Torch counterpart of pipeinfer_tpu.runtime.kv_cache (ref: llama.cpp
`llama_kv_cell`/`llama_kv_cache`, seq ops :9238-9359, multi-seq attention
mask :5200-5240):

- fixed-size cell arrays: K/V of [L, KVH, C, D] (head-major, so the flash
  kernel reads per-head tiles of the full 4-D cache in place);
- per-cell metadata on the device: ``pos`` int32 [C] (-1 = free) and the
  seq-id bitmask ``seq`` [C, SEQ_WORDS], held as int32 bit for bit (the
  host mirrors keep the same words as uint32);
- every mutation updates the cache tensors IN PLACE and returns the same
  cache object — where the JAX package donated the buffers through jit,
  the port simply writes them;
- the attention mask is computed on the device from (pos, seq), so rollback
  and verification never round-trip to the host.
"""

from __future__ import annotations

import dataclasses
import math
import os as _os

import numpy as np
import torch

from ..ops.cell_attention import cell_attention
from ..ops.cell_attention import supports as cell_kernel_supports
from ..ops.layers import apply_rope

# Sequence-slot ceiling: 32 * SEQ_WORDS concurrent slots (PIPEINFER_SEQ_WORDS
# widens it; masks are [C, SEQ_WORDS] on the device and in the host mirrors).
SEQ_WORDS = max(1, int(_os.environ.get("PIPEINFER_SEQ_WORDS", "2")))
MASK_VALUE = -1e9  # additive mask (finite to avoid exp(-inf - -inf) NaN)


# -- host-mirror helpers (numpy uint32 [C, SEQ_WORDS], as in the reference) --


def host_seq_zeros(n_cells: int):
    return np.zeros((n_cells, SEQ_WORDS), np.uint32)


def host_only(seq_id: int):
    """A single-membership row [SEQ_WORDS] for seq_id."""
    row = np.zeros(SEQ_WORDS, np.uint32)
    row[seq_id // 32] = np.uint32(1) << np.uint32(seq_id % 32)
    return row


def reclaim_cells(ctx, cells, keep: int, base: int, seq: int = 0):
    """Reconcile a context's HOST mirrors with device truth for one
    device-verified run's cells: rows [0, keep) are live at positions
    base+row on `seq`; the device program freed the rest."""
    flat = np.asarray(cells).reshape(-1)
    if keep:
        ctx.h_pos[flat[:keep]] = base + np.arange(keep)
        ctx.h_seq[flat[:keep]] = host_only(seq)
    ctx.h_pos[flat[keep:]] = -1
    ctx.h_seq[flat[keep:]] = 0


def host_rows(seq_lists):
    """Membership rows [n, SEQ_WORDS] for a list of seq-id lists."""
    rows = np.zeros((len(seq_lists), SEQ_WORDS), np.uint32)
    for i, seqs in enumerate(seq_lists):
        for s in seqs:
            rows[i, s // 32] |= np.uint32(1) << np.uint32(s % 32)
    return rows


def host_member(h_seq, seq_id: int):
    """bool [C]: which mirror rows contain seq_id."""
    return (h_seq[:, seq_id // 32] & (np.uint32(1) << np.uint32(seq_id % 32))) != 0


def host_set(h_seq, seq_id: int, where):
    h_seq[where, seq_id // 32] |= np.uint32(1) << np.uint32(seq_id % 32)


def host_clear(h_seq, seq_id: int, where=slice(None)):
    h_seq[where, seq_id // 32] &= ~(np.uint32(1) << np.uint32(seq_id % 32))


def host_empty(h_seq):
    """bool [C]: rows with no memberships left."""
    return ~h_seq.any(axis=1)


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor  # [L, KVH, C, D]
    v: torch.Tensor  # [L, KVH, C, D]
    pos: torch.Tensor  # int32 [C], -1 = free
    seq: torch.Tensor  # int32 [C, SEQ_WORDS] membership bitmask (uint32 bits)
    # high-water mark: every occupied cell index is < hot, so attention
    # streams only cells [0, hot) (0 = the whole pool); set by the host
    hot: int = 0

    @property
    def n_cells(self) -> int:
        return self.pos.shape[0]

    @property
    def n_layers(self) -> int:
        return self.k.shape[0]


def create(n_layers: int, n_cells: int, n_kv_heads: int, head_dim: int,
           dtype=torch.bfloat16, device="cuda") -> KVCache:
    return KVCache(
        k=torch.zeros(n_layers, n_kv_heads, n_cells, head_dim, dtype=dtype, device=device),
        v=torch.zeros(n_layers, n_kv_heads, n_cells, head_dim, dtype=dtype, device=device),
        pos=torch.full((n_cells,), -1, dtype=torch.int32, device=device),
        seq=torch.zeros(n_cells, SEQ_WORDS, dtype=torch.int32, device=device),
    )


def _bit(seq_id: int) -> int:
    """The int32 value of seq_id's bit within its word."""
    v = 1 << (seq_id % 32)
    return v - (1 << 32) if v >= (1 << 31) else v


def _bits_of(seq_id: torch.Tensor) -> torch.Tensor:
    """int32 [T] bit values for a tensor of seq ids (wrapping bit 31)."""
    v = torch.ones_like(seq_id, dtype=torch.int64) << (seq_id.long() % 32)
    return torch.where(v >= (1 << 31), v - (1 << 32), v).to(torch.int32)


def _range_hit(pos: torch.Tensor, p0: int, p1: int) -> torch.Tensor:
    """pos in [p0, p1), with p1 < 0 meaning +inf."""
    return (pos >= p0) if p1 < 0 else (pos >= p0) & (pos < p1)


def _member(seq: torch.Tensor, seq_id: int) -> torch.Tensor:
    return (seq[:, seq_id // 32] & _bit(seq_id)) != 0


# ---------------------------------------------------------------------------
# Mutations (in place; each returns the cache it was given)
# ---------------------------------------------------------------------------


def write_tokens(cache: KVCache, layer: int, cell_idx: torch.Tensor,
                 k_new: torch.Tensor, v_new: torch.Tensor) -> KVCache:
    """Store K/V rows [T, KVH, D] for one layer at the given cells. Padding
    rows all target the trash cell; which duplicate lands there is
    unspecified on CUDA, which is harmless because it is never visible."""
    idx = cell_idx.long()
    cache.k[layer].index_copy_(1, idx, k_new.to(cache.k.dtype).transpose(0, 1))
    cache.v[layer].index_copy_(1, idx, v_new.to(cache.v.dtype).transpose(0, 1))
    return cache


def write_meta(cache: KVCache, cell_idx: torch.Tensor, pos: torch.Tensor,
               seq_id: torch.Tensor, valid: torch.Tensor | None = None,
               seq_bits: torch.Tensor | None = None) -> KVCache:
    """Claim cells for the new tokens. Membership is {seq_id} unless an
    explicit multi-sequence bitmask [T, SEQ_WORDS] is given (tree batches)."""
    idx = cell_idx.long()
    if seq_bits is None:
        seq_bits = torch.zeros(idx.shape[0], SEQ_WORDS, dtype=torch.int32, device=idx.device)
        seq_bits.scatter_(1, (seq_id.long() // 32)[:, None], _bits_of(seq_id)[:, None])
    if valid is not None:
        pos = torch.where(valid, pos, cache.pos[idx])
        seq_bits = torch.where(valid[:, None], seq_bits, cache.seq[idx])
    cache.pos[idx] = pos.to(torch.int32)
    cache.seq[idx] = seq_bits.to(torch.int32)
    return cache


def seq_rm(cache: KVCache, seq_id: int, p0, p1) -> KVCache:
    """Remove seq membership in [p0, p1); free cells with no members left
    (ref: llama_kv_cache_seq_rm). p1 < 0 means +inf."""
    w, b = seq_id // 32, _bit(seq_id)
    hit = _member(cache.seq, seq_id) & _range_hit(cache.pos, p0, p1)
    col = cache.seq[:, w]
    cache.seq[:, w] = torch.where(hit, col & ~b, col)
    cache.pos.masked_fill_((cache.seq == 0).all(dim=1), -1)
    return cache


def seq_cp(cache: KVCache, src: int, dst: int, p0, p1) -> KVCache:
    """Share cells of src with dst in [p0, p1) — zero-copy, a bit-OR
    (ref: llama_kv_cache_seq_cp)."""
    hit = _member(cache.seq, src) & _range_hit(cache.pos, p0, p1)
    w, b = dst // 32, _bit(dst)
    col = cache.seq[:, w]
    cache.seq[:, w] = torch.where(hit, col | b, col)
    return cache


def rm_tail(cache: KVCache, p0) -> KVCache:
    """Free every cell at pos >= p0 regardless of sequence membership."""
    hit = cache.pos >= p0
    cache.seq.masked_fill_(hit[:, None], 0)
    cache.pos.masked_fill_(hit, -1)
    return cache


def seq_keep(cache: KVCache, seq_id: int) -> KVCache:
    """Drop every sequence except seq_id (ref: llama_kv_cache_seq_keep)."""
    keep = _member(cache.seq, seq_id)
    cache.seq.zero_()
    cache.seq[:, seq_id // 32] = torch.where(keep, _bit(seq_id), 0).to(torch.int32)
    cache.pos.masked_fill_(~keep, -1)
    return cache


def seq_shift(cache: KVCache, seq_id: int, p0, p1, delta: int, *, rope_dims: int,
              rope_mode: str = "norm", freq_base: float = 10000.0,
              freq_scale: float = 1.0) -> KVCache:
    """Shift positions by delta in [p0, p1) and re-rotate cached K by the same
    delta over the whole pool; cells shifted below pos 0 are freed."""
    hit = _member(cache.seq, seq_id) & _range_hit(cache.pos, p0, p1)
    new_pos = torch.where(hit, cache.pos + delta, cache.pos)
    n_l, kvh, c, d = cache.k.shape
    deltas = torch.where(hit, delta, 0).to(torch.int32).repeat(n_l)
    k2 = cache.k.transpose(1, 2).reshape(n_l * c, kvh, d)
    k_rot = apply_rope(k2, deltas, rope_dims, mode=rope_mode, freq_base=freq_base,
                       freq_scale=freq_scale)
    cache.k.copy_(k_rot.reshape(n_l, c, kvh, d).transpose(1, 2))
    dropped = hit & (new_pos < 0)
    cache.pos.copy_(torch.where(dropped, -1, new_pos))
    cache.seq.masked_fill_(dropped[:, None], 0)
    return cache


def shift_cells(cache: KVCache, cells: torch.Tensor, delta: int, trash: int, *,
                rope_dims: int, rope_mode: str = "norm", freq_base: float = 10000.0,
                freq_scale: float = 1.0) -> KVCache:
    """Range-limited K-shift: re-rotate only the given cells (gather, rope,
    scatter). Padding entries must point at the trash cell (zero delta)."""
    cells = cells.long()
    pad = cells == trash
    d_eff = torch.where(pad, 0, delta)
    k_sel = cache.k[:, :, cells].float()  # [L, KVH, N, D]
    half = rope_dims // 2
    idx = torch.arange(0, half, dtype=torch.float32, device=cells.device)
    freqs = freq_base ** (-idx * 2.0 / rope_dims)
    angles = d_eff.float()[:, None] * freqs[None, :] * freq_scale
    cos = torch.cos(angles)[None, None]
    sin = torch.sin(angles)[None, None]
    if rope_mode == "neox":
        x1 = k_sel[..., :half]
        x2 = k_sel[..., half: 2 * half]
        k_rot = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos, k_sel[..., 2 * half:]],
                          dim=-1)
    else:
        xe = k_sel[..., 0:rope_dims:2]
        xo = k_sel[..., 1:rope_dims:2]
        rot = torch.stack([xe * cos - xo * sin, xe * sin + xo * cos], dim=-1)
        rot = rot.reshape(*k_sel.shape[:-1], rope_dims)
        k_rot = torch.cat([rot, k_sel[..., rope_dims:]], dim=-1)
    cache.k[:, :, cells] = k_rot.to(cache.k.dtype)
    old = cache.pos[cells]
    moved = old + d_eff
    dropped = (~pad) & (moved < 0)
    cache.pos[cells] = torch.where(pad, old, torch.where(dropped, -1, moved)).to(torch.int32)
    cache.seq[cells] = torch.where(dropped[:, None], 0, cache.seq[cells])
    return cache


def clear(cache: KVCache) -> KVCache:
    cache.pos.fill_(-1)
    cache.seq.zero_()
    return cache


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def attn_mask(cache: KVCache, tok_pos: torch.Tensor, tok_seq: torch.Tensor) -> torch.Tensor:
    """Additive mask [T, C]: token t attends cell c iff c belongs to t's
    sequence and 0 <= cell_pos <= tok_pos."""
    tok_seq = tok_seq.long()
    words = cache.seq.long()[:, tok_seq // 32]  # [C, T]
    bits = (words >> (tok_seq % 32)[None, :]) & 1
    pos = cache.pos
    visible = (bits.T != 0) & (pos[None, :] <= tok_pos[:, None]) & (pos[None, :] >= 0)
    return torch.where(visible, 0.0, MASK_VALUE).float()


def alibi_slopes(n_heads: int, max_bias: float, device="cpu") -> torch.Tensor:
    """Per-head ALiBi slopes (ggml_alibi: power-of-two head bucketing with
    interpolated slopes for other head counts)."""
    n_floor = 2 ** int(math.floor(math.log2(n_heads)))
    m0 = 2.0 ** (-max_bias / n_floor)
    m1 = 2.0 ** (-max_bias / 2.0 / n_floor)
    slopes = [m0 ** (h + 1) if h < n_floor else m1 ** (2 * (h - n_floor) + 1)
              for h in range(n_heads)]
    return torch.tensor(slopes, dtype=torch.float32, device=device)


def attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
              mask: torch.Tensor, *, scale: float, alibi: torch.Tensor | None = None,
              cache_pos: torch.Tensor | None = None) -> torch.Tensor:
    """Dense masked SDPA over a [KVH, C, D] cell array (GQA-aware), with
    optional ALiBi bias slope * max(cell_pos, 0). Plain torch, as the JAX
    package leaves this path to XLA. A row whose mask sees no cell (a
    padding row) gives 0, as the cell kernel gives it: the JAX package's
    softmax spreads it over the pool, stale K/V of freed cells included,
    and under i4g and i8g its values would reach the valid rows through
    the activation scale all rows of a product share."""
    t, h, d = q.shape
    kvh = k_cache.shape[0]
    g = h // kvh
    qf = q.float().reshape(t, kvh, g, d)
    scores = torch.einsum("tkgd,kcd->tkgc", qf, k_cache.float()) * scale
    scores = scores + mask[:, None, None, :]
    if alibi is not None:
        bias = alibi.float().reshape(kvh, g)[None, :, :, None] * (
            cache_pos.clamp_min(0).float()[None, None, None, :])
        scores = scores + bias
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("tkgc,kcd->tkgd", p, v_cache.float()).reshape(t, h, d)
    seen = (mask > MASK_VALUE / 2).any(dim=-1)
    return torch.where(seen[:, None, None], out, 0.0)


# Flash-vs-dense dispatch thresholds, kept as the reference set them (they
# are to be retuned from H100 measurements only). Overrides:
# PIPEINFER_FLASH_MIN_CELLS / _FLASH_MAX_T / _FLASH_BIG.
FLASH_MIN_CELLS = int(_os.environ.get("PIPEINFER_FLASH_MIN_CELLS", 512))
FLASH_SMALL_T = int(_os.environ.get("PIPEINFER_FLASH_MAX_T", 4))
FLASH_MIN_CELLS_BIG = int(_os.environ.get("PIPEINFER_FLASH_BIG", 8192))


def hot_bucket(h_pos, trash_cell: int) -> int:
    """Bucketized occupancy high-water mark for a host pos mirror: the
    power of two (min 512) covering the highest occupied cell, or 0 for
    "stream the whole pool"."""
    n = trash_cell + 1
    if n <= 512:
        return 0
    used = np.nonzero(h_pos[:trash_cell] >= 0)[0]
    hw = int(used[-1]) + 1 if len(used) else 1
    b = 512
    while b < hw:
        b *= 2
    b = min(b, n)
    return 0 if b >= n else b


def round_pool(n_cells: int) -> int:
    """Round a cell-pool size up to the flash-dispatch granularity (512)."""
    if n_cells <= 512:
        return n_cells
    return -(-n_cells // 512) * 512


def use_cell_kernel(t: int, h: int, kvh: int, d: int, c: int, hot: int, on_cuda: bool) -> bool:
    """Whether attend sends T query rows of H heads (KVH KV heads of width
    D) over a pool of c cells, streaming [0, hot) (0: all), to the flash
    cell kernel: on a CUDA device, for long pools (small T, or any T at
    >= FLASH_MIN_CELLS_BIG cells), and only for shapes the kernel takes."""
    return (on_cuda and c >= FLASH_MIN_CELLS and c % 512 == 0
            and (t <= FLASH_SMALL_T or c >= FLASH_MIN_CELLS_BIG)
            and cell_kernel_supports(d, hot or c, h, kvh))


def attend(q: torch.Tensor, cache: KVCache, layer: int, mask: torch.Tensor,
           tok_pos: torch.Tensor, tok_seq: torch.Tensor, valid: torch.Tensor, *,
           scale: float, alibi: torch.Tensor | None = None) -> torch.Tensor:
    """Attention dispatcher: the flash cell kernel where use_cell_kernel
    says so, else the dense masked SDPA over cells [0, hot)."""
    c = cache.n_cells
    hot = cache.hot if (cache.hot and cache.hot < c) else 0
    t, h, d = q.shape
    if use_cell_kernel(t, h, cache.k.shape[1], d, c, hot, q.is_cuda):
        return cell_attention(
            q.float().contiguous(), cache.k, cache.v, cache.pos, cache.seq,
            tok_pos.to(torch.int32), tok_seq.to(torch.int32), valid,
            layer=layer, scale=scale, alibi=alibi, hot=hot,
        )
    if hot:
        k_l, v_l = cache.k[layer, :, :hot], cache.v[layer, :, :hot]
        cpos, mask = cache.pos[:hot], mask[:, :hot]
    else:
        k_l, v_l, cpos = cache.k[layer], cache.v[layer], cache.pos
    return attention(q, k_l, v_l, mask, scale=scale, alibi=alibi,
                     cache_pos=cpos if alibi is not None else None)
