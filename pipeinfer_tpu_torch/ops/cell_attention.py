"""Flash attention over the sequence-aware cell cache.

Torch counterpart of pipeinfer_tpu.ops.cell_attention: query rows of one
step attend cells [0, hot) of one static layer of the [L, KVH, C, D] cache,
with the tree-attention visibility mask computed from per-cell (pos, seq
bitmask) metadata and ALiBi fused the same way. On a CUDA tensor
``cell_attention`` launches the hand-written kernel
(``csrc/cell_attention.cu``); on a CPU tensor it runs the plain version.

Replaces pipeinfer_tpu/ops/cell_attention.py::_kernel. Bound on the H100:
bytes — one pass over K and V of [0, hot) for the layer (2 B per element
in a bf16 cache, 4 B in an f32 one);
at decode T the rows reuse each element only T * G times. The kernel cuts
the cell range into splits (flash decoding, ``plan``), so that its blocks
fill the card's waves of resident blocks even at T = 1, reads K/V in place
at the layer offset straight into registers, and the last block of each
KV head merges the splits' partial softmax states; see the source for the
design.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from . import cuda_build

NEG = -1e9
BLOCK_C = 32  # a split is a multiple of this many cells, and so is the cell range
THREADS = 128  # threads of one split block (THREADS in csrc/cell_attention.cu)
CELLS_PER_STEP = 2  # cells a lane group takes per step (U there)
SMS = 132  # the H100's SMs
BLOCKS_PER_SM = {1: 5, 2: 4, 4: 3}  # resident split blocks per SM by rows per block
#                                     (held by __launch_bounds__ in the kernel)
MIN_SPLIT = 64  # cells per split at least, so a block's set-up and merge stay small
MAX_SPLITS = 256  # splits at most (MAX_SPLITS in the kernel)
FILL = 0.9  # share of the grid's waves of resident blocks that the splits should fill


class Plan(NamedTuple):
    """How the kernel cuts one call. ``rows`` query rows per block (GQA
    groups folded in, row = t * G + g) in ``row_tiles`` tiles; ``group_lanes``
    lanes share one cell, 8 columns each; the cells [0, c) go in
    ``n_splits`` splits of ``split`` cells (the last may be shorter); the
    split kernel's grid is (n_splits, row_tiles, KVH)."""

    rows: int
    row_tiles: int
    group_lanes: int
    split: int
    n_splits: int
    blocks: int


@functools.lru_cache(maxsize=256)
def plan(t: int, h: int, kvh: int, d: int, c: int) -> Plan:
    """The cut for T query tokens, H heads over KVH KV heads of width D and
    c cells (a multiple of BLOCK_C). Splits are multiples of BLOCK_C and at
    least MIN_SPLIT cells (or the whole range, where it is shorter). Their
    count is the smallest that fills the waves of resident blocks it makes
    to FILL or more (a wave the grid fills only in part costs as much as a
    full one), else the one that fills them best."""
    tg = t * (h // kvh)
    group_lanes = 4 if d <= 32 else 8 if d <= 64 else 16
    # a group's lanes each end up with one (cell, row) pair of a step
    rows = min(1 if tg == 1 else 2 if tg == 2 else 4, group_lanes // CELLS_PER_STEP)
    row_tiles = -(-tg // rows)
    slots = SMS * BLOCKS_PER_SM[rows]
    best = None
    for want in range(1, min(MAX_SPLITS, max(1, c // MIN_SPLIT)) + 1):
        per = -(-c // want)
        split = min(c, max(MIN_SPLIT, -(-per // BLOCK_C) * BLOCK_C))
        blocks = -(-c // split) * row_tiles * kvh
        fill = blocks / (slots * -(-blocks // slots))
        if best is None or fill > best[0]:
            best = (fill, split, blocks)
        if fill >= FILL:
            break
    _, split, blocks = best
    return Plan(rows, row_tiles, group_lanes, split, -(-c // split), blocks)


def supports(d: int, c: int, h: int, kvh: int) -> bool:
    """Whether the kernel takes head width D, c streamed cells and H heads
    over KVH KV heads: a lane holds 8 columns of a row, at most 16 lanes
    share a cell (D % 8 == 0, D <= 128), the cells come in BLOCK_C steps and
    the heads in whole GQA groups. Other shapes take attend's dense path."""
    return d % 8 == 0 and d <= 128 and c % BLOCK_C == 0 and h % kvh == 0


def _cell_attention_plain(q, k_cache, v_cache, cell_pos, cell_seq, tok_pos, tok_seq, valid,
                          layer, scale, alibi, c):
    """Plain version of the kernel: the same masked scores, -inf for every
    cell of a padding row, the softmax with its max floored at NEG (the
    online softmax starts there) and the l == 0 -> 1 guard, which gives a
    padding row 0."""
    t, h, d = q.shape
    kvh = k_cache.shape[1]
    g = h // kvh
    k = k_cache[layer, :, :c].float()
    v = v_cache[layer, :, :c].float()
    pos = cell_pos[:c].long()
    s = torch.einsum("tkgd,kcd->tkgc", q.float().reshape(t, kvh, g, d), k) * scale
    tok_seq = tok_seq.long()
    words = cell_seq[:c].long()[:, tok_seq // 32].T  # [T, c]
    bit = (words >> (tok_seq % 32)[:, None]) & 1
    visible = (bit != 0) & (pos[None, :] <= tok_pos.long()[:, None]) & (pos[None, :] >= 0)
    s = s + torch.where(visible, 0.0, NEG)[:, None, None, :]
    if alibi is not None:
        slope = alibi.float().reshape(kvh, g)
        s = s + slope[None, :, :, None] * pos.clamp_min(0).float()[None, None, None, :]
    s = s.masked_fill(~valid.bool()[:, None, None, None], float("-inf"))
    m = s.amax(dim=-1, keepdim=True).clamp_min(NEG)
    p = torch.exp(s - m)
    l_sum = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("tkgc,kcd->tkgd", p, v) / torch.where(l_sum == 0, 1.0, l_sum)
    return out.reshape(t, h, d)


_ticket_buffers: dict = {}


def _tickets(device: torch.device, n: int) -> torch.Tensor:
    """n zeroed int32 counters for the kernel's merge tickets, one buffer per
    (device, stream): the kernel leaves them zero, so they are zeroed once,
    and calls on one stream never run at the same time."""
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    buf = _ticket_buffers.get(key)
    if buf is None or buf.numel() < n:
        buf = _ticket_buffers[key] = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
    return buf


def cell_attention(
    q: torch.Tensor,  # [T, H, D] f32
    k_cache: torch.Tensor,  # [L, KVH, C, D] (or [KVH, C, D]), bf16 or f32
    v_cache: torch.Tensor,
    cell_pos: torch.Tensor,  # [C] i32
    cell_seq: torch.Tensor,  # [C, W] i32 holding the uint32 bitmask bit for bit
    tok_pos: torch.Tensor,  # [T] i32
    tok_seq: torch.Tensor,  # [T] i32
    valid: torch.Tensor,  # [T] bool
    *,
    layer: int = 0,
    scale: float,
    alibi: torch.Tensor | None = None,  # [H] f32 slopes
    hot: int = 0,  # stream only cells [0, hot) (0 = the whole pool)
) -> torch.Tensor:
    """out f32 [T, H, D]. Launch count: ``cell_attention.launches``."""
    if k_cache.dim() == 3:
        k_cache, v_cache, layer = k_cache[None], v_cache[None], 0
    t, h, d = q.shape
    _, kvh, c_full, _ = k_cache.shape
    c = hot if (hot and hot < c_full) else c_full
    if not q.is_cuda:
        return _cell_attention_plain(q, k_cache, v_cache, cell_pos, cell_seq, tok_pos,
                                     tok_seq, valid, layer, scale, alibi, c)
    n_l, n_words = k_cache.shape[0], cell_seq.shape[1]
    if not supports(d, c, h, kvh):
        raise ValueError(f"cell_attention: unsupported shape D={d} C={c} H={h} KVH={kvh}")
    if (v_cache.shape != k_cache.shape or k_cache.shape[3] != d or not 0 <= layer < n_l
            or cell_pos.shape != (c_full,) or cell_seq.shape[0] != c_full
            or tok_pos.shape != (t,) or tok_seq.shape != (t,) or valid.shape != (t,)
            or (alibi is not None and alibi.shape != (h,))):
        raise ValueError("cell_attention: inputs do not fit q [T, H, D] and the "
                         f"[L, KVH, C, D] cache {tuple(k_cache.shape)} at layer {layer}")
    if k_cache.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"cell_attention: the cache must be bf16 or f32, got {k_cache.dtype}")
    cuda_build.check_tensors(
        "cell_attention", q=(q, torch.float32), k_cache=(k_cache, k_cache.dtype),
        v_cache=(v_cache, k_cache.dtype), cell_pos=(cell_pos, torch.int32),
        cell_seq=(cell_seq, torch.int32), tok_pos=(tok_pos, torch.int32),
        tok_seq=(tok_seq, torch.int32), valid=(valid, torch.bool))
    if k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError("cell_attention: k_cache and v_cache must be 16-byte aligned")
    slopes = None
    if alibi is not None:
        slopes = alibi.to(device=q.device, dtype=torch.float32).contiguous()
    cut = plan(t, h, kvh, d, c)
    part = torch.empty(t * h * cut.n_splits * (d + 2), dtype=torch.float32, device=q.device)
    out = torch.empty(t, h, d, dtype=torch.float32, device=q.device)
    tickets = _tickets(q.device, cut.row_tiles * kvh)
    cuda_build.launch("cell_attention", "pi_cell_attention", q, k_cache, v_cache, cell_pos,
                      cell_seq, tok_pos, tok_seq, valid, slopes, part, tickets, out, t, h, kvh,
                      c_full, d, n_words, layer, c, cut.rows, cut.group_lanes, cut.split,
                      cut.n_splits, float(scale), k_cache.element_size(), count=cell_attention)
    return out


cell_attention.launches = 0
