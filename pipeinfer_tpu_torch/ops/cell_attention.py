"""Flash attention over the sequence-aware cell cache.

Torch counterpart of pipeinfer_tpu.ops.cell_attention: query rows of one
step attend cells [0, hot) of one static layer of the [L, KVH, C, D] cache,
with the tree-attention visibility mask computed from per-cell (pos, seq
bitmask) metadata and ALiBi fused the same way. On a CUDA tensor
``cell_attention`` launches the hand-written kernel
(``csrc/cell_attention.cu``); on a CPU tensor it runs the plain version.

Replaces pipeinfer_tpu/ops/cell_attention.py::_kernel. Bound on the H100:
bytes — one pass over K and V of [0, hot) for the layer (2 B per element);
at decode T the rows reuse each element only T * G times. The kernel reads
the 4-D cache in place at the layer offset, converts 32-cell tiles to f32 in
shared memory and runs the online softmax with one block per (KV head, tile
of query rows); see the source for the design and what it leaves for later.
"""

from __future__ import annotations

import torch

from . import cuda_build

NEG = -1e9
BLOCK_C = 32  # cells per kernel step; the cell range must be a multiple


def _cell_attention_plain(q, k_cache, v_cache, cell_pos, cell_seq, tok_pos, tok_seq, valid,
                          layer, scale, alibi, c):
    """Plain version of the kernel: the same masked scores, the softmax with
    its max floored at NEG (the online softmax starts there) and the
    l == 0 -> 1 guard."""
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
    visible = ((bit != 0) & (pos[None, :] <= tok_pos.long()[:, None]) & (pos[None, :] >= 0)
               & valid.bool()[:, None])
    s = s + torch.where(visible, 0.0, NEG)[:, None, None, :]
    if alibi is not None:
        slope = alibi.float().reshape(kvh, g)
        s = s + slope[None, :, :, None] * pos.clamp_min(0).float()[None, None, None, :]
    m = s.amax(dim=-1, keepdim=True).clamp_min(NEG)
    p = torch.exp(s - m)
    l_sum = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("tkgc,kcd->tkgd", p, v) / torch.where(l_sum == 0, 1.0, l_sum)
    return out.reshape(t, h, d)


def cell_attention(
    q: torch.Tensor,  # [T, H, D] f32
    k_cache: torch.Tensor,  # [L, KVH, C, D] (or [KVH, C, D])
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
    if d % 8 or d > 128 or n_words > 8 or c % BLOCK_C or h % kvh:
        raise ValueError(f"cell_attention: unsupported shape D={d} W={n_words} C={c}")
    if (v_cache.shape != k_cache.shape or k_cache.shape[3] != d or not 0 <= layer < n_l
            or cell_pos.shape != (c_full,) or cell_seq.shape[0] != c_full
            or tok_pos.shape != (t,) or tok_seq.shape != (t,) or valid.shape != (t,)
            or (alibi is not None and alibi.shape != (h,))):
        raise ValueError("cell_attention: inputs do not fit q [T, H, D] and the "
                         f"[L, KVH, C, D] cache {tuple(k_cache.shape)} at layer {layer}")
    cuda_build.check_tensors(
        "cell_attention", q=(q, torch.float32), k_cache=(k_cache, torch.bfloat16),
        v_cache=(v_cache, torch.bfloat16), cell_pos=(cell_pos, torch.int32),
        cell_seq=(cell_seq, torch.int32), tok_pos=(tok_pos, torch.int32),
        tok_seq=(tok_seq, torch.int32), valid=(valid, torch.bool))
    slopes = None
    if alibi is not None:
        slopes = alibi.to(device=q.device, dtype=torch.float32).contiguous()
    out = torch.empty(t, h, d, dtype=torch.float32, device=q.device)
    cell_attention.launches += 1
    cuda_build.launch("cell_attention", "pi_cell_attention", q, k_cache, v_cache, cell_pos,
                      cell_seq, tok_pos, tok_seq, valid, slopes, out, t, h, kvh, c_full, d,
                      n_words, layer, c, float(scale))
    return out


cell_attention.launches = 0
