"""Load-time repacking of ggml block-quant payloads into TPU-planar layouts.

The reference's interleaved block structs (ggml-quants.h) are the wrong shape
for the TPU: scales, high-bits and nibbles are interleaved per 144-176 byte
struct, defeating vectorized unpacking and forcing gather-heavy access. We
repack once at model load into separate *planes* that DMA cleanly into VMEM
and unpack with a handful of full-width VPU ops inside the matmul kernel:

- every format is normalized to the affine form  ``w = s * q - b``
  with unsigned (or, for Q8_0, signed) integer quants ``q`` and per-group
  float32 scale ``s`` / bias ``b`` planes of shape [N, K/G];
- 4-bit quants become a nibble plane [N, K/2] where, within each 256-column
  packgroup, byte j holds element j in its low nibble and element j+128 in
  its high nibble — so in-kernel unpacking is just
  ``concat(b & 0xF, b >> 4)`` along the lane axis;
- 5/6-bit formats add a high-bit plane; 2/3-bit formats use 2-bit planes.

Semantics of the source formats per ggml-quants.c `dequantize_row_*`
(bit-exactness against them is covered by tests/test_quant_pack.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..gguf.constants import GGMLQuantType, QUANT_BLOCK_INFO, QK_K
from .formats import _blocks, _read_f16, _unpack_scale_min_k4, _unpack_q3k_scales, _qh_to_bits

U8 = np.uint8

# Columns covered by one pack group: nibble/high-bit planes are split-packed
# within groups of this many columns (== QK_K so k-quant superblocks align).
PACK_GROUP = 256

# quant bits and scale-group size per format
FORMAT_INFO: dict[GGMLQuantType, tuple[int, int]] = {
    GGMLQuantType.Q4_0: (4, 32),
    GGMLQuantType.Q4_1: (4, 32),
    GGMLQuantType.Q5_0: (5, 32),
    GGMLQuantType.Q5_1: (5, 32),
    GGMLQuantType.Q8_0: (8, 32),
    GGMLQuantType.Q2_K: (2, 16),
    GGMLQuantType.Q3_K: (3, 16),
    GGMLQuantType.Q4_K: (4, 32),
    GGMLQuantType.Q5_K: (5, 32),
    GGMLQuantType.Q6_K: (6, 16),
}


@dataclasses.dataclass
class PackedWeight:
    """A quantized [N, K] weight in TPU-planar layout (numpy, host-side).

    ``qs``  — low-bits plane: uint8 [N, K/2] (4/5/6-bit), uint8 [N, K/4]
              (2/3-bit low-2), or int8 [N, K] (Q8_0).
    ``qh``  — high-bits plane or None: uint8 [N, K/8] (1 extra bit) or
              [N, K/4] (2 extra bits).
    ``scales``/``bias`` — float32 [N, K/G].
    """

    qtype: GGMLQuantType
    shape: tuple[int, int]  # (N, K)
    qs: np.ndarray
    qh: np.ndarray | None
    scales: np.ndarray
    bias: np.ndarray

    @property
    def bits(self) -> int:
        return FORMAT_INFO[self.qtype][0]

    @property
    def group(self) -> int:
        return FORMAT_INFO[self.qtype][1]

    def nbytes(self) -> int:
        return (
            self.qs.nbytes
            + (self.qh.nbytes if self.qh is not None else 0)
            + self.scales.nbytes
            + self.bias.nbytes
        )


# ---------------------------------------------------------------------------
# Step 1: decode raw payloads to (integer quants, scale plane, bias plane)
# ---------------------------------------------------------------------------


def _quants_q4_0(raw):
    b = _blocks(raw, GGMLQuantType.Q4_0)
    d = _read_f16(b[:, 0:2])
    qs = b[:, 2:18]
    q = np.concatenate([qs & 0xF, qs >> 4], axis=1)
    return q, d[:, None], 8.0 * d[:, None]


def _quants_q4_1(raw):
    b = _blocks(raw, GGMLQuantType.Q4_1)
    d = _read_f16(b[:, 0:2])
    m = _read_f16(b[:, 2:4])
    qs = b[:, 4:20]
    q = np.concatenate([qs & 0xF, qs >> 4], axis=1)
    return q, d[:, None], -m[:, None]


def _quants_q5_0(raw):
    b = _blocks(raw, GGMLQuantType.Q5_0)
    d = _read_f16(b[:, 0:2])
    hbits = _qh_to_bits(b[:, 2:6])
    qs = b[:, 6:22]
    lo = np.concatenate([qs & 0xF, qs >> 4], axis=1)
    q = lo | (hbits << 4)
    return q.astype(U8), d[:, None], 16.0 * d[:, None]


def _quants_q5_1(raw):
    b = _blocks(raw, GGMLQuantType.Q5_1)
    d = _read_f16(b[:, 0:2])
    m = _read_f16(b[:, 2:4])
    hbits = _qh_to_bits(b[:, 4:8])
    qs = b[:, 8:24]
    lo = np.concatenate([qs & 0xF, qs >> 4], axis=1)
    q = lo | (hbits << 4)
    return q.astype(U8), d[:, None], -m[:, None]


def _quants_q8_0(raw):
    b = _blocks(raw, GGMLQuantType.Q8_0)
    d = _read_f16(b[:, 0:2])
    q = b[:, 2:34].view(np.int8)
    return q, d[:, None], np.zeros_like(d)[:, None]


def _quants_q2_K(raw):
    b = _blocks(raw, GGMLQuantType.Q2_K)
    nb = len(b)
    scales = b[:, 0:16]
    qs = b[:, 16:80]
    d = _read_f16(b[:, 80:82])
    dmin = _read_f16(b[:, 82:84])
    q = np.empty((nb, 256), dtype=U8)
    for half in range(2):
        src = qs[:, half * 32 : half * 32 + 32]
        for j in range(4):
            q[:, half * 128 + 32 * j : half * 128 + 32 * (j + 1)] = (src >> (2 * j)) & 3
    s = d[:, None] * (scales & 0xF).astype(np.float32)
    bias = dmin[:, None] * (scales >> 4).astype(np.float32)
    return q, s, bias


def _quants_q3_K(raw):
    b = _blocks(raw, GGMLQuantType.Q3_K)
    nb = len(b)
    hmask = b[:, 0:32]
    qs = b[:, 32:96]
    sc = _unpack_q3k_scales(b[:, 96:108]).astype(np.float32)
    d = _read_f16(b[:, 108:110])
    q = np.empty((nb, 256), dtype=U8)
    for half in range(2):
        src = qs[:, half * 32 : half * 32 + 32]
        for j in range(4):
            grp32 = half * 4 + j
            lo = (src >> (2 * j)) & 3
            hbit = (hmask >> grp32) & 1
            q[:, 128 * half + 32 * j : 128 * half + 32 * (j + 1)] = lo | (hbit << 2)
    s = d[:, None] * sc  # (nb, 16), signed
    return q, s, 4.0 * s  # val = s*(q - 4)


def _quants_q4_K(raw):
    b = _blocks(raw, GGMLQuantType.Q4_K)
    nb = len(b)
    d = _read_f16(b[:, 0:2])
    dmin = _read_f16(b[:, 2:4])
    sc, m = _unpack_scale_min_k4(b[:, 4:16])
    qs = b[:, 16:144]
    q = np.empty((nb, 256), dtype=U8)
    for j in range(4):
        src = qs[:, 32 * j : 32 * (j + 1)]
        q[:, 64 * j : 64 * j + 32] = src & 0xF
        q[:, 64 * j + 32 : 64 * j + 64] = src >> 4
    s = d[:, None] * sc.astype(np.float32)
    bias = dmin[:, None] * m.astype(np.float32)
    return q, s, bias


def _quants_q5_K(raw):
    b = _blocks(raw, GGMLQuantType.Q5_K)
    nb = len(b)
    d = _read_f16(b[:, 0:2])
    dmin = _read_f16(b[:, 2:4])
    sc, m = _unpack_scale_min_k4(b[:, 4:16])
    qh = b[:, 16:48]
    qs = b[:, 48:176]
    q = np.empty((nb, 256), dtype=U8)
    for j in range(4):
        src = qs[:, 32 * j : 32 * (j + 1)]
        h1 = ((qh >> (2 * j)) & 1) << 4
        h2 = ((qh >> (2 * j + 1)) & 1) << 4
        q[:, 64 * j : 64 * j + 32] = (src & 0xF) | h1
        q[:, 64 * j + 32 : 64 * j + 64] = (src >> 4) | h2
    s = d[:, None] * sc.astype(np.float32)
    bias = dmin[:, None] * m.astype(np.float32)
    return q, s, bias


def _quants_q6_K(raw):
    b = _blocks(raw, GGMLQuantType.Q6_K)
    nb = len(b)
    ql = b[:, 0:128]
    qh = b[:, 128:192]
    sc = b[:, 192:208].view(np.int8).astype(np.float32)
    d = _read_f16(b[:, 208:210])
    q = np.empty((nb, 256), dtype=U8)
    for half in range(2):
        l_ = ql[:, 64 * half : 64 * half + 64]
        h_ = qh[:, 32 * half : 32 * half + 32]
        base = 128 * half
        q[:, base + 0 : base + 32] = (l_[:, :32] & 0xF) | ((h_ & 3) << 4)
        q[:, base + 32 : base + 64] = (l_[:, 32:] & 0xF) | (((h_ >> 2) & 3) << 4)
        q[:, base + 64 : base + 96] = (l_[:, :32] >> 4) | (((h_ >> 4) & 3) << 4)
        q[:, base + 96 : base + 128] = (l_[:, 32:] >> 4) | (((h_ >> 6) & 3) << 4)
    s = d[:, None] * sc  # (nb, 16), signed
    return q, s, 32.0 * s  # val = s*(q - 32)


_QUANTS = {
    GGMLQuantType.Q4_0: _quants_q4_0,
    GGMLQuantType.Q4_1: _quants_q4_1,
    GGMLQuantType.Q5_0: _quants_q5_0,
    GGMLQuantType.Q5_1: _quants_q5_1,
    GGMLQuantType.Q8_0: _quants_q8_0,
    GGMLQuantType.Q2_K: _quants_q2_K,
    GGMLQuantType.Q3_K: _quants_q3_K,
    GGMLQuantType.Q4_K: _quants_q4_K,
    GGMLQuantType.Q5_K: _quants_q5_K,
    GGMLQuantType.Q6_K: _quants_q6_K,
}


# ---------------------------------------------------------------------------
# Step 2: re-pack integer quants into split-packed planes
# ---------------------------------------------------------------------------


def _split_pack_nibbles(q: np.ndarray) -> np.ndarray:
    """[N, K] low-4-bit values -> [N, K/2]: within each PACK_GROUP columns,
    byte j = elem j | elem (j + PG/2) << 4."""
    n, k = q.shape
    pg = min(PACK_GROUP, k)
    g = q.reshape(n, k // pg, pg)
    return ((g[:, :, : pg // 2] & 0xF) | ((g[:, :, pg // 2 :] & 0xF) << 4)).reshape(n, k // 2)


def _split_pack_bits2(v: np.ndarray) -> np.ndarray:
    """[N, K] 2-bit values -> [N, K/4]: within each PACK_GROUP, byte j packs
    elems j + (PG/4)*i at bit positions 2i."""
    n, k = v.shape
    pg = min(PACK_GROUP, k)
    g = v.reshape(n, k // pg, 4, pg // 4).astype(np.uint32)
    packed = g[:, :, 0] | (g[:, :, 1] << 2) | (g[:, :, 2] << 4) | (g[:, :, 3] << 6)
    return packed.astype(U8).reshape(n, k // 4)


def _split_pack_bits1(v: np.ndarray) -> np.ndarray:
    """[N, K] 1-bit values -> [N, K/8]: within each PACK_GROUP, byte j packs
    elems j + (PG/8)*i at bit i."""
    n, k = v.shape
    pg = min(PACK_GROUP, k)
    g = v.reshape(n, k // pg, 8, pg // 8).astype(np.uint32)
    packed = np.zeros((n, k // pg, pg // 8), dtype=np.uint32)
    for i in range(8):
        packed |= g[:, :, i] << i
    return packed.astype(U8).reshape(n, k // 8)


def pack(raw: np.ndarray, qtype: GGMLQuantType, shape: tuple[int, int]) -> PackedWeight:
    """Repack a raw ggml payload for an [N, K] row-major weight (numpy)."""
    n, k = shape
    be, bb = QUANT_BLOCK_INFO[qtype]
    if k % be != 0:
        raise ValueError(f"K={k} not a multiple of {qtype.name} block {be}")
    if k % min(PACK_GROUP, k) != 0:
        # split-packed planes need whole pack groups (or K < one group);
        # e.g. Q4_0 with K=288 is a legal ggml payload this layout can't hold
        raise ValueError(
            f"K={k} not a multiple of pack group {min(PACK_GROUP, k)}; "
            f"pad the weight to a {PACK_GROUP}-column multiple"
        )
    bits, group = FORMAT_INFO[qtype]

    q, s, bias = _QUANTS[qtype](np.asarray(raw, dtype=U8))
    q = q.reshape(n, k)
    # scale planes come per block; reshape to [N, K/G]
    s = np.ascontiguousarray(s.reshape(n, k // group).astype(np.float32))
    bias = np.ascontiguousarray(bias.reshape(n, k // group).astype(np.float32))

    qh = None
    if bits == 8:
        qs = np.ascontiguousarray(q.astype(np.int8))
    elif bits == 4:
        qs = _split_pack_nibbles(q)
    elif bits == 5:
        qs = _split_pack_nibbles(q & 0xF)
        qh = _split_pack_bits1(q >> 4)
    elif bits == 6:
        qs = _split_pack_nibbles(q & 0xF)
        qh = _split_pack_bits2(q >> 4)
    elif bits == 3:
        qs = _split_pack_bits2(q & 3)
        qh = _split_pack_bits1(q >> 2)
    elif bits == 2:
        qs = _split_pack_bits2(q)
    else:  # pragma: no cover
        raise NotImplementedError(bits)
    return PackedWeight(qtype, (n, k), np.ascontiguousarray(qs), qh, s, bias)


def pack_array(x: np.ndarray, qtype: GGMLQuantType) -> PackedWeight:
    """Quantize a float [N, K] array and repack it (for tests/synthetic models)."""
    from . import formats

    raw = formats.quantize(np.ascontiguousarray(x, dtype=np.float32).reshape(-1), qtype)
    return pack(raw, qtype, x.shape)


# ---------------------------------------------------------------------------
# Reference unpack (numpy) — golden model for the jnp/Pallas unpackers
# ---------------------------------------------------------------------------


def unpack_quants(pw: PackedWeight) -> np.ndarray:
    """Decode a PackedWeight's integer quants to int16 [N, K] (0..63 for
    k-quants, -128..127 for Q8_0) — the i8-planar device layout source."""
    n, k = pw.shape
    bits = pw.bits
    pg = min(PACK_GROUP, k)
    if bits == 8:
        return pw.qs.astype(np.int16).reshape(n, k)
    if bits in (4, 5, 6):
        b = pw.qs.reshape(n, k // pg, pg // 2)
        q = np.concatenate([b & 0xF, b >> 4], axis=2).astype(np.int16)
    else:
        b = pw.qs.reshape(n, k // pg, pg // 4)
        q = np.concatenate([(b >> (2 * i)) & 3 for i in range(4)], axis=2).astype(np.int16)
    if bits == 5:
        h = pw.qh.reshape(n, k // pg, pg // 8)
        hb = np.concatenate([(h >> i) & 1 for i in range(8)], axis=2)
        q = q | (hb << 4)
    elif bits == 6:
        h = pw.qh.reshape(n, k // pg, pg // 4)
        hb = np.concatenate([(h >> (2 * i)) & 3 for i in range(4)], axis=2)
        q = q | (hb << 4)
    elif bits == 3:
        h = pw.qh.reshape(n, k // pg, pg // 8)
        hb = np.concatenate([(h >> i) & 1 for i in range(8)], axis=2)
        q = q | (hb << 2)
    return q.reshape(n, k)


def unpack_to_float(pw: PackedWeight) -> np.ndarray:
    """Decode a PackedWeight back to float32 [N, K]. Matches
    formats.dequantize of the original payload bit-for-bit."""
    n, k = pw.shape
    bits = pw.bits
    pg = min(PACK_GROUP, k)
    if bits == 8:
        q = pw.qs.astype(np.float32)
    else:
        if bits in (4, 5, 6):
            b = pw.qs.reshape(n, k // pg, pg // 2)
            lo = np.concatenate([b & 0xF, b >> 4], axis=2)  # [n, groups, pg]
            q = lo
        else:  # 2/3-bit base plane
            b = pw.qs.reshape(n, k // pg, pg // 4)
            q = np.concatenate([(b >> (2 * i)) & 3 for i in range(4)], axis=2)
        if bits == 5:
            h = pw.qh.reshape(n, k // pg, pg // 8)
            hb = np.concatenate([(h >> i) & 1 for i in range(8)], axis=2)
            q = q | (hb << 4)
        elif bits == 6:
            h = pw.qh.reshape(n, k // pg, pg // 4)
            hb = np.concatenate([(h >> (2 * i)) & 3 for i in range(4)], axis=2)
            q = q | (hb << 4)
        elif bits == 3:
            h = pw.qh.reshape(n, k // pg, pg // 8)
            hb = np.concatenate([(h >> i) & 1 for i in range(8)], axis=2)
            q = q | (hb << 2)
        q = q.reshape(n, k).astype(np.float32)
    s = np.repeat(pw.scales, pw.group, axis=1)
    bias = np.repeat(pw.bias, pw.group, axis=1)
    return s * q - bias
