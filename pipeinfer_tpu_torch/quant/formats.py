"""Bit-exact numpy implementations of the ggml block-quant formats.

Decode (dequantize) matches the reference bit-for-bit
(ref: ggml-quants.c `dequantize_row_*`, struct layouts in ggml-quants.h:10-166)
so real GGUF files load identically. Encode (quantize) produces *valid*
encodings with simple direct min/max fitting; the reference's iterative
least-squares quantizers (make_qx_quants etc.) pick marginally better scales,
but any valid encoding decodes identically everywhere. Round-trip error
tolerances are enforced in tests (mirroring tests/test-quantize-fns.cpp).

All functions operate on flat float32 arrays whose length is a multiple of
the block size; payloads are flat uint8 arrays.
"""

from __future__ import annotations

import numpy as np

from ..gguf.constants import GGMLQuantType, QUANT_BLOCK_INFO, QK_K

F16 = np.float16
U8 = np.uint8


def _f16_bytes(x: np.ndarray) -> np.ndarray:
    """float array -> fp16 little-endian byte pairs, shape (..., 2)."""
    return x.astype(F16).view(U8).reshape(*x.shape, 2)


def _read_f16(raw2: np.ndarray) -> np.ndarray:
    """(..., 2) uint8 -> float32."""
    return np.ascontiguousarray(raw2).view(F16).reshape(raw2.shape[:-1]).astype(np.float32)


def _round_half_away(x: np.ndarray) -> np.ndarray:
    """C roundf semantics: round half away from zero."""
    return np.trunc(x + np.copysign(0.5, x))


def _blocks(raw: np.ndarray, qtype: GGMLQuantType) -> np.ndarray:
    _, bb = QUANT_BLOCK_INFO[qtype]
    if raw.size % bb != 0:
        raise ValueError(f"payload size {raw.size} not a multiple of {bb} for {qtype.name}")
    return raw.reshape(-1, bb)


# ---------------------------------------------------------------------------
# Q4_0 / Q4_1 / Q5_0 / Q5_1 / Q8_0  (32-element blocks)
# ---------------------------------------------------------------------------


def dequantize_q4_0(raw: np.ndarray) -> np.ndarray:
    b = _blocks(raw, GGMLQuantType.Q4_0)
    d = _read_f16(b[:, 0:2])[:, None]
    qs = b[:, 2:18]
    lo = (qs & 0xF).astype(np.int8) - 8
    hi = (qs >> 4).astype(np.int8) - 8
    return (np.concatenate([lo, hi], axis=1) * d).astype(np.float32).reshape(-1)


def quantize_q4_0(x: np.ndarray) -> np.ndarray:
    xb = x.reshape(-1, 32).astype(np.float32)
    idx = np.argmax(np.abs(xb), axis=1)
    mx = xb[np.arange(len(xb)), idx]  # signed value of largest magnitude
    d = mx / -8.0
    id_ = np.where(d != 0.0, 1.0 / np.where(d == 0, 1, d), 0.0)
    q = np.minimum(15, (xb * id_[:, None] + 8.5).astype(np.int8)).astype(U8)
    lo, hi = q[:, :16], q[:, 16:]
    out = np.empty((len(xb), 18), dtype=U8)
    out[:, 0:2] = _f16_bytes(d)
    out[:, 2:18] = lo | (hi << 4)
    return out.reshape(-1)


def dequantize_q4_1(raw: np.ndarray) -> np.ndarray:
    b = _blocks(raw, GGMLQuantType.Q4_1)
    d = _read_f16(b[:, 0:2])[:, None]
    m = _read_f16(b[:, 2:4])[:, None]
    qs = b[:, 4:20]
    lo = (qs & 0xF).astype(np.float32)
    hi = (qs >> 4).astype(np.float32)
    return (np.concatenate([lo, hi], axis=1) * d + m).astype(np.float32).reshape(-1)


def quantize_q4_1(x: np.ndarray) -> np.ndarray:
    xb = x.reshape(-1, 32).astype(np.float32)
    mn = xb.min(axis=1)
    mx = xb.max(axis=1)
    d = (mx - mn) / 15.0
    id_ = np.where(d != 0.0, 1.0 / np.where(d == 0, 1, d), 0.0)
    q = np.minimum(15, ((xb - mn[:, None]) * id_[:, None] + 0.5).astype(np.int8)).astype(U8)
    out = np.empty((len(xb), 20), dtype=U8)
    out[:, 0:2] = _f16_bytes(d)
    out[:, 2:4] = _f16_bytes(mn)
    out[:, 4:20] = q[:, :16] | (q[:, 16:] << 4)
    return out.reshape(-1)


def _qh_to_bits(qh_bytes: np.ndarray) -> np.ndarray:
    """(nb, 4) uint8 -> (nb, 32) of 0/1 bits, bit j of the uint32 per element j."""
    qh = np.ascontiguousarray(qh_bytes).view("<u4").reshape(-1)
    shifts = np.arange(32, dtype=np.uint32)
    return ((qh[:, None] >> shifts[None, :]) & 1).astype(U8)


def _bits_to_qh(bits: np.ndarray) -> np.ndarray:
    """(nb, 32) of 0/1 -> (nb, 4) uint8 little-endian uint32."""
    shifts = np.arange(32, dtype=np.uint32)
    qh = (bits.astype(np.uint32) << shifts[None, :]).sum(axis=1, dtype=np.uint32)
    return qh.astype("<u4").view(U8).reshape(-1, 4)


def dequantize_q5_0(raw: np.ndarray) -> np.ndarray:
    b = _blocks(raw, GGMLQuantType.Q5_0)
    d = _read_f16(b[:, 0:2])[:, None]
    hbits = _qh_to_bits(b[:, 2:6])  # bit j -> element j
    qs = b[:, 6:22]
    lo = (qs & 0xF).astype(np.int16) | (hbits[:, :16] << 4)
    hi = (qs >> 4).astype(np.int16) | (hbits[:, 16:] << 4)
    q = np.concatenate([lo, hi], axis=1).astype(np.float32) - 16.0
    return (q * d).astype(np.float32).reshape(-1)


def quantize_q5_0(x: np.ndarray) -> np.ndarray:
    xb = x.reshape(-1, 32).astype(np.float32)
    idx = np.argmax(np.abs(xb), axis=1)
    mx = xb[np.arange(len(xb)), idx]
    d = mx / -16.0
    id_ = np.where(d != 0.0, 1.0 / np.where(d == 0, 1, d), 0.0)
    q = np.minimum(31, (xb * id_[:, None] + 16.5).astype(np.int8)).astype(U8)
    out = np.empty((len(xb), 22), dtype=U8)
    out[:, 0:2] = _f16_bytes(d)
    out[:, 2:6] = _bits_to_qh(q >> 4)
    out[:, 6:22] = (q[:, :16] & 0xF) | ((q[:, 16:] & 0xF) << 4)
    return out.reshape(-1)


def dequantize_q5_1(raw: np.ndarray) -> np.ndarray:
    b = _blocks(raw, GGMLQuantType.Q5_1)
    d = _read_f16(b[:, 0:2])[:, None]
    m = _read_f16(b[:, 2:4])[:, None]
    hbits = _qh_to_bits(b[:, 4:8])
    qs = b[:, 8:24]
    lo = (qs & 0xF).astype(np.int16) | (hbits[:, :16] << 4)
    hi = (qs >> 4).astype(np.int16) | (hbits[:, 16:] << 4)
    q = np.concatenate([lo, hi], axis=1).astype(np.float32)
    return (q * d + m).astype(np.float32).reshape(-1)


def quantize_q5_1(x: np.ndarray) -> np.ndarray:
    xb = x.reshape(-1, 32).astype(np.float32)
    mn = xb.min(axis=1)
    mx = xb.max(axis=1)
    d = (mx - mn) / 31.0
    id_ = np.where(d != 0.0, 1.0 / np.where(d == 0, 1, d), 0.0)
    q = np.minimum(31, ((xb - mn[:, None]) * id_[:, None] + 0.5).astype(np.int8)).astype(U8)
    out = np.empty((len(xb), 24), dtype=U8)
    out[:, 0:2] = _f16_bytes(d)
    out[:, 2:4] = _f16_bytes(mn)
    out[:, 4:8] = _bits_to_qh(q >> 4)
    out[:, 8:24] = (q[:, :16] & 0xF) | ((q[:, 16:] & 0xF) << 4)
    return out.reshape(-1)


def dequantize_q8_0(raw: np.ndarray) -> np.ndarray:
    b = _blocks(raw, GGMLQuantType.Q8_0)
    d = _read_f16(b[:, 0:2])[:, None]
    q = b[:, 2:34].view(np.int8).astype(np.float32)
    return (q * d).astype(np.float32).reshape(-1)


def quantize_q8_0(x: np.ndarray) -> np.ndarray:
    xb = x.reshape(-1, 32).astype(np.float32)
    amax = np.abs(xb).max(axis=1)
    d = amax / 127.0
    id_ = np.where(d != 0.0, 1.0 / np.where(d == 0, 1, d), 0.0)
    q = _round_half_away(xb * id_[:, None]).astype(np.int8)
    out = np.empty((len(xb), 34), dtype=U8)
    out[:, 0:2] = _f16_bytes(d)
    out[:, 2:34] = q.view(U8)
    return out.reshape(-1)


# ---------------------------------------------------------------------------
# K-quants (256-element super-blocks)
# ---------------------------------------------------------------------------


def _unpack_scale_min_k4(scales: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """12-byte packed 6-bit scales/mins -> (sc, m) each (nb, 8).

    Bit layout per get_scale_min_k4 (ref: ggml-quants.c:1446-1453).
    """
    s = scales.astype(np.int32)
    sc = np.empty((len(s), 8), dtype=np.int32)
    m = np.empty((len(s), 8), dtype=np.int32)
    j = np.arange(4)
    sc[:, :4] = s[:, j] & 63
    m[:, :4] = s[:, j + 4] & 63
    sc[:, 4:] = (s[:, j + 8] & 0xF) | ((s[:, j] >> 6) << 4)
    m[:, 4:] = (s[:, j + 8] >> 4) | ((s[:, j + 4] >> 6) << 4)
    return sc, m


def _pack_scale_min_k4(sc: np.ndarray, m: np.ndarray) -> np.ndarray:
    """(nb, 8) 6-bit scales/mins -> (nb, 12) packed bytes (inverse of above)."""
    sc = sc.astype(np.uint32)
    m = m.astype(np.uint32)
    out = np.zeros((len(sc), 12), dtype=U8)
    j = np.arange(4)
    out[:, 0:4] = ((sc[:, :4] & 63) | ((sc[:, 4:] >> 4) << 6)).astype(U8)
    out[:, 4:8] = ((m[:, :4] & 63) | ((m[:, 4:] >> 4) << 6)).astype(U8)
    out[:, 8:12] = ((sc[:, 4:] & 0xF) | ((m[:, 4:] & 0xF) << 4)).astype(U8)
    del j
    return out


def dequantize_q2_K(raw: np.ndarray) -> np.ndarray:
    b = _blocks(raw, GGMLQuantType.Q2_K)
    nb = len(b)
    scales = b[:, 0:16]
    qs = b[:, 16:80]
    d = _read_f16(b[:, 80:82])
    dmin = _read_f16(b[:, 82:84])

    # 2-bit quants: qs bytes n//4..n//4+32 hold groups at shifts 0,2,4,6
    q = np.empty((nb, 256), dtype=U8)
    for half in range(2):  # elements [0,128) and [128,256)
        src = qs[:, half * 32 : half * 32 + 32]
        for j in range(4):
            grp = (src >> (2 * j)) & 3
            q[:, half * 128 + 32 * j : half * 128 + 32 * (j + 1)] = grp
    sc = (scales & 0xF).astype(np.float32)  # (nb, 16) per-16-group scales
    mn = (scales >> 4).astype(np.float32)
    dl = d[:, None] * sc  # (nb, 16)
    ml = dmin[:, None] * mn
    qf = q.reshape(nb, 16, 16).astype(np.float32)
    y = dl[:, :, None] * qf - ml[:, :, None]
    return y.reshape(-1).astype(np.float32)


def quantize_q2_K(x: np.ndarray) -> np.ndarray:
    xb = x.reshape(-1, QK_K).astype(np.float32)
    nb = len(xb)
    g = xb.reshape(nb, 16, 16)
    gmin = np.minimum(g.min(axis=2), 0.0)
    gmax = g.max(axis=2)
    sc_f = np.maximum(gmax - gmin, 0.0) / 3.0  # per-group scale
    m_f = -gmin  # per-group (positive) min
    d = sc_f.max(axis=1) / 15.0
    dmin = m_f.max(axis=1) / 15.0
    inv_d = np.where(d > 0, 1.0 / np.where(d == 0, 1, d), 0.0)
    inv_m = np.where(dmin > 0, 1.0 / np.where(dmin == 0, 1, dmin), 0.0)
    sc_q = np.clip(np.round(sc_f * inv_d[:, None]), 0, 15).astype(np.int32)
    m_q = np.clip(np.round(m_f * inv_m[:, None]), 0, 15).astype(np.int32)
    D = d[:, None, None] * sc_q[:, :, None]
    M = dmin[:, None, None] * m_q[:, :, None]
    with np.errstate(divide="ignore", invalid="ignore"):
        q = np.where(D > 0, np.round((g + M) / np.where(D == 0, 1, D)), 0.0)
    q = np.clip(q, 0, 3).astype(U8).reshape(nb, 256)

    out = np.empty((nb, 84), dtype=U8)
    out[:, 0:16] = (sc_q | (m_q << 4)).astype(U8)
    qs = np.zeros((nb, 64), dtype=U8)
    for half in range(2):
        for j in range(4):
            grp = q[:, half * 128 + 32 * j : half * 128 + 32 * (j + 1)]
            qs[:, half * 32 : half * 32 + 32] |= grp << (2 * j)
    out[:, 16:80] = qs
    out[:, 80:82] = _f16_bytes(d)
    out[:, 82:84] = _f16_bytes(dmin)
    return out.reshape(-1)


def _unpack_q3k_scales(sb: np.ndarray) -> np.ndarray:
    """12 packed bytes -> 16 signed 6-bit scales minus 32, (nb, 16) int32.

    Byte-level equivalent of the aux[] shuffle in dequantize_row_q3_K
    (ref: ggml-quants.c kmask unpacking).
    """
    s = sb.astype(np.int32)
    k = np.arange(4)
    out = np.empty((len(s), 16), dtype=np.int32)
    out[:, 0:4] = (s[:, k] & 0xF) | ((s[:, k + 8] & 3) << 4)
    out[:, 4:8] = (s[:, k + 4] & 0xF) | (((s[:, k + 8] >> 2) & 3) << 4)
    out[:, 8:12] = (s[:, k] >> 4) | (((s[:, k + 8] >> 4) & 3) << 4)
    out[:, 12:16] = (s[:, k + 4] >> 4) | (((s[:, k + 8] >> 6) & 3) << 4)
    return out - 32


def _pack_q3k_scales(sc: np.ndarray) -> np.ndarray:
    """(nb, 16) values in [-32, 31] -> (nb, 12) packed bytes."""
    u = (sc + 32).astype(np.uint32)
    out = np.zeros((len(u), 12), dtype=U8)
    k = np.arange(4)
    out[:, 0:4] = ((u[:, 0:4] & 0xF) | ((u[:, 8:12] & 0xF) << 4)).astype(U8)
    out[:, 4:8] = ((u[:, 4:8] & 0xF) | ((u[:, 12:16] & 0xF) << 4)).astype(U8)
    out[:, 8:12] = (
        (u[:, 0:4] >> 4)
        | ((u[:, 4:8] >> 4) << 2)
        | ((u[:, 8:12] >> 4) << 4)
        | ((u[:, 12:16] >> 4) << 6)
    ).astype(U8)
    del k
    return out


def dequantize_q3_K(raw: np.ndarray) -> np.ndarray:
    b = _blocks(raw, GGMLQuantType.Q3_K)
    nb = len(b)
    hmask = b[:, 0:32]
    qs = b[:, 32:96]
    scales = _unpack_q3k_scales(b[:, 96:108]).astype(np.float32)
    d = _read_f16(b[:, 108:110])

    q = np.empty((nb, 256), dtype=np.int8)
    for half in range(2):
        src = qs[:, half * 32 : half * 32 + 32]
        for j in range(4):
            grp32 = half * 4 + j  # 32-element group index 0..7
            lo = ((src >> (2 * j)) & 3).astype(np.int8)
            hbit = ((hmask >> grp32) & 1).astype(np.int8)  # all 32 bytes
            q[:, 128 * half + 32 * j : 128 * half + 32 * (j + 1)] = lo - np.where(hbit == 1, 0, 4)
    dl = d[:, None] * scales  # (nb, 16)
    y = dl[:, :, None] * q.reshape(nb, 16, 16).astype(np.float32)
    return y.reshape(-1).astype(np.float32)


def quantize_q3_K(x: np.ndarray) -> np.ndarray:
    xb = x.reshape(-1, QK_K).astype(np.float32)
    nb = len(xb)
    g = xb.reshape(nb, 16, 16)
    amax = np.abs(g).max(axis=2)
    sc_f = amax / 4.0  # quants span [-4, 3]
    dmax = np.abs(sc_f).max(axis=1)
    d = dmax / 31.0
    inv_d = np.where(d > 0, 1.0 / np.where(d == 0, 1, d), 0.0)
    sc_q = np.clip(np.round(sc_f * inv_d[:, None]), -32, 31).astype(np.int32)
    D = d[:, None, None] * sc_q[:, :, None].astype(np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        q = np.where(np.abs(D) > 0, np.round(g / np.where(D == 0, 1, D)), 0.0)
    q = (np.clip(q, -4, 3) + 4).astype(U8).reshape(nb, 256)  # [0, 7]

    out = np.empty((nb, 110), dtype=U8)
    hmask = np.zeros((nb, 32), dtype=U8)
    qs = np.zeros((nb, 64), dtype=U8)
    for half in range(2):
        for j in range(4):
            grp32 = half * 4 + j
            grp = q[:, 128 * half + 32 * j : 128 * half + 32 * (j + 1)]
            qs[:, half * 32 : half * 32 + 32] |= (grp & 3) << (2 * j)
            hmask |= (grp >> 2) << grp32
    out[:, 0:32] = hmask
    out[:, 32:96] = qs
    out[:, 96:108] = _pack_q3k_scales(sc_q)
    out[:, 108:110] = _f16_bytes(d)
    return out.reshape(-1)


def dequantize_q4_K(raw: np.ndarray) -> np.ndarray:
    b = _blocks(raw, GGMLQuantType.Q4_K)
    nb = len(b)
    d = _read_f16(b[:, 0:2])
    dmin = _read_f16(b[:, 2:4])
    sc, m = _unpack_scale_min_k4(b[:, 4:16])  # (nb, 8)
    qs = b[:, 16:144]

    y = np.empty((nb, 256), dtype=np.float32)
    for j in range(4):  # 64-element chunks
        src = qs[:, 32 * j : 32 * (j + 1)]
        lo = (src & 0xF).astype(np.float32)
        hi = (src >> 4).astype(np.float32)
        d1 = (d * sc[:, 2 * j])[:, None]
        m1 = (dmin * m[:, 2 * j])[:, None]
        d2 = (d * sc[:, 2 * j + 1])[:, None]
        m2 = (dmin * m[:, 2 * j + 1])[:, None]
        y[:, 64 * j : 64 * j + 32] = d1 * lo - m1
        y[:, 64 * j + 32 : 64 * j + 64] = d2 * hi - m2
    return y.reshape(-1)


def _fit_affine_groups(g: np.ndarray, qmax: int, smax: int):
    """Shared direct quantizer for q4_K/q5_K: per-group affine x ~= D*q - M.

    g: (nb, ngroup, gsize). Returns (d, dmin, sc_q, m_q, q).
    """
    nb = g.shape[0]
    gmin = np.minimum(g.min(axis=2), 0.0)
    gmax = g.max(axis=2)
    sc_f = np.maximum(gmax - gmin, 0.0) / qmax
    m_f = -gmin
    d = sc_f.max(axis=1) / smax
    dmin = m_f.max(axis=1) / smax
    inv_d = np.where(d > 0, 1.0 / np.where(d == 0, 1, d), 0.0)
    inv_m = np.where(dmin > 0, 1.0 / np.where(dmin == 0, 1, dmin), 0.0)
    sc_q = np.clip(np.round(sc_f * inv_d[:, None]), 0, smax).astype(np.int32)
    m_q = np.clip(np.round(m_f * inv_m[:, None]), 0, smax).astype(np.int32)
    # keep f32: int32 operands would promote to f64 and this host's numpy
    # does dtype CONVERSIONS at ~2M elem/s (scalar fallback)
    D = d[:, None, None] * sc_q.astype(np.float32)[:, :, None]
    M = dmin[:, None, None] * m_q.astype(np.float32)[:, :, None]
    with np.errstate(divide="ignore", invalid="ignore"):
        qv = np.where(D > 0, (g + M) / np.where(D == 0, 1, D), np.float32(0.0))
    q = np.clip(np.round(qv), 0, qmax).astype(U8)
    q = q.reshape(nb, -1)
    return d, dmin, sc_q, m_q, q


def quantize_q4_K(x: np.ndarray) -> np.ndarray:
    xb = x.reshape(-1, QK_K).astype(np.float32)
    nb = len(xb)
    d, dmin, sc_q, m_q, q = _fit_affine_groups(xb.reshape(nb, 8, 32), 15, 63)
    out = np.empty((nb, 144), dtype=U8)
    out[:, 0:2] = _f16_bytes(d)
    out[:, 2:4] = _f16_bytes(dmin)
    out[:, 4:16] = _pack_scale_min_k4(sc_q, m_q)
    q = q.reshape(nb, 4, 64)
    out[:, 16:144] = (q[:, :, :32] | (q[:, :, 32:] << 4)).reshape(nb, 128)
    return out.reshape(-1)


def dequantize_q5_K(raw: np.ndarray) -> np.ndarray:
    b = _blocks(raw, GGMLQuantType.Q5_K)
    nb = len(b)
    d = _read_f16(b[:, 0:2])
    dmin = _read_f16(b[:, 2:4])
    sc, m = _unpack_scale_min_k4(b[:, 4:16])
    qh = b[:, 16:48]
    qs = b[:, 48:176]

    y = np.empty((nb, 256), dtype=np.float32)
    for j in range(4):
        src = qs[:, 32 * j : 32 * (j + 1)]
        h1 = ((qh >> (2 * j)) & 1).astype(np.float32) * 16.0
        h2 = ((qh >> (2 * j + 1)) & 1).astype(np.float32) * 16.0
        lo = (src & 0xF).astype(np.float32) + h1
        hi = (src >> 4).astype(np.float32) + h2
        d1 = (d * sc[:, 2 * j])[:, None]
        m1 = (dmin * m[:, 2 * j])[:, None]
        d2 = (d * sc[:, 2 * j + 1])[:, None]
        m2 = (dmin * m[:, 2 * j + 1])[:, None]
        y[:, 64 * j : 64 * j + 32] = d1 * lo - m1
        y[:, 64 * j + 32 : 64 * j + 64] = d2 * hi - m2
    return y.reshape(-1)


def quantize_q5_K(x: np.ndarray) -> np.ndarray:
    xb = x.reshape(-1, QK_K).astype(np.float32)
    nb = len(xb)
    d, dmin, sc_q, m_q, q = _fit_affine_groups(xb.reshape(nb, 8, 32), 31, 63)
    out = np.empty((nb, 176), dtype=U8)
    out[:, 0:2] = _f16_bytes(d)
    out[:, 2:4] = _f16_bytes(dmin)
    out[:, 4:16] = _pack_scale_min_k4(sc_q, m_q)
    q = q.reshape(nb, 4, 64)
    qh = np.zeros((nb, 32), dtype=U8)
    qs = np.empty((nb, 4, 32), dtype=U8)
    for j in range(4):
        lo_g, hi_g = q[:, j, :32], q[:, j, 32:]
        qs[:, j] = (lo_g & 0xF) | ((hi_g & 0xF) << 4)
        qh |= (lo_g >> 4) << (2 * j)
        qh |= (hi_g >> 4) << (2 * j + 1)
    out[:, 16:48] = qh
    out[:, 48:176] = qs.reshape(nb, 128)
    return out.reshape(-1)


def dequantize_q6_K(raw: np.ndarray) -> np.ndarray:
    b = _blocks(raw, GGMLQuantType.Q6_K)
    nb = len(b)
    ql = b[:, 0:128]
    qh = b[:, 128:192]
    scales = b[:, 192:208].view(np.int8).astype(np.float32)  # (nb, 16)
    d = _read_f16(b[:, 208:210])

    q = np.empty((nb, 256), dtype=np.int8)
    for half in range(2):  # elements [0,128) / [128,256)
        l_ = ql[:, 64 * half : 64 * half + 64]
        h_ = qh[:, 32 * half : 32 * half + 32]
        base = 128 * half
        q[:, base + 0 : base + 32] = ((l_[:, :32] & 0xF) | ((h_ & 3) << 4)).astype(np.int8) - 32
        q[:, base + 32 : base + 64] = ((l_[:, 32:] & 0xF) | (((h_ >> 2) & 3) << 4)).astype(np.int8) - 32
        q[:, base + 64 : base + 96] = ((l_[:, :32] >> 4) | (((h_ >> 4) & 3) << 4)).astype(np.int8) - 32
        q[:, base + 96 : base + 128] = ((l_[:, 32:] >> 4) | (((h_ >> 6) & 3) << 4)).astype(np.int8) - 32
    dl = d[:, None] * scales  # (nb, 16)
    y = dl[:, :, None] * q.reshape(nb, 16, 16).astype(np.float32)
    return y.reshape(-1).astype(np.float32)


def quantize_q6_K(x: np.ndarray) -> np.ndarray:
    xb = x.reshape(-1, QK_K).astype(np.float32)
    nb = len(xb)
    g = xb.reshape(nb, 16, 16)
    amax = np.abs(g).max(axis=2)
    sc_f = amax / 32.0  # quants span [-32, 31]
    dmax = np.abs(sc_f).max(axis=1)
    d = dmax / 127.0
    inv_d = np.where(d > 0, 1.0 / np.where(d == 0, 1, d), 0.0)
    sc_q = np.clip(np.round(sc_f * inv_d[:, None]), -128, 127).astype(np.int8)
    D = d[:, None, None] * sc_q[:, :, None].astype(np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        qv = np.where(np.abs(D) > 0, g / np.where(D == 0, 1, D), 0.0)
    q = (np.clip(np.round(qv), -32, 31) + 32).astype(U8)
    q = q.reshape(nb, 256)  # [0, 63]

    out = np.empty((nb, 210), dtype=U8)
    for half in range(2):
        base = 128 * half
        g0 = q[:, base : base + 32]
        g1 = q[:, base + 32 : base + 64]
        g2 = q[:, base + 64 : base + 96]
        g3 = q[:, base + 96 : base + 128]
        out[:, 64 * half : 64 * half + 32] = (g0 & 0xF) | ((g2 & 0xF) << 4)
        out[:, 64 * half + 32 : 64 * half + 64] = (g1 & 0xF) | ((g3 & 0xF) << 4)
        out[:, 128 + 32 * half : 128 + 32 * half + 32] = (
            (g0 >> 4) | ((g1 >> 4) << 2) | ((g2 >> 4) << 4) | ((g3 >> 4) << 6)
        )
    out[:, 192:208] = sc_q.view(U8)
    out[:, 208:210] = _f16_bytes(d)
    return out.reshape(-1)


def dequantize_q8_K(raw: np.ndarray) -> np.ndarray:
    b = _blocks(raw, GGMLQuantType.Q8_K)
    d = np.ascontiguousarray(b[:, 0:4]).view(np.float32).reshape(-1, 1)
    q = b[:, 4:260].view(np.int8).astype(np.float32)
    return (q * d).astype(np.float32).reshape(-1)


def quantize_q8_K(x: np.ndarray) -> np.ndarray:
    xb = x.reshape(-1, QK_K).astype(np.float32)
    nb = len(xb)
    amax = np.abs(xb).max(axis=1)
    d = amax / 127.0
    id_ = np.where(d > 0, 1.0 / np.where(d == 0, 1, d), 0.0)
    q = _round_half_away(xb * id_[:, None]).astype(np.int8)
    bsums = q.reshape(nb, 16, 16).astype(np.int32).sum(axis=2).astype("<i2")
    out = np.empty((nb, 292), dtype=U8)
    out[:, 0:4] = d.astype("<f4").view(U8).reshape(nb, 4)
    out[:, 4:260] = q.view(U8)
    out[:, 260:292] = bsums.view(U8).reshape(nb, 32)
    return out.reshape(-1)


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

_DEQUANT = {
    GGMLQuantType.Q4_0: dequantize_q4_0,
    GGMLQuantType.Q4_1: dequantize_q4_1,
    GGMLQuantType.Q5_0: dequantize_q5_0,
    GGMLQuantType.Q5_1: dequantize_q5_1,
    GGMLQuantType.Q8_0: dequantize_q8_0,
    GGMLQuantType.Q2_K: dequantize_q2_K,
    GGMLQuantType.Q3_K: dequantize_q3_K,
    GGMLQuantType.Q4_K: dequantize_q4_K,
    GGMLQuantType.Q5_K: dequantize_q5_K,
    GGMLQuantType.Q6_K: dequantize_q6_K,
    GGMLQuantType.Q8_K: dequantize_q8_K,
}

_QUANT = {
    GGMLQuantType.Q4_0: quantize_q4_0,
    GGMLQuantType.Q4_1: quantize_q4_1,
    GGMLQuantType.Q5_0: quantize_q5_0,
    GGMLQuantType.Q5_1: quantize_q5_1,
    GGMLQuantType.Q8_0: quantize_q8_0,
    GGMLQuantType.Q2_K: quantize_q2_K,
    GGMLQuantType.Q3_K: quantize_q3_K,
    GGMLQuantType.Q4_K: quantize_q4_K,
    GGMLQuantType.Q5_K: quantize_q5_K,
    GGMLQuantType.Q6_K: quantize_q6_K,
    GGMLQuantType.Q8_K: quantize_q8_K,
}


def dequantize(raw: np.ndarray, qtype: GGMLQuantType) -> np.ndarray:
    if qtype == GGMLQuantType.F32:
        return np.ascontiguousarray(raw).view(np.float32)
    if qtype == GGMLQuantType.F16:
        return np.ascontiguousarray(raw).view(np.float16).astype(np.float32)
    return _DEQUANT[qtype](np.asarray(raw, dtype=U8))


def quantize(x: np.ndarray, qtype: GGMLQuantType) -> np.ndarray:
    if qtype == GGMLQuantType.F32:
        return np.ascontiguousarray(x.astype(np.float32)).view(U8)
    if qtype == GGMLQuantType.F16:
        return np.ascontiguousarray(x.astype(np.float16)).view(U8)
    return _QUANT[qtype](np.asarray(x, dtype=np.float32))
