"""Quantized matmul: device planes, activation quantization and the
hand-written kernels of every layout.

Torch counterpart of pipeinfer_tpu.ops.qmatmul. Layouts (QuantTensor.layout):

- "i4g": weights requantized at load to 4 bits on a per-(128-row half-slab,
  column) affine grid (w ~ wmin + step * u, u in [0, 15]), nibble-packed per
  256-row slab: byte p of a slab holds row p (lo nibble) and row p + 128
  (hi nibble). qs u8 [Kp/2, N], step and wmin f32 [Kp/128, N].
- "i8g": weights requantized to s8 with an absmax scale per (512-row slab,
  column). qs s8 [Kp, N], sw f32 [Kp/512, N].
- "k_major": the GGUF block format's own bit-packed planes, transposed to
  [K-ish, N]: exact dequantization (w = s * q - b per group of G rows)
  inside the kernel. qs u8 [K*b/8, N] (s8 [K, N] for Q8_0), qh u8 (the
  high bits of 3/5/6-bit formats), scales and bias f32 [K/G, N].
- "i8": the integer quants widened to s8 [K, N], scales and bias f32
  [K/G, N]; exact.
- "k4" (4-bit formats with K % 256 == 0): the packed nibble plane
  transposed, qs u8 [r2, N] (K/2 rows padded to 256), whose lo and hi
  nibbles act as two K-halves; per-plane scales/bias (lo: scales, bias;
  hi: scales2, bias2) f32 [r2/32, N]; exact.
- "n_major": the raw packed planes kept [N, K-ish] for embedding row
  gathers (``dequant_rows``).

i4g and i8g quantize activations to s8 in plain torch outside the kernels,
with ONE absmax scale per slab shared across all M rows (a per-row scale
would change the verify-batch numerics against the reference); their
kernels run exact s8 x s8 -> s32 dots per slab and scale each slab's
partial sums on the output side. The exact layouts (k_major, i8, k4) take
bf16 activations and, as the TPU kernels do, round each weight to bf16
after the f32 dequantization and accumulate the products in f32. On a CPU
tensor each kernel wrapper runs its plain PyTorch version instead; on a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import torch

from ..gguf.constants import GGMLQuantType
from ..quant.pack import FORMAT_INFO, PACK_GROUP, PackedWeight
from . import cuda_build

I8G_SLAB = 512  # K rows sharing one requant scale
I8G_CHUNK = 128  # K rows of a chunk, the unit of the i8g and i8 kernels' split-K (CHUNK)
I4G_SLAB = 256  # K rows per nibble-packed slab (two 128-row half-slabs)
I4G_HALF = I4G_SLAB // 2
K4_GROUP = 32  # rows of a k4 plane sharing one scale row
LAYOUTS = ("k_major", "n_major", "i8", "k4", "i8g", "i4g")
PLANES = ("qs", "qh", "scales", "bias", "scales2", "bias2")  # QuantTensor's tensor fields


@dataclasses.dataclass
class QuantTensor:
    """Device-side quantized [N, K] weight (see the module docstring for
    the layouts). For i4g, ``scales`` holds step and ``bias`` holds wmin;
    for i8g, ``scales`` holds sw and ``bias`` is empty; ``scales2`` and
    ``bias2`` hold the hi nibble plane's scale and bias for k4 and are None
    for every other layout."""

    qs: torch.Tensor
    qh: torch.Tensor | None
    scales: torch.Tensor
    bias: torch.Tensor
    qtype: GGMLQuantType
    shape: tuple[int, int]  # (N, K)
    layout: str = "i4g"
    scales2: torch.Tensor | None = None
    bias2: torch.Tensor | None = None

    @property
    def bits(self) -> int:
        return FORMAT_INFO[self.qtype][0]

    @property
    def group(self) -> int:
        return FORMAT_INFO[self.qtype][1]

    def nbytes(self) -> int:
        planes = (self.qs, self.qh, self.scales, self.bias, self.scales2, self.bias2)
        return sum(p.numel() * p.element_size() for p in planes if p is not None)


def _unpack_quants_N(qs: torch.Tensor, qh: torch.Tensor | None, *, bits: int, k: int):
    """N-major packed planes (rows [R, cols]) -> integer quants [R, K] int32."""
    r = qs.shape[0]
    pg = min(PACK_GROUP, k)
    if bits == 8:
        return qs.to(torch.int32)
    if bits in (4, 5, 6):
        b = qs.reshape(r, k // pg, pg // 2).to(torch.int32)
        q = torch.cat([b & 0xF, b >> 4], dim=2)
    else:
        b = qs.reshape(r, k // pg, pg // 4).to(torch.int32)
        q = torch.cat([(b >> (2 * i)) & 3 for i in range(4)], dim=2)
    if bits == 5:
        h = qh.reshape(r, k // pg, pg // 8).to(torch.int32)
        q = q | (torch.cat([(h >> i) & 1 for i in range(8)], dim=2) << 4)
    elif bits == 6:
        h = qh.reshape(r, k // pg, pg // 4).to(torch.int32)
        q = q | (torch.cat([(h >> (2 * i)) & 3 for i in range(4)], dim=2) << 4)
    elif bits == 3:
        h = qh.reshape(r, k // pg, pg // 8).to(torch.int32)
        q = q | (torch.cat([(h >> i) & 1 for i in range(8)], dim=2) << 2)
    return q.reshape(r, k)


def _unpack_quants_T(qs: torch.Tensor, qh: torch.Tensor | None, *, bits: int, k: int):
    """K-major packed planes [K-ish, N] -> integer quants W^T [K, N] int32.
    Within a 256-row pack group, 4/5/6-bit nibble row j holds elements j
    (lo) and j + 128 (hi); 2/3-bit row j holds j + 64 i at bits 2i; the
    5/3-bit qh row j gives bit i to element j + 32 i, the 6-bit qh row j
    its 2-bit field i to element j + 64 i."""
    n = qs.shape[1]
    pg = min(PACK_GROUP, k)
    if bits == 8:
        return qs.to(torch.int32)
    if bits in (4, 5, 6):
        b = qs.reshape(k // pg, pg // 2, n).to(torch.int32)
        q = torch.cat([b & 0xF, b >> 4], dim=1)
    else:
        b = qs.reshape(k // pg, pg // 4, n).to(torch.int32)
        q = torch.cat([(b >> (2 * i)) & 3 for i in range(4)], dim=1)
    if bits == 5:
        h = qh.reshape(k // pg, pg // 8, n).to(torch.int32)
        q = q | (torch.cat([(h >> i) & 1 for i in range(8)], dim=1) << 4)
    elif bits == 6:
        h = qh.reshape(k // pg, pg // 4, n).to(torch.int32)
        q = q | (torch.cat([(h >> (2 * i)) & 3 for i in range(4)], dim=1) << 4)
    elif bits == 3:
        h = qh.reshape(k // pg, pg // 8, n).to(torch.int32)
        q = q | (torch.cat([(h >> i) & 1 for i in range(8)], dim=1) << 2)
    return q.reshape(k, n)


def _expand(a: torch.Tensor, group: int, rows: int) -> torch.Tensor:
    """Repeat each row of a per-group plane `group` times; first `rows`."""
    return torch.repeat_interleave(a, group, dim=0)[:rows]


def _dequant_N(qs, qh, scales, bias, *, bits: int, k: int, group: int) -> torch.Tensor:
    """Raw N-major planes -> f32 W [R, K] = s * q - b."""
    q = _unpack_quants_N(qs, qh, bits=bits, k=k).float()
    s = torch.repeat_interleave(scales, group, dim=1)
    b = torch.repeat_interleave(bias, group, dim=1)
    return s * q - b


def _pad_rows(a: torch.Tensor, mult: int) -> torch.Tensor:
    pad = (-a.shape[0]) % mult
    return a if pad == 0 else torch.nn.functional.pad(a, (0, 0, 0, pad))


def _i8g_planes(qs, qh, scales, bias, *, bits: int, k: int, group: int):
    """Raw N-major planes -> (s8 W^T [Kp, N], sw f32 [Kp/512, N]): dequantize,
    then requantize per (512-row slab, column) on an absmax grid."""
    w = _pad_rows(_dequant_N(qs, qh, scales, bias, bits=bits, k=k, group=group).T, I8G_SLAB)
    kp, n = w.shape
    ws = w.reshape(kp // I8G_SLAB, I8G_SLAB, n)
    sw = ws.abs().amax(dim=1).clamp_min(1e-20) / 127.0
    wq = torch.round(ws / sw[:, None, :]).to(torch.int8).reshape(kp, n)
    return wq.contiguous(), sw.contiguous()


def _i4g_planes(qs, qh, scales, bias, *, bits: int, k: int, group: int):
    """Raw N-major planes -> (u8 [Kp/2, N] nibble-packed, step f32 [Kp/128, N],
    wmin f32 [Kp/128, N]): a min/max affine grid per (128-row half-slab,
    column), refined by two rounds of least squares on (step, wmin) given
    the rounded assignments — the same fit as the JAX package's
    _i4g_planes_jit, step for step."""
    w = _pad_rows(_dequant_N(qs, qh, scales, bias, bits=bits, k=k, group=group).T, I4G_SLAB)
    kp, n = w.shape
    hs = I4G_HALF
    ws = w.reshape(kp // hs, hs, n)
    wmin = ws.amin(dim=1)
    step = (ws.amax(dim=1) - wmin).clamp_min(1e-9) / 15.0
    for _ in range(2):
        u = torch.round((ws - wmin[:, None, :]) / step[:, None, :]).clamp(0, 15)
        su = u.sum(dim=1)
        suu = (u * u).sum(dim=1)
        sw = ws.sum(dim=1)
        swu = (ws * u).sum(dim=1)
        det = hs * suu - su * su
        safe = det.abs() > 1e-9
        step_new = torch.where(safe, (hs * swu - su * sw) / torch.where(safe, det, 1.0), step)
        step = step_new.abs().clamp_min(1e-9)
        wmin = (sw - step * su) / hs
    u = torch.round((ws - wmin[:, None, :]) / step[:, None, :]).clamp(0, 15)
    u = u.to(torch.uint8).reshape(kp // I4G_SLAB, I4G_SLAB, n)
    wp = u[:, :hs, :] | (u[:, hs:, :] << 4)
    return wp.reshape(kp // 2, n).contiguous(), step.contiguous(), wmin.contiguous()


def _i8_planes(qs, qh, scales, bias, *, bits: int, k: int):
    """Raw N-major planes -> (s8 W^T [K, N], scales^T, bias^T): the integer
    quants widened to int8, as the JAX package's _i8_planes_jit."""
    q = _unpack_quants_N(qs, qh, bits=bits, k=k).to(torch.int8)
    return q.T.contiguous(), scales.T.contiguous(), bias.T.contiguous()


def _k4_planes(qs, scales, bias):
    """Raw 4-bit N-major planes -> (qs u8 [r2, N], s_lo, s_hi, b_lo, b_hi
    f32 [r2/32, N]), as the JAX package's _k4_planes_jit: byte row p of
    the transpose holds element (p//128)*256 + p%128 (lo nibble) and that
    + 128 (hi); the [N, K/32] scale and bias planes split into per-plane
    tensors in plane-row order (lo row p uses scale row p//32). The byte
    plane is zero-padded to a multiple of 256 rows, the per-plane scales
    to a multiple of 8."""
    n = qs.shape[0]
    qs_t = _pad_rows(qs.T, 256).contiguous()

    def split(a):
        a_t = a.T.reshape(-1, 8, n)  # [K/256, 8, N]: rows 0-3 lo, 4-7 hi
        lo = _pad_rows(a_t[:, :4].reshape(-1, n), 8).contiguous()
        hi = _pad_rows(a_t[:, 4:].reshape(-1, n), 8).contiguous()
        return lo, hi

    s_lo, s_hi = split(scales)
    b_lo, b_hi = split(bias)
    return qs_t, s_lo, s_hi, b_lo, b_hi


def to_device(pw: PackedWeight, layout: str = "i4g", device="cuda") -> QuantTensor:
    """Upload a host PackedWeight in the requested plane layout. Every
    layout is built on `device` from the raw packed planes. As in the
    reference, a 4-bit layout asked of a wider format falls back: i4g
    becomes i8g, and k4 (4-bit and K % 256 only) becomes i8."""
    device = torch.device(device)

    def put(a):
        return None if a is None else torch.from_numpy(a).to(device)

    if layout == "i4g" and pw.bits != 4:
        layout = "i8g"
    if layout == "k4" and (pw.bits != 4 or pw.shape[1] % PACK_GROUP):
        layout = "i8"
    raw = (put(pw.qs), put(pw.qh), put(pw.scales), put(pw.bias))
    if layout in ("i4g", "i8g"):
        kw = dict(bits=pw.bits, k=pw.shape[1], group=FORMAT_INFO[pw.qtype][1])
        if layout == "i4g":
            wp, step, wmin = _i4g_planes(*raw, **kw)
            return QuantTensor(wp, None, step, wmin, pw.qtype, pw.shape, "i4g")
        wq, sw = _i8g_planes(*raw, **kw)
        return QuantTensor(wq, None, sw, sw[:0], pw.qtype, pw.shape, "i8g")
    if layout == "k4":
        qs_t, s_lo, s_hi, b_lo, b_hi = _k4_planes(raw[0], raw[2], raw[3])
        return QuantTensor(qs_t, None, s_lo, b_lo, pw.qtype, pw.shape, "k4", s_hi, b_hi)
    if layout == "i8":
        qs8, s_t, b_t = _i8_planes(*raw, bits=pw.bits, k=pw.shape[1])
        return QuantTensor(qs8, None, s_t, b_t, pw.qtype, pw.shape, "i8")
    if layout == "k_major":
        qs_t, qh_t, s_t, b_t = (None if a is None else a.T.contiguous() for a in raw)
        return QuantTensor(qs_t, qh_t, s_t, b_t, pw.qtype, pw.shape, "k_major")
    if layout == "n_major":
        return QuantTensor(*raw, pw.qtype, pw.shape, "n_major")
    raise ValueError(f"unknown layout {layout!r} (one of {', '.join(LAYOUTS)})")


def dequant_T(qt: QuantTensor, dtype=torch.float32) -> torch.Tensor:
    """Dequantize to W^T [K, N]."""
    n, k = qt.shape
    if qt.layout == "n_major":
        return dequant(qt, dtype).T
    if qt.layout == "k_major":
        q = _unpack_quants_T(qt.qs, qt.qh, bits=qt.bits, k=k).float()
        return (_expand(qt.scales, qt.group, k) * q - _expand(qt.bias, qt.group, k)).to(dtype)
    if qt.layout == "i8":
        q = qt.qs.float()
        return (_expand(qt.scales, qt.group, k) * q - _expand(qt.bias, qt.group, k)).to(dtype)
    if qt.layout == "k4":
        h = k // 2
        wi = qt.qs[:h].to(torch.int32)
        w_lo = _expand(qt.scales, K4_GROUP, h) * (wi & 15).float() - _expand(qt.bias, K4_GROUP, h)
        w_hi = _expand(qt.scales2, K4_GROUP, h) * (wi >> 4).float() - _expand(qt.bias2, K4_GROUP, h)
        w4 = torch.cat([w_lo.reshape(k // 256, 128, n), w_hi.reshape(k // 256, 128, n)], dim=1)
        return w4.reshape(k, n).to(dtype)
    if qt.layout == "i4g":
        kp = qt.qs.shape[0] * 2
        v = qt.qs.to(torch.int32)
        lo = (v & 15).reshape(kp // I4G_SLAB, I4G_HALF, n)
        hi = (v >> 4).reshape(kp // I4G_SLAB, I4G_HALF, n)
        u = torch.cat([lo, hi], dim=1).reshape(kp, n).float()
        step = torch.repeat_interleave(qt.scales, I4G_HALF, dim=0)
        wmin = torch.repeat_interleave(qt.bias, I4G_HALF, dim=0)
        return (wmin + step * u)[:k].to(dtype)
    if qt.layout == "i8g":
        w = qt.qs.float() * torch.repeat_interleave(qt.scales, I8G_SLAB, dim=0)
        return w[:k].to(dtype)
    raise ValueError(f"unknown layout {qt.layout!r}")


def dequant(qt: QuantTensor, dtype=torch.float32) -> torch.Tensor:
    """Dequantize to W [N, K]."""
    if qt.layout == "n_major":
        return _dequant_N(qt.qs, qt.qh, qt.scales, qt.bias, bits=qt.bits,
                          k=qt.shape[1], group=qt.group).to(dtype)
    return dequant_T(qt, dtype).T


def dequant_rows(qt: QuantTensor, rows: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Gather + dequantize selected rows of W (token-embedding lookup).
    Requires the n_major layout, where a row gather is contiguous."""
    if qt.layout != "n_major":
        raise ValueError("dequant_rows needs an n_major QuantTensor (embedding layout)")
    flat = rows.reshape(-1).long()
    qh = qt.qh[flat] if qt.qh is not None else None
    out = _dequant_N(qt.qs[flat], qh, qt.scales[flat], qt.bias[flat],
                     bits=qt.bits, k=qt.shape[1], group=qt.group).to(dtype)
    return out.reshape(*rows.shape, qt.shape[1])


def concat_qt(qts: list[QuantTensor]) -> QuantTensor | None:
    """Concatenate QuantTensors along their output (N) dim: one fused
    tensor for projections that share an input (wq+wk+wv, gate+up), so a
    step launches one kernel instead of several. None when the tensors
    cannot fuse (mixed formats, as Q4_K_M's Q6_K w_v, or mixed layouts).
    Every matmul layout keeps N as the last axis of every plane (qh and
    k4's second planes included), so each plane concatenates along it."""
    first = qts[0]
    if any(q.qtype != first.qtype or q.layout != first.layout
           or q.shape[1] != first.shape[1] for q in qts[1:]):
        return None
    if first.layout == "n_major":
        return None

    def cat(attr):
        planes = [getattr(q, attr) for q in qts]
        return None if any(p is None for p in planes) else torch.cat(planes, dim=1)

    return QuantTensor(
        qs=cat("qs"), qh=cat("qh"), scales=cat("scales"), bias=cat("bias"),
        qtype=first.qtype, shape=(sum(q.shape[0] for q in qts), first.shape[1]),
        layout=first.layout, scales2=cat("scales2"), bias2=cat("bias2"),
    )


# ---------------------------------------------------------------------------
# Activation quantization (plain torch, outside the kernels)
# ---------------------------------------------------------------------------


def quantize_activations(x: torch.Tensor, kp: int, slab: int):
    """x f32 [M, K] -> (xq s8 [M, Kp], sx f32 [Kp/slab]): zero-pad K to Kp,
    then one absmax scale per slab shared across ALL M rows (zero padding
    rows would not change it)."""
    m, k = x.shape
    xp = x.float()
    if kp != k:
        xp = torch.nn.functional.pad(xp, (0, kp - k))
    xs = xp.reshape(m, kp // slab, slab)
    sx = xs.abs().amax(dim=(0, 2)).clamp_min(1e-20) / 127.0
    xq = torch.round(xs / sx[None, :, None]).to(torch.int8).reshape(m, kp)
    return xq, sx


# ---------------------------------------------------------------------------
# i4g kernel: wrapper, plain version, launch counter
# ---------------------------------------------------------------------------
#
# Replaces pipeinfer_tpu/ops/qmatmul.py::_i4g_kernel (wrapper _qmm_i4g_pallas).
# Bound on the H100: bytes. At decode M (1..33) each weight is used M times,
# far under the ~295 operations per byte where the tensor cores would bind,
# so the kernel must stream qs (0.5 B/weight) plus step and wmin (8 B per
# 128 weights) once at the memory rate. Design (csrc/qmatmul_i4g.cu): a
# block of 8 warps takes a 128-column tile (a warp reads 128 contiguous
# bytes of a packed row), up to 8 rows of x, and a range of whole 256-row
# slabs; ``i4g_plan`` cuts K into such ranges (split-K) so that the grid
# fills the card's waves of resident blocks even at N = 4096. Each warp
# takes 16 packed rows of every slab of its range, transposes 4 x 4 byte
# blocks in registers (__byte_perm) into per-column words of 4 K values,
# splits lo/hi nibbles with two masks and feeds __dp4a against the s8
# activations. Each slab's exact integer sums are scaled by step * sx into
# f32 accumulators, and its affine min terms xsum * sx * wmin are added
# into the same accumulators in the same pass. The splits meet in the
# kernel: each writes an f32 partial, and the last block of each tile
# (atomic ticket) sums them in split order, so the output is bitwise
# reproducible (no atomics on it).

I4G_TN = 128  # columns per block (TN in the i4g, i8g, i8, k_major and k4 kernels)
I4G_BLOCKS_PER_SM = 2  # resident blocks per SM the plans count (__launch_bounds__ of all five)
I4G_TICKETS = 4096  # merge counters at the head of the scratch buffer (TICKETS of all five)
I4G_FILL = 0.9  # share of the grid's waves of resident blocks the splits should fill


class I4gPlan(NamedTuple):
    """How the i4g kernel cuts one call: ``rows`` rows of x per block in
    ``row_tiles`` tiles, ``col_tiles`` tiles of I4G_TN columns, and the K
    slabs in ``splits`` ranges of ``slabs`` whole slabs (the last may be
    shorter); the grid is (row_tiles, col_tiles, splits), ``blocks`` in all."""

    rows: int
    row_tiles: int
    col_tiles: int
    splits: int
    slabs: int
    blocks: int


def _split_cut(m: int, n: int, units: int, sms: int) -> tuple[int, int, int, int, int, int]:
    """(rows, row_tiles, col_tiles, splits, units per split, blocks) for x
    [m, K] times a [K, n] weight whose K is `units` whole units (a split
    takes a range of them) on a card with `sms` SMs. The split count is the
    smallest that fills the waves of resident blocks it makes (sms *
    I4G_BLOCKS_PER_SM a wave) to I4G_FILL or more, since a wave the grid
    fills only in part costs as much as a full one; else the one that fills
    them best. A grid that already fills its waves keeps one split and
    needs no merge."""
    rows = 1 if m == 1 else 4 if m <= 4 else 8
    row_tiles = -(-m // rows)
    col_tiles = -(-n // I4G_TN)
    base = row_tiles * col_tiles
    slots = sms * I4G_BLOCKS_PER_SM
    max_splits = units if base <= I4G_TICKETS else 1  # a merge needs one counter per tile
    best = None
    for want in range(1, max_splits + 1):
        per = -(-units // want)
        splits = -(-units // per)
        blocks = base * splits
        fill = blocks / (slots * -(-blocks // slots))
        if best is None or fill > best[0]:
            best = (fill, splits, per)
        if fill >= I4G_FILL:
            break
    _, splits, per = best
    return rows, row_tiles, col_tiles, splits, per, base * splits


@functools.lru_cache(maxsize=1024)
def i4g_plan(m: int, n: int, kp: int, sms: int) -> I4gPlan:
    """The cut for x [m, kp] times an [kp, n] i4g weight on a card with
    `sms` SMs: split-K over whole 256-row slabs (``_split_cut``)."""
    return I4gPlan(*_split_cut(m, n, kp // I4G_SLAB, sms))


_sms: dict = {}
_split_scratch: dict = {}


def _aligned(name: str, **planes) -> None:
    """Raise unless each plane given as (tensor or None, bytes) starts on
    a multiple of that many bytes: the width of the kernel's widest load
    of it."""
    for key, (t, width) in planes.items():
        if t is not None and t.data_ptr() % width:
            raise ValueError(f"{name}: {key} must be {width}-byte aligned")


def _sm_count(device: torch.device) -> int:
    sms = _sms.get(device)
    if sms is None:
        sms = _sms[device] = torch.cuda.get_device_properties(device).multi_processor_count
    return sms


def _split_scratch_for(device: torch.device, n_part: int) -> torch.Tensor:
    """The split-K scratch of the i4g, i8g, i8, k_major and k4 kernels, one
    buffer per (device, stream): I4G_TICKETS int32 merge counters, which
    each kernel leaves zero (so they are zeroed once), then room for
    n_part f32 partials. Calls on one stream never run at the same time,
    so they share it."""
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    buf = _split_scratch.get(key)
    if buf is None or buf.numel() < I4G_TICKETS + n_part:
        buf = _split_scratch[key] = torch.zeros(I4G_TICKETS + max(n_part, 1 << 16),
                                                dtype=torch.int32, device=device)
    return buf


def _i4g_plain(xq, xsum, sx, qs, step, wmin):
    """Plain version of the i4g kernel (same arithmetic, slab by slab:
    one product per half-slab, so [nhalf, M, N] is never held at once, 11
    GB at M = 2048 over a 7B FFN)."""
    m, kp = xq.shape
    n = qs.shape[1]
    nslab = kp // I4G_SLAB
    v = qs.to(torch.int32).reshape(nslab, I4G_HALF, n)
    u = torch.stack([v & 15, v >> 4], dim=1).reshape(2 * nslab, I4G_HALF, n).float()
    xh = xq.float().reshape(m, 2 * nslab, I4G_HALF).transpose(0, 1)  # [nhalf, M, 128]
    # integer dots are exact in f32: |sum| <= 128 * 127 * 15 < 2^24
    se = step * sx[:, None]
    acc = torch.zeros(m, n, dtype=torch.float32, device=xq.device)
    for g in range(2 * nslab):
        acc = acc + (xh[g] @ u[g]) * se[g]
    return acc + xsum @ (wmin * sx[:, None])


def i4g_matmul(xq, xsum, sx, qs, step, wmin) -> torch.Tensor:
    """out f32 [M, N] = sum_g sx[g] * (step[g] * (xq_g . u_g) + wmin[g] * xsum[:, g])
    over the 128-row half-slabs g. xq s8 [M, Kp]; xsum f32 [M, Kp/128];
    sx f32 [Kp/128]; qs u8 [Kp/2, N]; step, wmin f32 [Kp/128, N]."""
    if not xq.is_cuda:
        return _i4g_plain(xq, xsum, sx, qs, step, wmin)
    cuda_build.check_tensors("i4g_matmul", xq=(xq, torch.int8), xsum=(xsum, torch.float32),
                             sx=(sx, torch.float32), qs=(qs, torch.uint8),
                             step=(step, torch.float32), wmin=(wmin, torch.float32))
    m, kp = xq.shape
    n = qs.shape[1]
    nh = kp // I4G_HALF
    if (kp % I4G_SLAB or qs.shape[0] * 2 != kp or n % 4 or xsum.shape != (m, nh)
            or sx.shape != (nh,) or step.shape != (nh, n) or wmin.shape != (nh, n)):
        raise ValueError(f"i4g_matmul: shapes xq {tuple(xq.shape)} xsum {tuple(xsum.shape)} "
                         f"sx {tuple(sx.shape)} qs {tuple(qs.shape)} step {tuple(step.shape)} "
                         f"wmin {tuple(wmin.shape)} do not fit")
    _aligned("i4g_matmul", xq=(xq, 16), step=(step, 16), wmin=(wmin, 16), qs=(qs, 4))
    dev = xq.device
    cut = i4g_plan(m, n, kp, _sm_count(dev))
    scratch = _split_scratch_for(dev, cut.splits * m * n) if cut.splits > 1 else None
    out = torch.empty(m, n, dtype=torch.float32, device=dev)
    cuda_build.launch("qmatmul_i4g", "pi_i4g_matmul", xq, xsum, sx, qs, step, wmin, out, scratch,
                      m, n, kp, cut.rows, cut.slabs, cut.splits, count=i4g_matmul)
    i4g_matmul.last_plan = cut
    return out


i4g_matmul.launches = 0
i4g_matmul.last_plan = None  # the cut of its last launch


def qmm_i4g(x: torch.Tensor, qt: QuantTensor) -> torch.Tensor:
    """y = x @ W^T for the i4g layout: quantize activations per 128-row
    half-slab (one scale across all rows), then the i4g kernel."""
    kp = qt.qs.shape[0] * 2
    xq, sx = quantize_activations(x, kp, I4G_HALF)
    xsum = xq.reshape(x.shape[0], kp // I4G_HALF, I4G_HALF).sum(dim=2, dtype=torch.int32).float()
    return i4g_matmul(xq, xsum, sx, qt.qs, qt.scales, qt.bias)


# ---------------------------------------------------------------------------
# i8g kernel: wrapper, plain version, launch counter
# ---------------------------------------------------------------------------
#
# Replaces pipeinfer_tpu/ops/qmatmul.py::_i8g_kernel (wrapper _qmm_i8g_pallas).
# Bound on the H100: bytes. At decode M each s8 weight (1 B, plus 4 B of sw
# per 512 weights) is used M times, far under the ~295 operations per byte
# where the tensor cores would bind, so the kernel must stream qs once at
# the memory rate. Design (csrc/qmatmul_i8g.cu), the i4g kernel's without
# the nibble split or the min term: a block of 8 warps takes a 128-column
# tile (a warp load is one 128-byte line of one s8 row), up to 8 rows of x,
# and a range of whole 128-row chunks (four to a 512-row slab); ``i8g_plan``
# cuts K into such ranges (split-K) so that the grid fills the card's waves
# of resident blocks even at N = 4096. In each chunk warp w takes rows
# [16 w, 16 w + 16): it transposes 4 x 4 byte blocks of its 16 words in
# registers (__byte_perm), loads the chunk's x rows (16 bytes a row), issues
# the next chunk's 16 word loads, and only then feeds __dp4a, so the stream
# goes on while 8 rows of x are summed; each chunk's exact integer sums are
# scaled by sw * sx of its slab into f32 accumulators. The splits meet as
# i4g's do: f32 partials summed in split order by the last block of each
# tile (atomic ticket), so the output is bitwise reproducible.


class I8gPlan(NamedTuple):
    """How the i8g kernel cuts one call: as I4gPlan, with K in ``splits``
    ranges of ``chunks`` whole 128-row chunks (the last may be shorter)."""

    rows: int
    row_tiles: int
    col_tiles: int
    splits: int
    chunks: int
    blocks: int


@functools.lru_cache(maxsize=1024)
def i8g_plan(m: int, n: int, kp: int, sms: int) -> I8gPlan:
    """The cut for x [m, kp] times an [kp, n] i8g weight on a card with
    `sms` SMs: split-K over whole 128-row chunks (``_split_cut``)."""
    return I8gPlan(*_split_cut(m, n, kp // I8G_CHUNK, sms))


def _i8g_plain(xq, sx, qs, sw):
    """Plain version of the i8g kernel (same arithmetic, slab by slab:
    one product per slab, as in _i4g_plain)."""
    m, kp = xq.shape
    n = qs.shape[1]
    nslab = kp // I8G_SLAB
    xs = xq.float().reshape(m, nslab, I8G_SLAB).transpose(0, 1)  # [nslab, M, 512]
    w = qs.float().reshape(nslab, I8G_SLAB, n)
    # integer dots are exact in f32: |sum| <= 512 * 127 * 127 < 2^24
    se = sw * sx[:, None]
    acc = torch.zeros(m, n, dtype=torch.float32, device=xq.device)
    for s in range(nslab):
        acc = acc + (xs[s] @ w[s]) * se[s]
    return acc


def i8g_matmul(xq, sx, qs, sw) -> torch.Tensor:
    """out f32 [M, N] = sum_s sx[s] * sw[s] * (xq_s . qs_s) over 512-row slabs.
    xq s8 [M, Kp]; sx f32 [Kp/512]; qs s8 [Kp, N]; sw f32 [Kp/512, N]."""
    if not xq.is_cuda:
        return _i8g_plain(xq, sx, qs, sw)
    cuda_build.check_tensors("i8g_matmul", xq=(xq, torch.int8), sx=(sx, torch.float32),
                             qs=(qs, torch.int8), sw=(sw, torch.float32))
    m, kp = xq.shape
    n = qs.shape[1]
    ns = kp // I8G_SLAB
    if kp % I8G_SLAB or qs.shape[0] != kp or n % 4 or sx.shape != (ns,) or sw.shape != (ns, n):
        raise ValueError(f"i8g_matmul: shapes xq {tuple(xq.shape)} sx {tuple(sx.shape)} "
                         f"qs {tuple(qs.shape)} sw {tuple(sw.shape)} do not fit")
    _aligned("i8g_matmul", xq=(xq, 16), sw=(sw, 16), qs=(qs, 4))
    dev = xq.device
    cut = i8g_plan(m, n, kp, _sm_count(dev))
    scratch = _split_scratch_for(dev, cut.splits * m * n) if cut.splits > 1 else None
    out = torch.empty(m, n, dtype=torch.float32, device=dev)
    cuda_build.launch("qmatmul_i8g", "pi_i8g_matmul", xq, sx, qs, sw, out, scratch, m, n, kp,
                      cut.rows, cut.chunks, cut.splits, count=i8g_matmul)
    i8g_matmul.last_plan = cut
    return out


i8g_matmul.launches = 0
i8g_matmul.last_plan = None  # the cut of its last launch


def qmm_i8g(x: torch.Tensor, qt: QuantTensor) -> torch.Tensor:
    """y = x @ W^T for the i8g layout: quantize activations per 512-row slab
    (one scale across all rows), then the i8g kernel."""
    xq, sx = quantize_activations(x, qt.qs.shape[0], I8G_SLAB)
    return i8g_matmul(xq, sx, qt.qs, qt.scales)


# ---------------------------------------------------------------------------
# The exact layouts (k_major, i8, k4): bf16 activations, weights dequantized
# in f32 and rounded to bf16 inside the kernel, products accumulated in f32
# ---------------------------------------------------------------------------
#
# The k_major, i8 and k4 kernels share the split-K frame of
# csrc/split_merge.cuh (see kmajor_matmul, i8_matmul and k4_matmul). Each
# weight is dequantized exactly as the TPU kernel does it: w = s * q (- b)
# with one f32 rounding per operation of that formula (never one rounding
# for s * q - b), rounded to bf16 (round to nearest even); the product
# with the bf16 activation is exact in f32 and accumulates in f32. Bound
# on the H100: bytes, as for i4g (decode M uses each weight M times, far
# under the ~295 operations per byte where the tensor cores would bind).


def _group_sums(x: torch.Tensor, group: int) -> torch.Tensor:
    """f32 sums of x [M, K] over each group of `group` rows -> [M, K/group]
    (the bias term's left factor, taken from f32 x as the reference does)."""
    m, k = x.shape
    return x.float().reshape(m, k // group, group).sum(dim=2)


# k_major: replaces pipeinfer_tpu/ops/qmatmul.py::_make_kernel (wrapper
# _qmm_pallas). Bound: bytes, the packed planes (0.5 B/weight plus 8 B per
# 32 weights of scale and bias for Q4_K; 1.25 B/weight for Q6_K). Design
# (csrc/qmatmul_kmajor.cu), the i8 kernel's frame: a block of 8 warps takes
# a 128-column tile (a warp load is one 128-byte line of one plane row), up
# to 8 rows of x, and a range of whole 128-row chunks of the qs plane;
# ``kmajor_plan`` cuts the ceil(qs rows / 128) chunks into such ranges
# (split-K). Warp w takes qs rows [16 w, 16 w + 16) of each chunk: 16
# elements of each of the format's planes (lo/hi nibbles, or the four 2-bit
# fields), which share one scale and one bias row per plane; their qh rows
# are loaded beside them. At 2/3 bits an odd number of pack groups leaves
# the last chunk half full, and the warps past the plane skip it. The warp
# loads the chunk's x values, issues the next chunk's qs and qh words (and,
# at one row of x, its scale and bias rows), and only then dequantizes and
# sums (x widened to f32 in shared memory). The quant bits of 4 columns of
# a row are gathered into the bytes of one word by word-wide masks and
# shifts, and each byte becomes a float by a byte permute and an add, with
# no int-to-float conversion; fl(fl(s * q) - b) is rounded to bf16 by one
# packed conversion, the bias inside the rounding as on the TPU. The
# splits meet as i8's do: f32 partials summed in split order by the last
# block of each tile (atomic ticket), so the output is bitwise
# reproducible.

_QS_ROWS = {8: 1, 6: 2, 5: 2, 4: 2, 3: 4, 2: 4}  # elements per qs row
_QH_DIV = {6: 4, 5: 8, 3: 8}  # K / qh rows
KMAJOR_CHUNK = 128  # qs rows of a k_major chunk, the unit of its split-K (CHUNK)


@functools.lru_cache(maxsize=1024)
def kmajor_plan(m: int, n: int, k: int, bits: int, sms: int) -> I8gPlan:
    """The cut for x [m, k] times a [k, n] k_major weight of `bits` bits on
    a card with `sms` SMs: split-K over the ceil(qs rows / 128) chunks of
    the qs plane (``_split_cut``); the last chunk holds 64 rows at 2/3 bits
    where K has an odd number of 256-row pack groups."""
    return I8gPlan(*_split_cut(m, n, -(-(k // _QS_ROWS[bits]) // KMAJOR_CHUNK), sms))


def _kmajor_plain(x, qs, qh, scales, bias, bits: int, group: int):
    """Plain version of the k_major kernel: W^T = bf16(s * q - b), then
    x @ W^T in f32."""
    k = x.shape[1]
    w = _expand(scales, group, k) * _unpack_quants_T(qs, qh, bits=bits, k=k).float()
    if bias is not None:
        w = w - _expand(bias, group, k)
    return x.float() @ w.to(torch.bfloat16).float()


def kmajor_matmul(x, qs, qh, scales, bias, *, bits: int, group: int) -> torch.Tensor:
    """out f32 [M, N] = x @ bf16(s * q - b) with q unpacked from k_major
    planes. x bf16 [M, K], K % 256 == 0; qs u8 [K * b / 8, N] (s8 [K, N]
    for 8 bits); qh u8 [K/8, N] (3 and 5 bits), [K/4, N] (6 bits) or None;
    scales f32 [K/G, N]; bias f32 [K/G, N], None exactly for 8 bits (Q8_0
    has no bias)."""
    if not x.is_cuda:
        return _kmajor_plain(x, qs, qh, scales, bias, bits, group)
    planes = dict(x=(x, torch.bfloat16), qs=(qs, torch.int8 if bits == 8 else torch.uint8),
                  scales=(scales, torch.float32))
    if qh is not None:
        planes["qh"] = (qh, torch.uint8)
    if bias is not None:
        planes["bias"] = (bias, torch.float32)
    cuda_build.check_tensors("kmajor_matmul", **planes)
    m, k = x.shape
    n = qs.shape[1]
    qh_rows = k // _QH_DIV[bits] if bits in _QH_DIV else None
    if (bits not in _QS_ROWS or group not in (16, 32) or k % PACK_GROUP or n % 4
            or qs.shape[0] != k // _QS_ROWS[bits]
            or (None if qh is None else tuple(qh.shape)) != (None if qh_rows is None
                                                             else (qh_rows, n))
            or scales.shape != (k // group, n)
            or (bias is not None and bias.shape != scales.shape)
            or (bias is None) != (bits == 8)):
        raise ValueError(f"kmajor_matmul: shapes x {tuple(x.shape)} qs {tuple(qs.shape)} "
                         f"qh {None if qh is None else tuple(qh.shape)} scales "
                         f"{tuple(scales.shape)} (bits {bits}, group {group}) do not fit")
    _aligned("kmajor_matmul", x=(x, 8), qs=(qs, 4), qh=(qh, 4), scales=(scales, 16),
             bias=(bias, 16))
    dev = x.device
    cut = kmajor_plan(m, n, k, bits, _sm_count(dev))
    scratch = _split_scratch_for(dev, cut.splits * m * n) if cut.splits > 1 else None
    out = torch.empty(m, n, dtype=torch.float32, device=dev)
    cuda_build.launch("qmatmul_kmajor", "pi_kmajor_matmul", x, qs, qh, scales, bias, out,
                      scratch, m, n, k, bits, group, cut.rows, cut.chunks, cut.splits,
                      count=kmajor_matmul)
    kmajor_matmul.last_plan = cut
    return out


kmajor_matmul.launches = 0
kmajor_matmul.last_plan = None  # the cut of its last launch


def qmm_kmajor(x: torch.Tensor, qt: QuantTensor) -> torch.Tensor:
    """y = x @ W^T for the k_major layout (Q8_0 has no bias term)."""
    bias = None if qt.qtype == GGMLQuantType.Q8_0 else qt.bias
    return kmajor_matmul(x.to(torch.bfloat16).contiguous(), qt.qs, qt.qh, qt.scales, bias,
                         bits=qt.bits, group=qt.group)


# i8: replaces pipeinfer_tpu/ops/qmatmul.py::_i8_kernel (wrapper
# _qmm_i8_pallas). Bound: bytes, 1 B/weight plus the scale and bias planes
# (8 B per group of 32 or 16). Design (csrc/qmatmul_i8.cu), the i8g
# kernel's frame: a block of 8 warps takes a 128-column tile (a warp load
# is one 128-byte line of one s8 row), up to 8 rows of x, and a range of
# whole 128-row chunks; ``i8_plan`` cuts the ceil(K / 128) chunks into such
# ranges (split-K), the last chunk ragged where K % 128 != 0. In each chunk
# warp w takes rows [16 w, 16 w + 16), which lie in one scale group: it
# transposes 4 x 4 byte blocks in registers, loads the chunk's x rows,
# issues the next chunk's 16 word loads and scale row, and only then
# dequantizes and sums (x widened to f32 in shared memory). The
# dequantization is bit-exact with bf16(fl(s * q)) with no int-to-float
# conversion (a byte permute and an add make q a float; one packed
# conversion rounds fl(s * q) to bf16 already widened). The TPU kernel
# leaves the bias term -xg @ B to an XLA dot outside; here the warp that
# holds a group's first row subtracts xg[m, g] * b[g, n] into its partial
# sums (the same f32 term, summed in another order), so the bias plane is
# read once, in the kernel. The splits meet as i8g's do: f32 partials
# summed in split order by the last block of each tile (atomic ticket), so
# the output is bitwise reproducible.


@functools.lru_cache(maxsize=1024)
def i8_plan(m: int, n: int, k: int, sms: int) -> I8gPlan:
    """The cut for x [m, k] times a [k, n] i8 weight on a card with `sms`
    SMs: split-K over ceil(k / 128) chunks (``_split_cut``); the last chunk
    holds k % 128 rows where that is not 0."""
    return I8gPlan(*_split_cut(m, n, -(-k // I8G_CHUNK), sms))


def _i8_plain(x, xg, qs, scales, bias, group: int):
    """Plain version of the i8 kernel: x @ bf16(s * q) - xg @ B."""
    out = x.float() @ (_expand(scales, group, qs.shape[0]) * qs.float()).to(torch.bfloat16).float()
    if bias is not None:
        out = out - xg @ bias
    return out


def i8_matmul(x, xg, qs, scales, bias, *, group: int) -> torch.Tensor:
    """out f32 [M, N] = x @ bf16(s * q) - xg @ B. x bf16 [M, K]; qs s8
    [K, N]; scales f32 [K/G, N]; bias f32 [K/G, N] and xg f32 [M, K/G]
    (group sums of f32 x), both None for Q8_0."""
    if not x.is_cuda:
        return _i8_plain(x, xg, qs, scales, bias, group)
    m, k = x.shape
    n = qs.shape[1]
    if (group not in (16, 32) or k % group or n % 4 or qs.shape[0] != k
            or scales.shape != (k // group, n) or (bias is None) != (xg is None)
            or (bias is not None and (bias.shape != scales.shape
                                      or xg.shape != (m, k // group)))):
        raise ValueError(f"i8_matmul: shapes x {tuple(x.shape)} qs {tuple(qs.shape)} "
                         f"scales {tuple(scales.shape)} (group {group}) do not fit")
    planes = dict(x=(x, torch.bfloat16), qs=(qs, torch.int8), scales=(scales, torch.float32))
    if bias is not None:
        planes.update(xg=(xg, torch.float32), bias=(bias, torch.float32))
    cuda_build.check_tensors("i8_matmul", **planes)
    _aligned("i8_matmul", x=(x, 8), scales=(scales, 16), bias=(bias, 16), qs=(qs, 4))
    dev = x.device
    cut = i8_plan(m, n, k, _sm_count(dev))
    scratch = _split_scratch_for(dev, cut.splits * m * n) if cut.splits > 1 else None
    out = torch.empty(m, n, dtype=torch.float32, device=dev)
    cuda_build.launch("qmatmul_i8", "pi_i8_matmul", x, xg, qs, scales, bias, out, scratch,
                      m, n, k, group, cut.rows, cut.chunks, cut.splits, count=i8_matmul)
    i8_matmul.last_plan = cut
    return out


i8_matmul.launches = 0
i8_matmul.last_plan = None  # the cut of its last launch


def qmm_i8(x: torch.Tensor, qt: QuantTensor) -> torch.Tensor:
    """y = x @ W^T for the i8 layout (Q8_0 has no bias term)."""
    has_bias = qt.qtype != GGMLQuantType.Q8_0
    return i8_matmul(x.to(torch.bfloat16).contiguous(),
                     _group_sums(x, qt.group) if has_bias else None, qt.qs, qt.scales,
                     qt.bias if has_bias else None, group=qt.group)


# k4: replaces pipeinfer_tpu/ops/qmatmul.py::_k4_kernel (wrapper
# _qmm_k4_pallas). Bound: bytes, 0.5 B/weight plus 8 B per 32 weights of
# per-plane scale and bias. Design (csrc/qmatmul_k4.cu), the i8 kernel's
# frame: a block of 8 warps takes a 128-column tile (a warp load is one
# 128-byte line of one byte-plane row), up to 8 rows of x, and a range of
# whole 128-row chunks of the byte plane, each one 256-element pack group;
# ``k4_plan`` cuts the K / 256 chunks into such ranges (split-K). Warp w
# takes byte rows [16 w, 16 w + 16) of each chunk, whose lo and hi nibbles
# are 16 elements each of the group's two K-halves and share one scale row
# per plane; the kernel reads x at those natural positions, so x is never
# re-ordered into plane order. It transposes 4 x 4 byte blocks in
# registers, loads the chunk's x, issues the next chunk's 16 word loads
# (and, at one row of x, its scale and bias rows), and only then
# dequantizes and sums (x widened to f32 in shared memory). The
# dequantization gives bf16(fl(s * q)) with no int-to-float conversion: a
# mask and a byte permute make each nibble the float 2^23 + u (the hi
# nibble kept in place, its scale prescaled by 2^-4), one FMA with -s 2^23
# gives fl(s * q), one packed conversion rounds it to bf16 already
# widened. The bias term is subtracted per plane group, as in the i8
# kernel, by the warp that holds the group's first rows. The splits meet
# as i8's do: f32 partials summed in split order by the last block of
# each tile (atomic ticket), so the output is bitwise reproducible.

K4_CHUNK = 128  # byte rows of a k4 chunk (one pack group), the unit of its split-K (CHUNK)


@functools.lru_cache(maxsize=1024)
def k4_plan(m: int, n: int, k: int, sms: int) -> I8gPlan:
    """The cut for x [m, k] times a [k, n] k4 weight on a card with `sms`
    SMs: split-K over the k / 256 chunks of the byte plane (two elements a
    byte), each one pack group (``_split_cut``)."""
    return I8gPlan(*_split_cut(m, n, k // (2 * K4_CHUNK), sms))


def _k4_plain(x, xg, qs, s_lo, s_hi, b_lo, b_hi):
    """Plain version of the k4 kernel: x re-ordered into plane order (xl,
    xh), xl @ bf16(s_lo * lo) + xh @ bf16(s_hi * hi) - (xgl @ B_lo +
    xgh @ B_hi)."""
    m, k = x.shape
    h = k // 2
    x4 = x.float().reshape(m, k // 256, 2, 128)
    xl, xh = x4[:, :, 0].reshape(m, h), x4[:, :, 1].reshape(m, h)
    wi = qs[:h].to(torch.int32)
    wl = (_expand(s_lo, K4_GROUP, h) * (wi & 15).float()).to(torch.bfloat16).float()
    wh = (_expand(s_hi, K4_GROUP, h) * (wi >> 4).float()).to(torch.bfloat16).float()
    xg4 = xg.reshape(m, k // 256, 8)
    xgl, xgh = xg4[:, :, :4].reshape(m, k // 64), xg4[:, :, 4:].reshape(m, k // 64)
    return (xl @ wl + xh @ wh) - (xgl @ b_lo[: k // 64] + xgh @ b_hi[: k // 64])


def k4_matmul(x, xg, qs, s_lo, s_hi, b_lo, b_hi) -> torch.Tensor:
    """out f32 [M, N] for the k4 layout (see _k4_plain). x bf16 [M, K],
    K % 256 == 0; xg f32 [M, K/32] (group sums of f32 x, natural order);
    qs u8 [r2, N], r2 >= K/2 and r2 % 256 == 0; s_lo, s_hi, b_lo, b_hi f32
    [r2/32, N]."""
    if not x.is_cuda:
        return _k4_plain(x, xg, qs, s_lo, s_hi, b_lo, b_hi)
    cuda_build.check_tensors("k4_matmul", x=(x, torch.bfloat16), xg=(xg, torch.float32),
                             qs=(qs, torch.uint8), s_lo=(s_lo, torch.float32),
                             s_hi=(s_hi, torch.float32), b_lo=(b_lo, torch.float32),
                             b_hi=(b_hi, torch.float32))
    m, k = x.shape
    r2, n = qs.shape
    srows = (r2 // K4_GROUP, n)
    if (k % PACK_GROUP or r2 % 256 or r2 < k // 2 or n % 4 or xg.shape != (m, k // K4_GROUP)
            or any(p.shape != srows for p in (s_lo, s_hi, b_lo, b_hi))):
        raise ValueError(f"k4_matmul: shapes x {tuple(x.shape)} xg {tuple(xg.shape)} qs "
                         f"{tuple(qs.shape)} s_lo {tuple(s_lo.shape)} do not fit")
    _aligned("k4_matmul", x=(x, 16), qs=(qs, 4), s_lo=(s_lo, 16), s_hi=(s_hi, 16),
             b_lo=(b_lo, 16), b_hi=(b_hi, 16))
    dev = x.device
    cut = k4_plan(m, n, k, _sm_count(dev))
    scratch = _split_scratch_for(dev, cut.splits * m * n) if cut.splits > 1 else None
    out = torch.empty(m, n, dtype=torch.float32, device=dev)
    cuda_build.launch("qmatmul_k4", "pi_k4_matmul", x, xg, qs, s_lo, s_hi, b_lo, b_hi, out,
                      scratch, m, n, k, cut.rows, cut.chunks, cut.splits, count=k4_matmul)
    k4_matmul.last_plan = cut
    return out


k4_matmul.launches = 0
k4_matmul.last_plan = None  # the cut of its last launch


def qmm_k4(x: torch.Tensor, qt: QuantTensor) -> torch.Tensor:
    """y = x @ W^T for the k4 layout."""
    return k4_matmul(x.to(torch.bfloat16).contiguous(), _group_sums(x, K4_GROUP), qt.qs,
                     qt.scales, qt.scales2, qt.bias, qt.bias2)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

_QMM = {"i4g": qmm_i4g, "i8g": qmm_i8g, "k_major": qmm_kmajor, "i8": qmm_i8, "k4": qmm_k4}


def kernel_supported(qt: QuantTensor) -> bool:
    """Whether a kernel takes this weight. Every kernel reads 4 columns
    with one 32-bit load, so N must be a multiple of 4; k_major also needs
    whole 256-row pack groups (K % 256), i8 whole scale groups (k4's K %
    256 holds by construction). The JAX package's test
    (_pallas_supported) also asks for N % 128; the port's kernels mask the
    ragged edge of their column tiles. Anything else, such as a
    32003-token vocabulary head, takes the dense fallback, as it does in
    the JAX package."""
    n, k = qt.shape
    if qt.layout not in _QMM or n % 4:
        return False
    if qt.layout == "k_major":
        return k % PACK_GROUP == 0
    if qt.layout == "i8":
        return k % qt.group == 0
    return True


def qmatmul(x: torch.Tensor, qt: QuantTensor) -> torch.Tensor:
    """y[M, N] = x[M, K] @ W[N, K]^T with W quantized; output float32.

    Weights a kernel takes go through its wrapper, which launches the CUDA
    kernel for a CUDA tensor and runs the plain version for a CPU tensor.
    The rest take the dense fallback of the JAX package: dequantize to
    bf16 and multiply with f32 accumulation."""
    if kernel_supported(qt):
        return _QMM[qt.layout](x, qt)
    w_t = dequant_T(qt, torch.bfloat16).float()
    return x.to(torch.bfloat16).float() @ w_t
