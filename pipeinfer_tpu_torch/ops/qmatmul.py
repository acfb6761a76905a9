"""Quantized matmul: device planes, activation quantization and the i4g /
i8g kernels.

Torch counterpart of pipeinfer_tpu.ops.qmatmul for the layouts on the main
path:

- "i4g": weights requantized at load to 4 bits on a per-(128-row half-slab,
  column) affine grid (w ~ wmin + step * u, u in [0, 15]), nibble-packed per
  256-row slab: byte p of a slab holds row p (lo nibble) and row p + 128
  (hi nibble). qs u8 [Kp/2, N], step and wmin f32 [Kp/128, N].
- "i8g": weights requantized to s8 with an absmax scale per (512-row slab,
  column). qs s8 [Kp, N], sw f32 [Kp/512, N].
- "n_major": the raw packed planes kept [N, K-ish] for embedding row
  gathers (``dequant_rows``).

Activations are quantized to s8 in plain torch outside the kernels, with
ONE absmax scale per slab shared across all M rows (a per-row scale would
change the verify-batch numerics against the reference). The kernels
(``csrc/qmatmul_i4g.cu``, ``csrc/qmatmul_i8g.cu``) then run exact s8 x s8
-> s32 dot products per slab and scale each slab's partial sums on the
output side. On a CPU tensor each kernel wrapper runs its plain PyTorch
version instead; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import dataclasses

import torch

from ..gguf.constants import GGMLQuantType
from ..quant.pack import FORMAT_INFO, PACK_GROUP, PackedWeight
from . import cuda_build

I8G_SLAB = 512  # K rows sharing one requant scale
I4G_SLAB = 256  # K rows per nibble-packed slab (two 128-row half-slabs)
I4G_HALF = I4G_SLAB // 2
PORTED_LAYOUTS = ("i4g", "i8g", "n_major")


@dataclasses.dataclass
class QuantTensor:
    """Device-side quantized [N, K] weight (see the module docstring for
    the layouts). For i4g, ``scales`` holds step and ``bias`` holds wmin;
    for i8g, ``scales`` holds sw and ``bias`` is empty."""

    qs: torch.Tensor
    qh: torch.Tensor | None
    scales: torch.Tensor
    bias: torch.Tensor
    qtype: GGMLQuantType
    shape: tuple[int, int]  # (N, K)
    layout: str = "i4g"

    @property
    def bits(self) -> int:
        return FORMAT_INFO[self.qtype][0]

    @property
    def group(self) -> int:
        return FORMAT_INFO[self.qtype][1]

    def nbytes(self) -> int:
        planes = (self.qs, self.qh, self.scales, self.bias)
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


def to_device(pw: PackedWeight, layout: str = "i4g", device="cuda") -> QuantTensor:
    """Upload a host PackedWeight in the requested plane layout. The i4g
    and i8g planes are built on `device` from the raw packed planes (a
    4-bit layout request for a wider format becomes i8g, as in the
    reference)."""
    device = torch.device(device)

    def put(a):
        return None if a is None else torch.from_numpy(a).to(device)

    if layout == "i4g" and pw.bits != 4:
        layout = "i8g"
    if layout in ("i4g", "i8g"):
        raw = (put(pw.qs), put(pw.qh), put(pw.scales), put(pw.bias))
        kw = dict(bits=pw.bits, k=pw.shape[1], group=FORMAT_INFO[pw.qtype][1])
        if layout == "i4g":
            wp, step, wmin = _i4g_planes(*raw, **kw)
            return QuantTensor(wp, None, step, wmin, pw.qtype, pw.shape, "i4g")
        wq, sw = _i8g_planes(*raw, **kw)
        return QuantTensor(wq, None, sw, sw[:0], pw.qtype, pw.shape, "i8g")
    if layout == "n_major":
        return QuantTensor(put(pw.qs), put(pw.qh), put(pw.scales), put(pw.bias),
                           pw.qtype, pw.shape, "n_major")
    raise ValueError(f"layout {layout!r} is not ported (i4g, i8g and n_major are)")


def dequant_T(qt: QuantTensor, dtype=torch.float32) -> torch.Tensor:
    """Dequantize to W^T [K, N]."""
    n, k = qt.shape
    if qt.layout == "n_major":
        return dequant(qt, dtype).T
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
    raise ValueError(f"layout {qt.layout!r} is not ported")


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
    cannot fuse (mixed formats, as Q4_K_M's Q6_K w_v, or mixed layouts)."""
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
        layout=first.layout,
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
# 128 weights) once at the memory rate. Design (csrc/qmatmul_i4g.cu): one
# block per 32-column tile and up to 8 rows of x; its 256 threads split K
# into 32 interleaved chunks, so a 4096-deep matrix still gets 128 blocks;
# each thread loads 4 packed rows x 4 columns as four 32-bit words,
# transposes them in registers (__byte_perm) into per-column words of 4 K
# values, splits lo/hi nibbles with two masks and feeds __dp4a against the
# s8 activations. Integer partial sums are exact; each chunk's sums are
# scaled by step * sx on the output side, the chunks are summed through
# shared memory, and the affine min term xsum @ (wmin * sx) is added in the
# epilogue. No cross-block reduction, so the output needs no atomics.


def _i4g_plain(xq, xsum, sx, qs, step, wmin):
    """Plain version of the i4g kernel (same arithmetic, slab by slab)."""
    m, kp = xq.shape
    n = qs.shape[1]
    nslab = kp // I4G_SLAB
    v = qs.to(torch.int32).reshape(nslab, I4G_HALF, n)
    u = torch.stack([v & 15, v >> 4], dim=1).reshape(2 * nslab, I4G_HALF, n).float()
    xh = xq.float().reshape(m, 2 * nslab, I4G_HALF).transpose(0, 1)  # [nhalf, M, 128]
    # integer dots are exact in f32: |sum| <= 128 * 127 * 15 < 2^24
    p = torch.bmm(xh, u)  # [nhalf, M, N]
    se = step * sx[:, None]
    acc = torch.zeros(m, n, dtype=torch.float32, device=xq.device)
    for g in range(2 * nslab):
        acc = acc + p[g] * se[g]
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
    out = torch.empty(m, n, dtype=torch.float32, device=xq.device)
    i4g_matmul.launches += 1
    cuda_build.launch("qmatmul_i4g", "pi_i4g_matmul", xq, xsum, sx, qs, step, wmin, out, m, n, kp)
    return out


i4g_matmul.launches = 0


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
# Bound on the H100: bytes (1 B/weight plus 4 B per 512 weights for sw) at
# decode M, for the same reason as i4g. Design (csrc/qmatmul_i8g.cu): the
# i4g kernel's shape without the nibble split — 32-column tiles, K split
# into 32-row chunks over 32 thread groups, 4x4 byte transposes feeding
# __dp4a, each chunk's exact integer sums scaled by sw * sx of its slab.


def _i8g_plain(xq, sx, qs, sw):
    """Plain version of the i8g kernel (same arithmetic, slab by slab)."""
    m, kp = xq.shape
    n = qs.shape[1]
    nslab = kp // I8G_SLAB
    xs = xq.float().reshape(m, nslab, I8G_SLAB).transpose(0, 1)  # [nslab, M, 512]
    # integer dots are exact in f32: |sum| <= 512 * 127 * 127 < 2^24
    p = torch.bmm(xs, qs.float().reshape(nslab, I8G_SLAB, n))
    se = sw * sx[:, None]
    acc = torch.zeros(m, n, dtype=torch.float32, device=xq.device)
    for s in range(nslab):
        acc = acc + p[s] * se[s]
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
    out = torch.empty(m, n, dtype=torch.float32, device=xq.device)
    i8g_matmul.launches += 1
    cuda_build.launch("qmatmul_i8g", "pi_i8g_matmul", xq, sx, qs, sw, out, m, n, kp)
    return out


i8g_matmul.launches = 0


def qmm_i8g(x: torch.Tensor, qt: QuantTensor) -> torch.Tensor:
    """y = x @ W^T for the i8g layout: quantize activations per 512-row slab
    (one scale across all rows), then the i8g kernel."""
    xq, sx = quantize_activations(x, qt.qs.shape[0], I8G_SLAB)
    return i8g_matmul(xq, sx, qt.qs, qt.scales)


def kernel_supported(qt: QuantTensor) -> bool:
    """Whether a kernel takes this weight: the i4g and i8g layouts with N a
    multiple of 4 (one 32-bit load covers 4 columns). The JAX package's
    test (_pallas_supported) asks for N % 128; the port's kernels mask the
    ragged edge of their 32-column tiles, so only the word alignment is
    left. Anything else, such as a 32003-token vocabulary head, takes the
    dense fallback, as it does in the JAX package."""
    return qt.layout in ("i4g", "i8g") and qt.shape[0] % 4 == 0


def qmatmul(x: torch.Tensor, qt: QuantTensor) -> torch.Tensor:
    """y[M, N] = x[M, K] @ W[N, K]^T with W quantized; output float32.

    Weights a kernel takes go through its wrapper, which launches the CUDA
    kernel for a CUDA tensor and runs the plain version for a CPU tensor.
    The rest take the dense fallback of the JAX package: dequantize to
    bf16 and multiply with f32 accumulation."""
    if kernel_supported(qt):
        return qmm_i4g(x, qt) if qt.layout == "i4g" else qmm_i8g(x, qt)
    w_t = dequant_T(qt, torch.bfloat16).float()
    return x.to(torch.bfloat16).float() @ w_t
