"""A CPU rehearsal of the k_major kernel's split-K order and dequantization
(pipeinfer_tpu_torch/csrc/qmatmul_kmajor.cu). A torch emulation cuts the
qs plane as ``kmajor_plan`` cuts it: into ranges of whole 128-row chunks,
each chunk into 8 warps of 16 qs rows (a warp past the plane, in the
ragged last chunk at 2/3 bits, skips it); each warp keeps its own f32
accumulator, into which it adds its rows' products with the bf16 weights
in the kernel's order (4-row groups, then planes, then rows), one
rounding per add as fmaf's; the warps are summed in warp order and the
splits in split order. It is held against the port's plain version and
the JAX package's Pallas kernel in interpret mode on the same planes, for
every k_major format at M = 1, 8, 9 and 33, at a K (five pack groups)
whose chunks do not divide evenly into the splits and which leaves the
last 2/3-bit chunk half full. Every weight is the same bf16 value on every
side and its product with the bf16 activation is exact in f32, so what
differs is the order of the f32 sums: rtol 1e-5 of max|out|. The plan is
checked at the 7B and toy shapes, and the kernel's quant-to-float steps
(word masks and shifts, a byte permute and an add, the prescaled scale)
bit for bit in numpy and f32 torch, for every quant value of every width
and every plane position."""

import functools
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pipeinfer_tpu.gguf.constants import GGMLQuantType as JQ
from pipeinfer_tpu.quant import pack as jpack
from pipeinfer_tpu_torch.gguf.constants import GGMLQuantType as TQ
from pipeinfer_tpu_torch.ops import qmatmul as tq
from pipeinfer_tpu_torch.quant.pack import FORMAT_INFO

jq = importlib.import_module("pipeinfer_tpu.ops.qmatmul")
RTOL = 1e-5
WARPS, ROWS_PER_WARP = 8, 16  # KG and CH in the kernel
FORMATS = ("Q4_0", "Q4_1", "Q5_0", "Q5_1", "Q8_0", "Q2_K", "Q3_K", "Q4_K", "Q5_K", "Q6_K")
QH_ROWS = {5: 32, 6: 64, 3: 32}  # qh rows per 256-row pack group (QH)


def _layout(bits):
    """(planes = elements per qs row, qs rows per pack group, element
    distance between planes): the kernel's Fmt<BITS>."""
    planes = tq._QS_ROWS[bits]
    return planes, 256 // planes, 0 if bits == 8 else 256 // planes


def _warp_elements(bits, k, ch, wi):
    """The elements warp wi sums in chunk ch, in the kernel's order (4-row
    groups r4, planes i, rows t), or None for a warp past the qs plane."""
    planes, rows, stride = _layout(bits)
    r0 = ch * tq.KMAJOR_CHUNK + wi * ROWS_PER_WARP
    if r0 >= k // planes:
        return None
    e0 = r0 // rows * 256 + r0 % rows
    return [e0 + i * stride + 4 * r4 + t for r4 in range(4) for i in range(planes)
            for t in range(4)]


def _emulate(x, qs, qh, scales, bias, bits, group, sms):
    """The kernel's arithmetic, cut and summed in the kernel's order."""
    m, k = x.shape
    n = qs.shape[1]
    cut = tq.kmajor_plan(m, n, k, bits, sms)
    nchunk = -(-(k // tq._QS_ROWS[bits]) // tq.KMAJOR_CHUNK)
    w = tq._expand(scales, group, k) * tq._unpack_quants_T(qs, qh, bits=bits, k=k).float()
    if bias is not None:
        w = w - tq._expand(bias, group, k)
    w = w.to(torch.bfloat16).float()
    xf = x.float()
    parts = []
    for sp in range(cut.splits):
        acc = torch.zeros(WARPS, m, n)  # one f32 accumulator per warp
        for ch in range(sp * cut.chunks, min(nchunk, (sp + 1) * cut.chunks)):
            order = [_warp_elements(bits, k, ch, wi) for wi in range(WARPS)]
            live = [wi for wi in range(WARPS) if order[wi] is not None]
            idx = torch.tensor([order[wi] for wi in live])  # [warps, 16 * planes]
            for step in range(idx.shape[1]):
                e = idx[:, step]
                # fmaf(w, x, acc): the product is exact in f32, one rounding
                acc[live] = acc[live] + xf[:, e].T[:, :, None] * w[e][:, None, :]
        part = acc[0]
        for wi in range(1, WARPS):
            part = part + acc[wi]
        parts.append(part)
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out, cut, nchunk


@functools.lru_cache(maxsize=None)
def _planes(qname, n, k):
    """k_major planes of one random weight, packed by the JAX package, as
    the JAX QuantTensor and the port's (CPU) tensors."""
    w = (np.random.default_rng(sum(map(ord, qname))).standard_normal((n, k)) * 0.1)
    jqt = jq.to_device(jpack.pack_array(w.astype(np.float32), JQ[qname]), layout="k_major")
    t = {f: None if getattr(jqt, f) is None else torch.from_numpy(np.array(getattr(jqt, f)))
         for f in ("qs", "qh", "scales", "bias")}
    return jqt, t


def _uneven(cut, nchunk):
    return cut.splits > 1 and nchunk % cut.chunks != 0


@pytest.mark.parametrize("qname", FORMATS)
@pytest.mark.parametrize("m", [1, 8, 9, 33])
def test_split_order_matches_plain_and_pallas_interpret(m, qname, rng):
    """K = 1280, five pack groups: 5 chunks at 4/5/6 bits, 10 at 8 bits,
    and 3 at 2/3 bits, the last of 64 qs rows (warps 4-7 skip it). N = 256
    (the Pallas kernel's block): 2 column tiles."""
    n, k = 256, 1280
    bits, group = FORMAT_INFO[TQ[qname]]
    jqt, t = _planes(qname, n, k)
    nchunk = -(-(k // tq._QS_ROWS[bits]) // tq.KMAJOR_CHUNK)
    if bits in (2, 3):
        assert (k // tq._QS_ROWS[bits]) % tq.KMAJOR_CHUNK == 64  # a ragged last chunk
    # a card small enough that the chunks cut into ranges with a short last one
    sms = next(s for s in range(1, 64) if _uneven(tq.kmajor_plan(m, n, k, bits, s), nchunk))
    x = rng.standard_normal((m, k)).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    bias = None if qname == "Q8_0" else t["bias"]
    got, cut, _ = _emulate(xb, t["qs"], t["qh"], t["scales"], bias, bits, group, sms)
    assert _uneven(cut, nchunk)
    plain = tq._kmajor_plain(xb, t["qs"], t["qh"], t["scales"], bias, bits, group)
    tqt = tq.QuantTensor(t["qs"], t["qh"], t["scales"], t["bias"], qtype=TQ[qname],
                         shape=(n, k), layout="k_major")
    assert torch.equal(tq.qmatmul(torch.from_numpy(x), tqt), plain)  # the CPU path is plain
    want = np.asarray(jq.qmatmul(jnp.asarray(x), jqt, prefer_pallas=True, interpret=True))
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=0, atol=RTOL * scale)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=RTOL * scale)


SHAPES_7B = {"wqkv": (12288, 4096), "wo": (4096, 4096), "wgu": (22016, 4096),
             "w_down": (4096, 11008), "output": (32000, 4096)}
SHAPES_TOY = {"wqkv": (2048, 1024), "wo": (1024, 1024), "wgu": (5632, 1024),
              "w_down": (1024, 2816)}


@pytest.mark.parametrize("bits", [2, 3, 4, 5, 6, 8])
@pytest.mark.parametrize("sms", [4, 78, 132])
@pytest.mark.parametrize("m", [1, 8, 9, 33])
def test_plan_covers_every_chunk_once(m, sms, bits):
    for n, k in [*SHAPES_7B.values(), *SHAPES_TOY.values(), (256, 1280), (200, 2304)]:
        cut = tq.kmajor_plan(m, n, k, bits, sms)
        nchunk = -(-(k // tq._QS_ROWS[bits]) // tq.KMAJOR_CHUNK)
        ranges = [range(sp * cut.chunks, min(nchunk, (sp + 1) * cut.chunks))
                  for sp in range(cut.splits)]
        assert all(len(r) > 0 for r in ranges)
        assert sorted(c for r in ranges for c in r) == list(range(nchunk))
        assert cut.rows in (1, 4, 8)
        assert cut.row_tiles * cut.rows >= m > (cut.row_tiles - 1) * cut.rows
        assert cut.col_tiles == -(-n // tq.I4G_TN)
        assert cut.blocks == cut.row_tiles * cut.col_tiles * cut.splits
        # every element of the weight is summed by exactly one warp of one chunk
        if (n, k) == (256, 1280):
            seen = [e for ch in range(nchunk) for wi in range(WARPS)
                    for e in (_warp_elements(bits, k, ch, wi) or [])]
            assert sorted(seen) == list(range(k))


# (splits, chunks per split, blocks) on a 132-SM card at M = 1 and 8 (one row tile)
PLANS_132 = {
    (4, "7b", "wqkv"): (8, 2, 768), (4, "7b", "wo"): (8, 2, 256),
    (4, "7b", "wgu"): (3, 6, 516), (4, "7b", "w_down"): (8, 6, 256),
    (4, "7b", "output"): (1, 16, 250), (4, "toy", "w_down"): (11, 1, 88),
    (6, "7b", "w_down"): (8, 6, 256), (6, "toy", "wo"): (4, 1, 32),
    (8, "7b", "w_down"): (8, 11, 256), (8, "toy", "w_down"): (22, 1, 176),
    (2, "7b", "w_down"): (8, 3, 256), (2, "7b", "output"): (1, 8, 250),
    (2, "toy", "wo"): (2, 1, 16),
}


@pytest.mark.parametrize("bits,scale,name", list(PLANS_132))
@pytest.mark.parametrize("m", [1, 8])
def test_plan_block_counts(m, bits, scale, name):
    """Q4_K w_down's 43 chunks (one pack group each): 8 splits of 6 (the
    last of 1), 256 blocks (the parent's 32-column tiles gave 128 blocks
    and no split); at 2 bits 22 chunks, the last half full; the 32000-row
    head's 250 column tiles already fill the card, so it keeps one split.
    At 8 bits a chunk is i8's 128 rows, so the cut is i8's."""
    n, k = (SHAPES_7B if scale == "7b" else SHAPES_TOY)[name]
    cut = tq.kmajor_plan(m, n, k, bits, 132)
    assert (cut.splits, cut.chunks, cut.blocks) == PLANS_132[bits, scale, name]
    assert cut.rows == m and cut.row_tiles == 1
    if bits == 8:
        assert cut == tq.i8_plan(m, n, k, 132)


# ---------------------------------------------------------------------------
# the quant-to-float steps, bit for bit
# ---------------------------------------------------------------------------


def _place(bits, i):
    """log2 of the factor by which plane i's byte holds q (place())."""
    return 4 * i if bits == 4 else 2 * i if bits == 2 else 0


def _quant_word(bits, W, H, hs, i):
    """quant_word<BITS>(W, H, hs, i) on u32 arrays."""
    u32 = np.uint32
    if bits == 8:
        return W ^ u32(0x80808080)
    if bits == 4:
        return W & u32(0x0F0F0F0F << (4 * i))
    if bits == 2:
        return W & u32((0x03030303 << (2 * i)) & 0xFFFFFFFF)
    h = H >> u32(hs)
    if bits in (5, 6):
        mask = u32(0x10101010 if bits == 5 else 0x30303030)
        if i == 0:
            return (W & u32(0x0F0F0F0F)) | ((h << u32(4)) & mask)
        return ((W >> u32(4)) & u32(0x0F0F0F0F)) | (h & mask)
    hb = h << u32(2) if i == 0 else h >> u32(2 * i - 2)
    return ((W >> u32(2 * i)) & u32(0x03030303)) | (hb & u32(0x04040404))


def _byte_float(u, c):
    """__byte_perm(u, 0x4B00, 0x5440 + c) as f32: 2^23 + byte c of u."""
    bits = ((u >> np.uint32(8 * c)) & np.uint32(0xFF)) | np.uint32(0x4B000000)
    return bits.view(np.float32)


def _pack(q, bits):
    """Integer quants W^T [K, N] -> k_major (qs, qh) numpy planes, the
    inverse of _unpack_quants_T."""
    k, n = q.shape
    g = q.reshape(k // 256, 256, n).astype(np.int64)
    if bits == 8:
        return q.astype(np.int8), None
    if bits in (4, 5, 6):
        qs = (g[:, :128] & 15) | ((g[:, 128:] & 15) << 4)
    else:
        qs = sum((g[:, 64 * i:64 * i + 64] & 3) << (2 * i) for i in range(4))
    qh = None
    if bits in (5, 3):
        hi = 4 if bits == 5 else 2
        qh = sum(((g[:, 32 * i:32 * i + 32] >> hi) & 1) << i for i in range(8))
    elif bits == 6:
        qh = sum(((g[:, 64 * i:64 * i + 64] >> 4) & 3) << (2 * i) for i in range(4))
    qs = qs.reshape(-1, n).astype(np.uint8)
    return qs, None if qh is None else qh.reshape(-1, n).astype(np.uint8)


def _all_values(bits):
    """W^T [512, V] whose every element position holds every quant value of
    the width once across the V columns, in an order of its own (so that
    elements which share a qs or qh byte differ); two pack groups, so the
    8-bit chunks' two halves and the 2/3-bit chunks' two groups both
    occur."""
    lo, nv = (-128, 256) if bits == 8 else (0, 1 << bits)
    g = np.random.default_rng(bits)
    return lo + np.stack([g.permutation(nv) for _ in range(512)]).astype(np.int64)


@pytest.mark.parametrize("bits", [2, 3, 4, 5, 6, 8])
def test_quant_words_give_every_quant_exactly(bits):
    """For every warp of every chunk, row, plane and column: the kernel's
    masks and shifts of a row's word (4 columns), then the byte permute and
    the subtraction of 2^23 (2^23 + 128 for s8), give q * 2^place exactly;
    the test's packer is checked against the port's unpacker first."""
    q = _all_values(bits)
    k, n = q.shape
    qs, qh = _pack(q, bits)
    unpacked = tq._unpack_quants_T(torch.from_numpy(qs),
                                   None if qh is None else torch.from_numpy(qh), bits=bits, k=k)
    np.testing.assert_array_equal(unpacked.numpy(), q)
    qs32 = qs.view(np.uint8).astype(np.uint32)
    qh32 = None if qh is None else qh.astype(np.uint32)
    planes, rows, stride = _layout(bits)
    sub = np.float32(8388736.0 if bits == 8 else 8388608.0)
    seen = np.zeros(q.shape, bool)
    for ch in range(-(-(k // planes) // tq.KMAJOR_CHUNK)):
        for wi in range(WARPS):
            order = _warp_elements(bits, k, ch, wi)
            if order is None:
                continue
            r0 = ch * tq.KMAJOR_CHUNK + wi * ROWS_PER_WARP
            jw = wi * ROWS_PER_WARP % rows
            hs = 2 * (jw // 64) if bits == 6 else jw // 32
            hrow0 = r0 // rows * QH_ROWS[bits] + jw % QH_ROWS[bits] if bits in QH_ROWS else 0
            for r in range(ROWS_PER_WARP):
                # the row words: byte c is column 4 g + c of word g
                W = sum(qs32[r0 + r, c::4] << np.uint32(8 * c) for c in range(4))
                H = None if qh32 is None else \
                    sum(qh32[hrow0 + r, c::4] << np.uint32(8 * c) for c in range(4))
                for i in range(planes):
                    u = _quant_word(bits, W.astype(np.uint32), H, hs, i)
                    e = order[(r // 4 * planes + i) * 4 + r % 4]
                    for c in range(4):
                        np.testing.assert_array_equal(
                            _byte_float(u, c) - sub,
                            (q[e, c::4] * 2 ** _place(bits, i)).astype(np.float32))
                    seen[e] = True
    assert seen.all()


def _scales(rng):
    """f32 scales of every sign and a wide range of magnitudes, GGUF-like
    ones (f16 d times a 6-bit scale), the prescale's lower limit 2^-120,
    and 0."""
    d = rng.standard_normal(300).astype(np.float16).astype(np.float32)
    return np.concatenate([
        (rng.standard_normal(1500) * np.exp(rng.uniform(-40, 20, 1500))).astype(np.float32),
        d * rng.integers(1, 64, 300).astype(np.float32),
        np.float32([2.0 ** -24, 2.0 ** -120, -(2.0 ** -120) * 1.5, 1.0, 1.0 + 2.0 ** -8,
                    3.0 * 2.0 ** -9, 0.0])])


@pytest.mark.parametrize("bits,plane", [(b, i) for b in (2, 3, 4, 5, 6, 8)
                                        for i in range(tq._QS_ROWS[b])])
def test_dequantization_is_bit_exact_with_the_plain_rounding(bits, plane, rng):
    """The kernel's weight in f32 torch arithmetic: the prescaled scale
    fl(s * 2^-place), times the float q * 2^place, minus b (each rounded
    once), rounded to nearest even bf16 into the high half of a word whose
    low half is zero, has the same f32 bits as the plain version's
    bf16(fl(fl(s * q) - b)), for every quant value, at scales from
    _scales() and biases of both signs (none for Q8_0)."""
    j = _place(bits, plane)
    qv = np.unique(_all_values(bits)).astype(np.float32)
    s = torch.from_numpy(_scales(rng))
    b = torch.zeros_like(s) if bits == 8 else \
        torch.from_numpy((rng.standard_normal(s.shape[0]) * 0.05).astype(np.float32)) * s.abs()
    q = torch.from_numpy(qv)
    u = torch.from_numpy(qv * np.float32(2.0 ** j))
    prescaled = s * torch.tensor(2.0 ** -j)
    assert torch.equal(prescaled * torch.tensor(2.0 ** j), s)  # the prescale is exact
    p = prescaled[:, None] * u[None, :]  # fl(s 2^-j * q 2^j)
    if bits != 8:
        p = p - b[:, None]
    widened = (p.to(torch.bfloat16).view(torch.int16).to(torch.int32) << 16).view(torch.float32)
    want = s[:, None] * q[None, :]
    if bits != 8:
        want = want - b[:, None]
    want = want.to(torch.bfloat16).float()
    assert torch.equal(widened.view(torch.int32), want.view(torch.int32))
