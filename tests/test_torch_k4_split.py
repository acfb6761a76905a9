"""A CPU rehearsal of the k4 kernel's split-K order and dequantization
(pipeinfer_tpu_torch/csrc/qmatmul_k4.cu). A torch emulation cuts the byte
plane as ``k4_plan`` cuts it: into ranges of whole 128-row chunks (one
256-element pack group each), each chunk into 8 warps of 16 byte rows;
each warp keeps its own f32 accumulator, into which an even warp first
subtracts the bias terms of its plane groups (xg[m, gl] * b_lo, then
xg[m, gh] * b_hi, one rounding each as fmaf's) and then every warp adds its
rows' products with the bf16 weights in the kernel's order (4-row groups,
then the lo and hi planes, then rows); the warps are summed in warp order
and the splits in split order. It is held against the port's plain
version and the JAX package's Pallas kernel in interpret mode on the same
planes (Q4_0, Q4_1 and Q4_K), at M = 1, 8, 9 and 33, at K = 1280: five
chunks, which do not divide evenly into the splits, and a byte plane
padded from 640 to 768 rows. Every weight is the same bf16 value on every
side and its product with the bf16 activation is exact in f32, so what
differs is the order of the f32 sums: rtol 1e-5 of max|out|. The plan is
checked at the 7B and toy shapes, and the kernel's nibble-to-float steps
(the 4 x 4 byte transpose, the nibble masks, the byte permute, the FMA
that takes 2^23 away, the hi plane's prescaled scale) bit for bit in
numpy and f32 torch, for every nibble value of both planes."""

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

jq = importlib.import_module("pipeinfer_tpu.ops.qmatmul")
RTOL = 1e-5
WARPS, ROWS_PER_WARP = 8, 16  # KG and CH in the kernel
FORMATS = ("Q4_0", "Q4_1", "Q4_K")


def _emulate(x, xg, qs, s_lo, s_hi, b_lo, b_hi, sms):
    """The kernel's arithmetic, cut and summed in the kernel's order."""
    m, k = x.shape
    n = qs.shape[1]
    cut = tq.k4_plan(m, n, k, sms)
    nchunk = k // 256
    h = k // 2
    wi = qs[:h].to(torch.int32)
    # the weights by byte row p: bf16(fl(s * q)) of each plane
    wl = (tq._expand(s_lo, tq.K4_GROUP, h) * (wi & 15).float()).to(torch.bfloat16).float()
    wh = (tq._expand(s_hi, tq.K4_GROUP, h) * (wi >> 4).float()).to(torch.bfloat16).float()
    xf = x.float()
    warp = torch.arange(WARPS)
    parts = []
    for sp in range(cut.splits):
        acc = torch.zeros(WARPS, m, n)  # one f32 accumulator per warp
        for ch in range(sp * cut.chunks, min(nchunk, (sp + 1) * cut.chunks)):
            for wv in range(0, WARPS, 2):  # the even warps: fmaf(-xg, b, acc), lo then hi
                sr, gl = ch * 4 + wv // 2, ch * 8 + wv // 2
                for g, b in ((gl, b_lo), (gl + 4, b_hi)):
                    term = xg[:, g:g + 1].double() * b[sr].double()
                    acc[wv] = (acc[wv].double() - term).float()
            for r4 in range(ROWS_PER_WARP // 4):
                for plane, w in enumerate((wl, wh)):
                    for t in range(4):
                        p = ch * tq.K4_CHUNK + warp * ROWS_PER_WARP + 4 * r4 + t
                        e = ch * 256 + warp * ROWS_PER_WARP + 4 * r4 + t + 128 * plane
                        # fmaf(w, x, acc): the product is exact in f32, one rounding
                        acc = acc + xf[:, e].T[:, :, None] * w[p][:, None, :]
        part = acc[0]
        for wv in range(1, WARPS):
            part = part + acc[wv]
        parts.append(part)
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out, cut


def _uneven(cut, nchunk):
    return cut.splits > 1 and nchunk % cut.chunks != 0


@functools.lru_cache(maxsize=None)
def _planes(qname, n, k):
    """k4 planes of one random weight, packed by the JAX package, as the
    JAX QuantTensor and the port's (CPU) QuantTensor."""
    w = np.random.default_rng(sum(map(ord, qname))).standard_normal((n, k)) * 0.1
    jqt = jq.to_device(jpack.pack_array(w.astype(np.float32), JQ[qname]), layout="k4")
    t = {f: torch.from_numpy(np.array(getattr(jqt, f)))
         for f in ("qs", "scales", "bias", "scales2", "bias2")}
    tqt = tq.QuantTensor(t["qs"], None, t["scales"], t["bias"], TQ[qname], (n, k), "k4",
                         t["scales2"], t["bias2"])
    return jqt, tqt


@pytest.mark.parametrize("qname", FORMATS)
@pytest.mark.parametrize("m", [1, 8, 9, 33])
def test_split_order_matches_plain_and_pallas_interpret(m, qname, rng):
    """K = 1280: five chunks, cut unevenly; the byte plane padded to 768
    rows and the scale planes to 24 (the padding never read). N = 512:
    four column tiles, and whole 256-column blocks of the JAX kernel."""
    n, k = 512, 1280
    nchunk = k // 256
    # a card small enough that the chunks cut into ranges with a short last one
    sms = next(s for s in range(1, 64) if _uneven(tq.k4_plan(m, n, k, s), nchunk))
    jqt, tqt = _planes(qname, n, k)
    assert tqt.qs.shape == (768, n) and tqt.scales.shape == (24, n)
    x = rng.standard_normal((m, k)).astype(np.float32)
    xt = torch.from_numpy(x)
    xb = xt.to(torch.bfloat16)
    xg = tq._group_sums(xt, tq.K4_GROUP)
    args = (xb, xg, tqt.qs, tqt.scales, tqt.scales2, tqt.bias, tqt.bias2)
    got, cut = _emulate(*args, sms)
    assert _uneven(cut, nchunk)
    plain = tq._k4_plain(*args)
    assert torch.equal(tq.qmatmul(xt, tqt), plain)  # the wrapper's CPU path is the plain version
    want = np.asarray(jq._qmm_k4_pallas(jnp.asarray(x), jqt, interpret=True))
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=0, atol=RTOL * scale)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=RTOL * scale)


SHAPES_7B = {"wqkv": (12288, 4096), "wo": (4096, 4096), "wgu": (22016, 4096),
             "w_down": (4096, 11008), "output": (32000, 4096)}
SHAPES_TOY = {"wqkv": (2048, 1024), "wo": (1024, 1024), "wgu": (5632, 1024),
              "w_down": (1024, 2816)}


@pytest.mark.parametrize("sms", [4, 78, 114, 132])
@pytest.mark.parametrize("m", [1, 4, 8, 9, 33, 128])
def test_plan_covers_every_chunk_once(m, sms):
    for n, k in [*SHAPES_7B.values(), *SHAPES_TOY.values(), (512, 1280), (200, 1280),
                 (400, 1280)]:
        cut = tq.k4_plan(m, n, k, sms)
        nchunk = k // 256
        ranges = [range(sp * cut.chunks, min(nchunk, (sp + 1) * cut.chunks))
                  for sp in range(cut.splits)]
        assert all(len(r) > 0 for r in ranges)
        assert sorted(c for r in ranges for c in r) == list(range(nchunk))
        assert cut.rows in (1, 4, 8)
        assert cut.row_tiles * cut.rows >= m > (cut.row_tiles - 1) * cut.rows
        assert cut.col_tiles == -(-n // tq.I4G_TN)
        assert cut.blocks == cut.row_tiles * cut.col_tiles * cut.splits
        if cut.splits > 1:
            assert cut.row_tiles * cut.col_tiles <= tq.I4G_TICKETS


# (splits, chunks per split, blocks) on a 132-SM card at M = 1 and 8 (one row tile)
PLANS_132 = {
    ("7b", "wqkv"): (8, 2, 768), ("7b", "wo"): (8, 2, 256), ("7b", "wgu"): (3, 6, 516),
    ("7b", "w_down"): (8, 6, 256), ("7b", "output"): (1, 16, 250),
    ("toy", "wqkv"): (4, 1, 64), ("toy", "wo"): (4, 1, 32), ("toy", "wgu"): (4, 1, 176),
    ("toy", "w_down"): (11, 1, 88),
}


@pytest.mark.parametrize("scale,name", list(PLANS_132))
@pytest.mark.parametrize("m", [1, 8])
def test_plan_block_counts(m, scale, name):
    """w_down's 43 chunks: 8 splits of 6 (the last of 1), 256 blocks (the
    parent's 32-column tiles gave 128 blocks and no split); the 32000-row
    head's 250 column tiles already fill the card, so it keeps one split
    and no merge. A k4 chunk is a 4-bit k_major chunk (one pack group), so
    the cut is k_major's at 4 bits."""
    n, k = (SHAPES_7B if scale == "7b" else SHAPES_TOY)[name]
    cut = tq.k4_plan(m, n, k, 132)
    assert (cut.splits, cut.chunks, cut.blocks) == PLANS_132[scale, name]
    assert cut.rows == m and cut.row_tiles == 1
    assert cut == tq.kmajor_plan(m, n, k, 4, 132)


# ---------------------------------------------------------------------------
# the nibble-to-float steps, bit for bit
# ---------------------------------------------------------------------------


def _byte_perm(x: np.ndarray, y, sel: int) -> np.ndarray:
    """CUDA's __byte_perm(x, y, sel) on u32 arrays: byte i of the result is
    byte (sel >> 4 i) & 7 of the 8 bytes {y:x} (x bytes 0-3, y bytes 4-7)."""
    y = np.broadcast_to(np.asarray(y, dtype=np.uint32), x.shape)
    src = [(x >> np.uint32(8 * i)) & np.uint32(0xFF) for i in range(4)] + \
        [(y >> np.uint32(8 * i)) & np.uint32(0xFF) for i in range(4)]
    out = np.zeros_like(x)
    for i in range(4):
        out |= src[(sel >> (4 * i)) & 7] << np.uint32(8 * i)
    return out


def _transpose4x4(r):
    """split_merge::transpose4x4 on the u32 arrays r[0..3] (row i: bytes of
    columns 0..3) -> out[c] (bytes of rows 0..3 of column c)."""
    t0 = _byte_perm(r[0], r[1], 0x5140)
    t1 = _byte_perm(r[2], r[3], 0x5140)
    t2 = _byte_perm(r[0], r[1], 0x7362)
    t3 = _byte_perm(r[2], r[3], 0x7362)
    return [_byte_perm(t0, t1, 0x5410), _byte_perm(t0, t1, 0x7632),
            _byte_perm(t2, t3, 0x5410), _byte_perm(t2, t3, 0x7632)]


def test_nibble_words_give_every_nibble_exactly():
    """For a byte plane of 16 rows (one warp's) whose 4 x 4 blocks hold
    every byte value, so every (lo, hi) nibble pair: the kernel's word
    loads (4 columns of a row), the 4 x 4 transpose, the masks 0x0F0F0F0F
    and 0xF0F0F0F0, the byte permute __byte_perm(u, 0x4B00, 0x5440 + t) and
    the subtraction of 2^23 give, for K row 4 r4 + t of column c, the lo
    nibble q and 16 times the hi nibble, exactly."""
    g = np.random.default_rng(4)
    qs = np.stack([g.permutation(256) for _ in range(16)]).astype(np.uint8)  # [16 rows, 256 cols]
    words = qs.astype(np.uint32).reshape(16, 64, 4)
    words = sum(words[:, :, c] << np.uint32(8 * c) for c in range(4))  # [row, lane]: 4 columns
    seen = np.zeros((2, 16), bool)
    for r4 in range(4):
        col = _transpose4x4([words[4 * r4 + t] for t in range(4)])
        for c in range(4):
            for plane, mask in enumerate((0x0F0F0F0F, 0xF0F0F0F0)):
                u = col[c] & np.uint32(mask)
                for t in range(4):
                    f = _byte_perm(u, 0x4B00, 0x5440 + t).view(np.float32) - np.float32(2.0 ** 23)
                    assert f.dtype == np.float32
                    byte = qs[4 * r4 + t, c::4].astype(np.int64)
                    want = (byte & 15) if plane == 0 else 16 * (byte >> 4)
                    np.testing.assert_array_equal(f, want.astype(np.float32))
                    seen[plane, want >> (4 * plane)] = True
    assert seen.all()


def _scales(rng):
    """f32 scales of both signs and a wide range of magnitudes, GGUF-like
    ones (f16 d times a 6-bit sub-scale), the smallest a 4-bit block gives
    (the least f16 subnormal 2^-24 times a sub-scale of 1), the prescale's
    lower limit 2^-122, scales whose products sit on bf16 ties, and 0."""
    d = rng.standard_normal(300).astype(np.float16).astype(np.float32)
    ties = (2 * rng.integers(0, 128, 100) + 1).astype(np.float32) * np.float32(2.0 ** -8) + 1
    return np.concatenate([
        (rng.standard_normal(1500) * np.exp(rng.uniform(-40, 20, 1500))).astype(np.float32),
        d * rng.integers(1, 64, 300).astype(np.float32), ties, -ties,
        np.float32([2.0 ** -24, 2.0 ** -24 * 63, np.float16(6.1e-5) * 1, 2.0 ** -122,
                    -(2.0 ** -122) * 1.5, 1.0, 1.0 + 2.0 ** -8, 3.0 * 2.0 ** -9, 0.0])])


@pytest.mark.parametrize("plane", ["lo", "hi"])
def test_dequantization_is_bit_exact_with_the_plain_rounding(plane, rng):
    """The kernel's weight in f32 arithmetic, for every nibble value: the
    scale s (hi: prescaled, fl(s * 2^-4), exact) and the permuted float
    f = 2^23 + u (u = q, hi: 16 q) give fma(s, f, fl(-s * 2^23)), whose
    exact value is s * u, rounded once: fl(s * q), as the plain version's
    product. (In float64 s * f and the sum are exact, so rounding the sum
    to f32 is the FMA's single rounding.) Then rounded to nearest even bf16
    into the high half of a word whose low half is zero, its f32 bits equal
    the plain version's bf16(fl(s * q)) at every scale of _scales(), ties
    included, with one exception: for q = 0 under a negative scale the FMA
    gives +0 (x - x is +0) where the plain product gives -0: equal values,
    and adding either zero to an f32 sum leaves its bits alone unless the
    sum is itself -0 (the sums start at +0)."""
    q = torch.arange(16, dtype=torch.float32)
    s = torch.from_numpy(_scales(rng))
    u = q if plane == "lo" else 16 * q
    se = s
    if plane == "hi":
        se = s * torch.tensor(0.0625)
        assert torch.equal(se * torch.tensor(16.0), s)  # the prescale is exact
    f = torch.tensor(2.0 ** 23) + u  # the byte permute's float, exact
    c = se * torch.tensor(-(2.0 ** 23))  # exact
    assert torch.equal(c.double(), se.double() * -(2.0 ** 23))
    p = (se.double()[:, None] * f.double()[None, :] + c.double()[:, None]).float()
    plain = s[:, None] * q[None, :]  # fl(s * q)
    widened = (p.to(torch.bfloat16).view(torch.int16).to(torch.int32) << 16).view(torch.float32)
    want = plain.to(torch.bfloat16).float()
    neg_zero = (q[None, :] == 0) & (s[:, None] < 0)
    assert torch.equal(widened.view(torch.int32)[~neg_zero], want.view(torch.int32)[~neg_zero])
    assert (widened.view(torch.int32)[neg_zero] == 0).all()  # +0 ...
    assert (want.view(torch.int32)[neg_zero] == torch.tensor(-0.0).view(torch.int32)).all()  # -0
    acc = torch.tensor([0.0, 1.5, -2.0 ** -120])  # what adding either zero does to an f32 sum
    assert torch.equal((acc + 0.0).view(torch.int32), (acc + -0.0).view(torch.int32))
    # the ties do occur: some products lie halfway between two bf16 values
    assert ((p.view(torch.int32) & 0xFFFF) == 0x8000).any()
