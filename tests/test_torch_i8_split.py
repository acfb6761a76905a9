"""A CPU rehearsal of the i8 kernel's split-K order and dequantization
(pipeinfer_tpu_torch/csrc/qmatmul_i8.cu). A torch emulation cuts K as
``i8_plan`` cuts it: into ranges of whole 128-row chunks, the last chunk
ragged where K % 128 != 0, each chunk into 8 warps of 16 rows (a warp past
K skips the chunk); each warp keeps its own f32 accumulator, into which the
warp that holds a group's first row subtracts the bias term xg * b before
adding its rows' products with the bf16 weights; the warps are summed in
warp order and the splits in split order. It is held against the port's
plain version and the JAX package's Pallas kernel in interpret mode on the
same planes (Q4_K, Q6_K and Q8_0), at M = 1, 8, 9 and 33, at a K whose
chunks do not divide evenly into the splits and at a Q8_0 K that is not a
multiple of 128. Every weight is the same bf16 value on every side and its
product with the bf16 activation is exact in f32, so what differs is the
order of the f32 sums: rtol 1e-5 of max|out|. The plan is checked at the
7B and toy shapes, and the kernel's integer-to-float step (a byte permute
and an add) in numpy and f32 torch arithmetic."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pipeinfer_tpu.gguf.constants import GGMLQuantType as JQ
from pipeinfer_tpu_torch.gguf.constants import GGMLQuantType as TQ
from pipeinfer_tpu_torch.ops import qmatmul as tq

jq = importlib.import_module("pipeinfer_tpu.ops.qmatmul")
RTOL = 1e-5
WARPS, ROWS_PER_WARP = 8, 16  # KG and CH in the kernel


def _emulate(x, xg, qs, scales, bias, group, sms):
    """The kernel's arithmetic, cut and summed in the kernel's order."""
    m, k = x.shape
    n = qs.shape[1]
    cut = tq.i8_plan(m, n, k, sms)
    nchunk = -(-k // tq.I8G_CHUNK)
    w = (tq._expand(scales, group, k) * qs.float()).to(torch.bfloat16).double()
    xd = x.double()
    parts = []
    for sp in range(cut.splits):
        acc = torch.zeros(WARPS, m, n)  # one f32 accumulator per warp
        for ch in range(sp * cut.chunks, min(nchunk, (sp + 1) * cut.chunks)):
            for wi in range(WARPS):
                k0 = ch * tq.I8G_CHUNK + wi * ROWS_PER_WARP
                if k0 >= k:  # the ragged last chunk: this warp's rows lie past K
                    continue
                if bias is not None and k0 % group == 0:  # fmaf(-xg, b, acc): one rounding
                    g = k0 // group
                    term = xg[:, g:g + 1].double() * bias[g].double()
                    acc[wi] = (acc[wi].double() - term).float()
                dot = xd[:, k0:k0 + ROWS_PER_WARP] @ w[k0:k0 + ROWS_PER_WARP]
                acc[wi] = (acc[wi].double() + dot).float()
        part = acc[0]
        for wi in range(1, WARPS):
            part = part + acc[wi]
        parts.append(part)
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out, cut


def _uneven(cut, nchunk):
    return cut.splits > 1 and nchunk % cut.chunks != 0


QUANTS = {"Q4_K": (0, 15), "Q6_K": (0, 63), "Q8_0": (-127, 127)}  # integer quant range


def _planes(rng, qname, n, k):
    """i8 planes of one format made from the numpy seed: quants in the
    format's range, positive scales, biases (zero for Q8_0), as the JAX
    QuantTensor and the port's (CPU). Made directly rather than packed, so
    K need only be a multiple of the group (packing wants whole 256-row
    groups)."""
    lo, hi = QUANTS[qname]
    group = 16 if qname == "Q6_K" else 32
    qs = rng.integers(lo, hi + 1, (k, n)).astype(np.int8)
    scales = (rng.random((k // group, n)) * 0.01 + 1e-3).astype(np.float32)
    bias = np.zeros_like(scales) if qname == "Q8_0" else \
        (rng.random((k // group, n)) * 0.08).astype(np.float32)
    jqt = jq.QuantTensor(jnp.asarray(qs), None, jnp.asarray(scales), jnp.asarray(bias),
                         qtype=JQ[qname], shape=(n, k), layout="i8")
    tqt = tq.QuantTensor(torch.from_numpy(qs), None, torch.from_numpy(scales),
                         torch.from_numpy(bias), qtype=TQ[qname], shape=(n, k), layout="i8")
    assert jqt.group == tqt.group == group
    return jqt, tqt


@pytest.mark.parametrize("qname,k", [("Q4_K", 2304), ("Q6_K", 2304), ("Q8_0", 2304),
                                     ("Q8_0", 1056)])
@pytest.mark.parametrize("m", [1, 8, 9, 33])
def test_split_order_matches_plain_and_pallas_interpret(m, qname, k, rng):
    """K = 2304: 18 chunks; K = 1056: 9 chunks, the last of 32 rows (warps
    2-7 skip it). N = 384: 3 column tiles."""
    n = 384
    nchunk = -(-k // tq.I8G_CHUNK)
    # a card small enough that the chunks cut into ranges with a short last one
    sms = next(s for s in range(1, 64) if _uneven(tq.i8_plan(m, n, k, s), nchunk))
    jqt, tqt = _planes(rng, qname, n, k)
    x = rng.standard_normal((m, k)).astype(np.float32)
    xt = torch.from_numpy(x)
    has_bias = qname != "Q8_0"
    xg = tq._group_sums(xt, tqt.group) if has_bias else None
    bias = tqt.bias if has_bias else None
    xb = xt.to(torch.bfloat16)
    got, cut = _emulate(xb, xg, tqt.qs, tqt.scales, bias, tqt.group, sms)
    assert _uneven(cut, nchunk)
    plain = tq._i8_plain(xb, xg, tqt.qs, tqt.scales, bias, tqt.group)
    assert torch.equal(tq.qmatmul(xt, tqt), plain)  # the wrapper's CPU path is the plain version
    want = np.asarray(jq.qmatmul(jnp.asarray(x), jqt, prefer_pallas=True, interpret=True))
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
    for n, k in [*SHAPES_7B.values(), *SHAPES_TOY.values(), (384, 2304), (384, 1056),
                 (200, 1280), (4096, 11008 + 32)]:
        cut = tq.i8_plan(m, n, k, sms)
        nchunk = -(-k // tq.I8G_CHUNK)
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
    ("7b", "wqkv"): (5, 7, 480), ("7b", "wo"): (8, 4, 256), ("7b", "wgu"): (3, 11, 516),
    ("7b", "w_down"): (8, 11, 256), ("7b", "output"): (1, 32, 250),
    ("toy", "wqkv"): (8, 1, 128), ("toy", "wo"): (8, 1, 64), ("toy", "wgu"): (4, 2, 176),
    ("toy", "w_down"): (22, 1, 176),
}


@pytest.mark.parametrize("scale,name", list(PLANS_132))
@pytest.mark.parametrize("m", [1, 8])
def test_plan_block_counts(m, scale, name):
    """w_down's 86 chunks: 8 splits of 11 (the last of 9), 256 blocks (the
    parent's 32-column tiles gave 128 blocks and no split); the 32000-row
    head's 250 column tiles already fill the card, so it keeps one split
    and no merge. Where K is a multiple of 512 the cut is i8g's."""
    n, k = (SHAPES_7B if scale == "7b" else SHAPES_TOY)[name]
    cut = tq.i8_plan(m, n, k, 132)
    assert (cut.splits, cut.chunks, cut.blocks) == PLANS_132[scale, name]
    assert cut.rows == m and cut.row_tiles == 1
    if k % tq.I8G_SLAB == 0:
        assert cut == tq.i8g_plan(m, n, k, 132)


def _byte_perm(x: np.ndarray, y: int, sel: int) -> np.ndarray:
    """CUDA's __byte_perm(x, y, sel) on u32 arrays: byte i of the result is
    byte (sel >> 4 i) & 7 of the 8 bytes {y:x} (x bytes 0-3, y bytes 4-7)."""
    src = [(x >> (8 * i)) & 0xFF for i in range(4)] + [np.uint32((y >> (8 * i)) & 0xFF)
                                                       for i in range(4)]
    out = np.zeros_like(x)
    for i in range(4):
        out |= src[(sel >> (4 * i)) & 7] << np.uint32(8 * i)
    return out


def test_byte_permute_gives_every_s8_value_exactly():
    """For all 256 s8 values q (4 to a word, byte t): the word XORed with
    0x80808080, then __byte_perm(u, 0x4B00, 0x5440 + t), is the float
    2^23 + q + 128, and minus 8388736 (2^23 + 128) it is q."""
    q = np.arange(-128, 128, dtype=np.int8)
    words = q.view(np.uint8).reshape(-1, 4).copy().view("<u4").reshape(-1)  # 64 words
    u = words ^ np.uint32(0x80808080)
    for t in range(4):
        bits = _byte_perm(u, 0x4B00, 0x5440 + t)
        assert np.all((bits >> np.uint32(8)) == 0x4B0000)
        f = bits.view(np.float32) - np.float32(8388736.0)
        assert f.dtype == np.float32
        np.testing.assert_array_equal(f, q[t::4].astype(np.float32))


def test_dequantization_is_bit_exact_with_the_plain_rounding(rng):
    """The kernel's dequantization in f32 torch arithmetic (q from the byte
    permute, fl(s * q), rounded to nearest even bf16 into the high half of
    a word whose low half is zero) gives the same f32 bits as bf16(fl(s *
    q)) for every s8 value, at random scales of every sign and magnitude,
    and at scales whose products sit on a bf16 tie."""
    q = np.arange(-128, 128, dtype=np.int8)
    words = torch.from_numpy(q.view(np.uint8).reshape(-1, 4).copy().view("<u4").reshape(-1)
                             .astype(np.int64))
    u = (words ^ 0x80808080).to(torch.int64)
    s = torch.from_numpy(np.concatenate([
        (rng.standard_normal(2000) * np.exp(rng.uniform(-20, 5, 2000))).astype(np.float32),
        np.float32([1.0, -1.0, 2.0 ** -7, 1.0 + 2.0 ** -8, 3.0 * 2.0 ** -9])]))
    for t in range(4):
        bits = torch.from_numpy(_byte_perm(u.numpy().astype(np.uint32), 0x4B00, 0x5440 + t)
                                .view(np.int32))
        qf = bits.view(torch.float32) - torch.tensor(8388736.0)
        qt = torch.from_numpy(q[t::4].astype(np.float32))
        assert torch.equal(qf, qt)
        p = s[:, None] * qf[None, :]  # fl(s * q)
        rounded = p.to(torch.bfloat16)  # __floats2bfloat162_rn: round to nearest even
        widened = (rounded.view(torch.int16).to(torch.int32) << 16).view(torch.float32)
        want = (s[:, None] * qt[None, :]).to(torch.bfloat16).float()
        assert torch.equal(widened.view(torch.int32), want.view(torch.int32))
