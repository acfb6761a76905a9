"""A CPU rehearsal of the i8g kernel's split-K order
(pipeinfer_tpu_torch/csrc/qmatmul_i8g.cu). A torch emulation cuts K as
``i8g_plan`` cuts it: into ranges of whole 128-row chunks (four to a
512-row slab), each chunk into 8 warps of 16 rows, exact integer dots per
warp and chunk scaled by sw * sx of the chunk's slab, the warps summed in
warp order and the splits in split order. It is held against the port's
plain version and the JAX package's Pallas kernel in interpret mode on the
same planes (Q6_K and Q8_0 weights requantized to i8g), at M = 1, 8, 9
and 33 and at a K whose chunks do not divide evenly into the splits. The
plan itself is checked at the 7B and toy shapes. f32; the integer dots are
exact on every side, so what differs is the order of the f32 sums: rtol
1e-5 of max|out|."""

import importlib
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pipeinfer_tpu.gguf.constants import GGMLQuantType as JQ
from pipeinfer_tpu.quant import pack as jpack
from pipeinfer_tpu_torch.models.convert import quant_from_numpy
from pipeinfer_tpu_torch.ops import qmatmul as tq

jq = importlib.import_module("pipeinfer_tpu.ops.qmatmul")
RTOL = 1e-5
WARPS, ROWS_PER_WARP = 8, 16  # KG and CH in the kernel
CHUNKS_PER_SLAB = tq.I8G_SLAB // tq.I8G_CHUNK


def _emulate(xq, sx, qs, sw, sms):
    """The kernel's arithmetic, cut and summed in the kernel's order."""
    m, kp = xq.shape
    n = qs.shape[1]
    cut = tq.i8g_plan(m, n, kp, sms)
    nchunk = kp // tq.I8G_CHUNK
    x = xq.double()
    w8 = qs.double()
    parts = []
    for sp in range(cut.splits):
        acc = torch.zeros(WARPS, m, n)  # one f32 accumulator per warp
        for ch in range(sp * cut.chunks, min(nchunk, (sp + 1) * cut.chunks)):
            s = ch // CHUNKS_PER_SLAB
            for w in range(WARPS):
                k0 = ch * tq.I8G_CHUNK + w * ROWS_PER_WARP
                dot = (x[:, k0:k0 + ROWS_PER_WARP] @ w8[k0:k0 + ROWS_PER_WARP]).float()
                acc[w] = acc[w] + dot * (sw[s] * sx[s])
        part = acc[0]
        for w in range(1, WARPS):
            part = part + acc[w]
        parts.append(part)
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out, cut


def _planes(rng, n, k, qtype):
    """A weight of `qtype` requantized to i8g by the JAX package, its planes
    carried to the port (CPU), and the JAX QuantTensor."""
    w = (rng.standard_normal((n, k)) * 0.1).astype(np.float32)
    jqt = jq.to_device(jpack.pack_array(w, qtype), layout="i8g")
    assert jqt.layout == "i8g"
    planes = {f: None if getattr(jqt, f) is None else np.asarray(getattr(jqt, f))
              for f in ("qs", "qh", "scales", "bias")}
    tqt = quant_from_numpy(types.SimpleNamespace(**planes, qtype=jqt.qtype, shape=jqt.shape,
                                                 layout="i8g"), torch.device("cpu"))
    return jqt, tqt


def _uneven(cut, nchunk):
    return cut.splits > 1 and nchunk % cut.chunks != 0


@pytest.mark.parametrize("qtype", [JQ.Q6_K, JQ.Q8_0])
@pytest.mark.parametrize("m", [1, 8, 9, 33])
def test_split_order_matches_plain_and_pallas_interpret(m, qtype, rng):
    n, k = 384, 2304  # 3 column tiles; K padded to 2560: 5 slabs, 20 chunks
    kp = -(-k // tq.I8G_SLAB) * tq.I8G_SLAB
    nchunk = kp // tq.I8G_CHUNK
    # a card small enough that the 20 chunks cut into ranges with a short last one
    sms = next(s for s in range(1, 64) if _uneven(tq.i8g_plan(m, n, kp, s), nchunk))
    jqt, tqt = _planes(rng, n, k, qtype)
    assert tqt.qs.shape == (kp, n)
    x = rng.standard_normal((m, k)).astype(np.float32)
    xq, sx = tq.quantize_activations(torch.from_numpy(x), kp, tq.I8G_SLAB)
    got, cut = _emulate(xq, sx, tqt.qs, tqt.scales, sms)
    assert _uneven(cut, nchunk)
    plain = tq._i8g_plain(xq, sx, tqt.qs, tqt.scales)
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
    for n, k in [*SHAPES_7B.values(), *SHAPES_TOY.values(), (200, 1536), (384, 2304)]:
        kp = -(-k // tq.I8G_SLAB) * tq.I8G_SLAB
        cut = tq.i8g_plan(m, n, kp, sms)
        nchunk = kp // tq.I8G_CHUNK
        ranges = [range(sp * cut.chunks, min(nchunk, (sp + 1) * cut.chunks))
                  for sp in range(cut.splits)]
        assert all(len(r) > 0 for r in ranges)
        assert sorted(c for r in ranges for c in r) == list(range(nchunk))
        assert cut.rows in (1, 4, 8) and cut.row_tiles * cut.rows >= m > (cut.row_tiles - 1) * cut.rows
        assert cut.col_tiles == -(-n // tq.I4G_TN)
        assert cut.blocks == cut.row_tiles * cut.col_tiles * cut.splits
        if cut.splits > 1:
            assert cut.row_tiles * cut.col_tiles <= tq.I4G_TICKETS


# (splits, chunks per split, blocks) on a 132-SM card at M = 1 and 8 (one row tile)
PLANS_132 = {
    ("7b", "wqkv"): (5, 7, 480), ("7b", "wo"): (8, 4, 256), ("7b", "wgu"): (3, 11, 516),
    ("7b", "w_down"): (8, 11, 256), ("7b", "output"): (1, 32, 250),
    ("toy", "wqkv"): (8, 1, 128), ("toy", "wo"): (8, 1, 64), ("toy", "wgu"): (4, 2, 176),
    ("toy", "w_down"): (24, 1, 192),
}


@pytest.mark.parametrize("scale,name", list(PLANS_132))
@pytest.mark.parametrize("m", [1, 8])
def test_plan_block_counts(m, scale, name):
    """w_down: 8 splits of 11 chunks, 256 blocks (the parent's 32-column
    tiles gave 128 blocks and no split); wo likewise fills two blocks per
    SM; the 32000-row head's 250 column tiles already fill the card, so it
    keeps one split and no merge; the toy widths split down to single
    chunks and still leave part of the card idle."""
    n, k = (SHAPES_7B if scale == "7b" else SHAPES_TOY)[name]
    cut = tq.i8g_plan(m, n, -(-k // tq.I8G_SLAB) * tq.I8G_SLAB, 132)
    assert (cut.splits, cut.chunks, cut.blocks) == PLANS_132[scale, name]
    assert cut.rows == m and cut.row_tiles == 1


def test_plans_share_the_cut():
    """i4g and i8g cut with one rule, each over its own K unit (a 256-row
    slab, a 128-row chunk): the same unit count gives the same cut."""
    for m, n, units, sms in [(1, 4096, 44, 132), (8, 4096, 16, 132), (33, 12288, 16, 114),
                             (9, 1024, 24, 4), (1, 32000, 16, 132)]:
        a = tq.i4g_plan(m, n, units * tq.I4G_SLAB, sms)
        b = tq.i8g_plan(m, n, units * tq.I8G_CHUNK, sms)
        assert tuple(a) == tuple(b)
