"""A CPU rehearsal of the i4g kernel's split-K order
(pipeinfer_tpu_torch/csrc/qmatmul_i4g.cu). A torch emulation cuts K as
``i4g_plan`` cuts it: the slabs into ranges of whole slabs, each slab of a
range into 8 warps of 16 packed rows (lo nibbles K rows 16 w.., hi nibbles
128 + 16 w..), exact integer dots per warp and slab scaled by step * sx,
the slab's two affine min terms added by warp s % 8 into the same
accumulators, the warps summed in warp order and the splits in split
order. It is held against the port's plain version and the JAX package's
Pallas kernel in interpret mode on the same planes, at M = 1, 8, 9 and 33
and at a K whose slabs do not divide evenly into the splits. The plan
itself is checked at the 7B shapes. f32; the integer dots are exact on
every side, so what differs is the order of the f32 sums: rtol 1e-5 of
max|out|."""

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


def _emulate(xq, xsum, sx, qs, step, wmin, sms):
    """The kernel's arithmetic, cut and summed in the kernel's order."""
    m, kp = xq.shape
    n = qs.shape[1]
    cut = tq.i4g_plan(m, n, kp, sms)
    nslab = kp // tq.I4G_SLAB
    x = xq.double()
    v = qs.to(torch.int32)
    parts = []
    for sp in range(cut.splits):
        acc = torch.zeros(WARPS, m, n)  # one f32 accumulator per warp
        for s in range(sp * cut.slabs, min(nslab, (sp + 1) * cut.slabs)):
            for w in range(WARPS):
                p0 = s * 128 + w * ROWS_PER_WARP
                rows = v[p0:p0 + ROWS_PER_WARP].double()
                klo = s * 256 + w * ROWS_PER_WARP
                il = (x[:, klo:klo + ROWS_PER_WARP] @ (rows.long() & 15).double()).float()
                ih = (x[:, klo + 128:klo + 128 + ROWS_PER_WARP] @ (rows.long() >> 4).double()).float()
                acc[w] = acc[w] + il * (step[2 * s] * sx[2 * s])
                acc[w] = acc[w] + ih * (step[2 * s + 1] * sx[2 * s + 1])
            w = s % WARPS
            acc[w] = acc[w] + xsum[:, 2 * s, None] * (wmin[2 * s] * sx[2 * s])
            acc[w] = acc[w] + xsum[:, 2 * s + 1, None] * (wmin[2 * s + 1] * sx[2 * s + 1])
        part = acc[0]
        for w in range(1, WARPS):
            part = part + acc[w]
        parts.append(part)
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out, cut


def _planes(rng, n, k):
    """A Q4_K weight requantized to i4g by the JAX package, its planes
    carried to the port (CPU), and the JAX QuantTensor."""
    w = (rng.standard_normal((n, k)) * 0.1).astype(np.float32)
    jqt = jq.to_device(jpack.pack_array(w, JQ.Q4_K), layout="i4g")
    planes = {f: None if getattr(jqt, f) is None else np.asarray(getattr(jqt, f))
              for f in ("qs", "qh", "scales", "bias")}
    tqt = quant_from_numpy(types.SimpleNamespace(**planes, qtype=jqt.qtype, shape=jqt.shape,
                                                 layout="i4g"), torch.device("cpu"))
    return jqt, tqt


def _uneven(cut, nslab):
    return cut.splits > 1 and nslab % cut.slabs != 0


@pytest.mark.parametrize("m", [1, 8, 9, 33])
def test_split_order_matches_plain_and_pallas_interpret(m, rng):
    n, k = 384, 1792  # 3 column tiles, 7 slabs
    # a card small enough that the 7 slabs cut into ranges with a short last one
    sms = next(s for s in range(1, 64) if _uneven(tq.i4g_plan(m, n, k, s), k // tq.I4G_SLAB))
    jqt, tqt = _planes(rng, n, k)
    x = rng.standard_normal((m, k)).astype(np.float32)
    kp = tqt.qs.shape[0] * 2
    xq, sx = tq.quantize_activations(torch.from_numpy(x), kp, tq.I4G_HALF)
    xsum = xq.reshape(m, kp // 128, 128).sum(dim=2, dtype=torch.int32).float()
    got, cut = _emulate(xq, xsum, sx, tqt.qs, tqt.scales, tqt.bias, sms)
    assert _uneven(cut, kp // tq.I4G_SLAB)
    plain = tq._i4g_plain(xq, xsum, sx, tqt.qs, tqt.scales, tqt.bias)
    want = np.asarray(jq.qmatmul(jnp.asarray(x), jqt, prefer_pallas=True, interpret=True))
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=0, atol=RTOL * scale)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=RTOL * scale)


SHAPES_7B = [(12288, 4096), (4096, 4096), (22016, 4096), (4096, 11008), (32000, 4096)]


@pytest.mark.parametrize("sms", [4, 78, 114, 132])
@pytest.mark.parametrize("m", [1, 4, 8, 9, 33, 128])
def test_plan_covers_every_slab_once(m, sms):
    for n, k in SHAPES_7B + [(200, 768), (384, 1792)]:
        kp = -(-k // 256) * 256
        cut = tq.i4g_plan(m, n, kp, sms)
        nslab = kp // tq.I4G_SLAB
        ranges = [range(sp * cut.slabs, min(nslab, (sp + 1) * cut.slabs))
                  for sp in range(cut.splits)]
        assert all(len(r) > 0 for r in ranges)
        assert sorted(s for r in ranges for s in r) == list(range(nslab))
        assert cut.rows in (1, 4, 8) and cut.row_tiles * cut.rows >= m > (cut.row_tiles - 1) * cut.rows
        assert cut.col_tiles == -(-n // tq.I4G_TN)
        assert cut.blocks == cut.row_tiles * cut.col_tiles * cut.splits
        if cut.splits > 1:
            assert cut.row_tiles * cut.col_tiles <= tq.I4G_TICKETS


@pytest.mark.parametrize("k", [4096, 11008])
@pytest.mark.parametrize("m", [1, 8])
def test_plan_fills_the_card_at_n_4096(m, k):
    """wo and w_down at decode M: 32 column tiles alone would leave most of
    132 SMs idle; the splits give more than one block per SM."""
    cut = tq.i4g_plan(m, 4096, -(-k // 256) * 256, 132)
    assert cut.splits > 1 and cut.blocks > 132


@pytest.mark.parametrize("m", [1, 8])
def test_plan_keeps_one_split_for_the_output_head(m):
    """N = 32000 already fills the card's waves: no split, no merge."""
    cut = tq.i4g_plan(m, 32000, 4096, 132)
    assert cut.splits == 1 and cut.slabs == 16 and cut.blocks == 250
