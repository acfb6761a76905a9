"""The reference against the program at unit-test widths on the CPU, and
the benchmark's own k-quant encoders against the program's decoders."""

import numpy as np
import pytest
import torch

from pipeinfer_tpu_torch.gguf.constants import GGMLQuantType
from pipeinfer_tpu_torch.quant.formats import dequantize
from portbench import weights
from portbench.kquant import encode_q4_k, encode_q6_k
from portbench.reference import dequant
from portbench.reference.model import Reference
from portbench.tests import nano

torch.set_num_threads(1)


@pytest.mark.parametrize("qtype", ["Q4_K", "Q6_K"])
def test_kquant_bytes_decode_alike(qtype):
    """The encoders give valid payloads: the reference's decoder and the
    program's give the same values, close to the encoded weights."""
    w = torch.randn(48, 512, generator=torch.Generator().manual_seed(3)) * 0.1
    enc = {"Q4_K": encode_q4_k, "Q6_K": encode_q6_k}[qtype]
    raw = enc(w)
    mine = dequant.DECODERS[qtype](raw, 48, 512).numpy()
    port = dequantize(raw.numpy().reshape(-1), GGMLQuantType[qtype]).reshape(48, 512)
    assert np.array_equal(mine, port)
    step = {"Q4_K": 15, "Q6_K": 31}[qtype]
    assert np.abs(mine - w.numpy()).max() < 2 * np.abs(w.numpy()).max() / step


def _logits(arch, layout, monkeypatch, n=40):
    monkeypatch.setenv("PIPEINFER_WEIGHT_LAYOUT", layout)
    from pipeinfer_tpu_torch.runtime.context import Batch, InferenceContext

    mb = weights.make_bytes(nano.config(arch), "cpu")
    ctx = InferenceContext(weights.port_params(mb, "cpu"), weights.port_config(mb),
                           n_cells=512, device="cpu")
    toks = np.random.default_rng(1).integers(0, mb.n_vocab, n).tolist()
    b = Batch()
    for i, t in enumerate(toks):
        b.add(t, i, 0, True)
    return torch.tensor(ctx.decode(b)), mb, toks


def _err(a, b):
    """Widest logit error over the std of the second's logits."""
    return float((a - b).abs().max() / b.std())


# Measured at these widths: the program's exact k_major layout (bf16
# products) against the plain f32 reference 0.011-0.013; the card's i4g
# layout against the reference at the stated precision (4-bit regrid, s8
# activations per row) 0.053-0.057, against the plain one 0.12-0.13; the
# control (int4 activations) against the stated reference 0.67-0.70
EXACT_TOL, STATED_TOL = 0.03, 0.15


@pytest.mark.parametrize("arch", ["mpt", "llama"])
def test_reference_agrees_with_program(arch, monkeypatch):
    lp, mb, toks = _logits(arch, "k_major", monkeypatch)
    assert _err(lp, Reference(mb, "cpu", stated=False).logits(toks)) < EXACT_TOL
    lp, mb, toks = _logits(arch, "i4g", monkeypatch)
    assert _err(lp, Reference(mb, "cpu").logits(toks)) < STATED_TOL


@pytest.mark.parametrize("arch", ["mpt", "llama"])
def test_lower_precision_fails(arch, monkeypatch):
    """The control, the reference at int4 activations, lies far outside the
    bar the program keeps."""
    _, mb, toks = _logits(arch, "i4g", monkeypatch)
    ref = Reference(mb, "cpu")
    assert _err(ref.with_bits(4).logits(toks), ref.logits(toks)) > 3 * STATED_TOL


@pytest.mark.parametrize("arch", ["mpt", "llama"])
def test_every_layer_moves_the_logits(arch):
    """The weight design keeps every layer live: removing any one layer's
    update moves the logits."""
    mb = weights.make_bytes(nano.config(arch), "cpu")
    ref = Reference(mb, "cpu", stated=False)
    toks = np.random.default_rng(2).integers(0, mb.n_vocab, 24).tolist()
    hs = ref.hidden_trace(toks)
    full = ref._mm(ref._norm(hs[-1]), "output")
    for li in range(1, len(hs)):
        skipped = hs[-1] - (hs[li] - hs[li - 1])
        moved = (ref._mm(ref._norm(skipped), "output") - full).abs().max()
        assert moved > 0.05 * full.std(), li


def test_stated_regrid_matches_the_served_layout():
    """The reference's own regrids give the values the program's i4g and
    i8g planes hold (worked out again from the same bytes)."""
    from pipeinfer_tpu_torch.ops import qmatmul as Q
    from pipeinfer_tpu_torch.quant import pack
    from portbench.reference.model import regrid_4bit, regrid_8bit

    w = torch.randn(256, 512, generator=torch.Generator().manual_seed(5)) * 0.05
    for qtype, enc, regrid in (("Q4_K", encode_q4_k, regrid_4bit),
                               ("Q6_K", encode_q6_k, regrid_8bit)):
        raw = enc(w)
        qt = Q.to_device(pack.pack(raw.numpy().reshape(-1), GGMLQuantType[qtype], (256, 512)),
                         layout="i4g" if qtype == "Q4_K" else "i8g", device="cpu")
        served = Q.dequant(qt)
        mine = regrid(dequant.DECODERS[qtype](raw, 256, 512))
        assert float((served - mine).abs().max()) <= 1e-6 * float(mine.abs().max()), qtype
