"""The port's exact layouts (k_major, i8, k4) against the JAX package, on
the same packed planes.

These layouts are pure repacks of the GGUF block planes (no refit), so the
port's device planes and its dequantization must equal the JAX package's
bit for bit. The kernels' plain versions (which the CPU runs) are held to
the JAX Pallas kernels run in interpret mode: every weight is the same
bf16 value on both sides and its product with the bf16 activation is exact
in f32, so only the f32 summation order differs: 1e-5 of max|out|.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pipeinfer_tpu.gguf.constants import GGMLQuantType as JQ
from pipeinfer_tpu.quant import pack as jpack
from pipeinfer_tpu_torch.gguf.constants import GGMLQuantType as TQ
from pipeinfer_tpu_torch.models.convert import quant_from_numpy
from pipeinfer_tpu_torch.ops import qmatmul as tq
from pipeinfer_tpu_torch.quant.pack import PackedWeight

# the JAX package's ops/__init__ re-exports the function under the module's name
jq = importlib.import_module("pipeinfer_tpu.ops.qmatmul")
RTOL = 1e-5
PLANES = ("qs", "qh", "scales", "bias", "scales2", "bias2")
ALL_FORMATS = ("Q4_0", "Q4_1", "Q5_0", "Q5_1", "Q8_0", "Q2_K", "Q3_K", "Q4_K", "Q5_K", "Q6_K")
CASES = [("k_major", q) for q in ALL_FORMATS] + [("i8", q) for q in ("Q4_K", "Q6_K", "Q8_0")] \
    + [("k4", q) for q in ("Q4_0", "Q4_1", "Q4_K")]
COUNTERS = (tq.kmajor_matmul, tq.i8_matmul, tq.k4_matmul)


def _packed(qname, n, k, rng):
    """(JAX PackedWeight, the port's PackedWeight) of one random weight."""
    w = (rng.standard_normal((n, k)) * 0.1).astype(np.float32)
    jpw = jpack.pack_array(w, JQ[qname])
    return jpw, PackedWeight(TQ[qname], jpw.shape, jpw.qs, jpw.qh, jpw.scales, jpw.bias)


def _planes_equal(jqt, tqt):
    assert (tqt.layout, tqt.shape, int(tqt.qtype)) == (jqt.layout, jqt.shape, int(jqt.qtype))
    for f in PLANES:
        a, b = getattr(jqt, f), getattr(tqt, f)
        assert (a is None) == (b is None), f
        if a is not None:
            a = np.asarray(a)
            assert b.numpy().dtype == a.dtype and np.array_equal(b.numpy(), a), f


@pytest.mark.parametrize("layout,qname", CASES)
def test_planes_equal_the_jax_planes(layout, qname, rng):
    jpw, tpw = _packed(qname, 160, 768, rng)
    _planes_equal(jq.to_device(jpw, layout=layout), tq.to_device(tpw, layout=layout, device="cpu"))


@pytest.mark.parametrize("layout,qname", CASES)
def test_dequant_is_bit_equal(layout, qname, rng):
    jpw, tpw = _packed(qname, 96, 512, rng)
    jqt = jq.to_device(jpw, layout=layout)
    tqt = tq.to_device(tpw, layout=layout, device="cpu")
    np.testing.assert_array_equal(tq.dequant(tqt).numpy(), np.asarray(jq.dequant(jqt)))
    np.testing.assert_array_equal(tq.dequant_T(tqt, torch.bfloat16).float().numpy(),
                                  np.asarray(jq.dequant_T(jqt, jnp.bfloat16)).astype(np.float32))


def _carry(jqt, cols=None):
    """A JAX QuantTensor's planes (first `cols` output columns) as the
    port's QuantTensor; every plane of these layouts keeps N last."""
    class Planes:
        pass

    p = Planes()
    for f in PLANES:
        a = getattr(jqt, f)
        setattr(p, f, None if a is None else np.asarray(a)[..., :cols])
    p.qtype, p.layout = jqt.qtype, jqt.layout
    p.shape = (cols or jqt.shape[0], jqt.shape[1])
    return quant_from_numpy(p, torch.device("cpu"))


@pytest.mark.parametrize("n", [384, 200])
@pytest.mark.parametrize("m", [1, 5, 33])
@pytest.mark.parametrize("layout,qname", CASES)
def test_plain_kernel_matches_pallas_interpret(layout, qname, m, n, rng):
    """N = 384 is ragged for the JAX kernel's 256-column block; N = 200 (not
    a multiple of 32 or 128) is the first 200 columns of a 256-column
    weight, whose JAX output columns do not depend on the rest."""
    n_jax = 256 if n == 200 else n
    jpw, _ = _packed(qname, n_jax, 768, rng)
    jqt = jq.to_device(jpw, layout=layout)
    x = rng.standard_normal((m, 768)).astype(np.float32)
    want = np.asarray(jq.qmatmul(jnp.asarray(x), jqt, prefer_pallas=True, interpret=True))[:, :n]
    tqt = _carry(jqt, n)
    assert tq.kernel_supported(tqt)
    before = [c.launches for c in COUNTERS]
    got = tq.qmatmul(torch.from_numpy(x), tqt).numpy()
    assert [c.launches for c in COUNTERS] == before  # the CPU runs the plain version
    assert got.shape == (m, n)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=RTOL * scale)


def test_k_major_plain_equals_the_jax_dense_fallback(rng):
    """Off the accelerator the JAX package multiplies bf16 x by the bf16
    dequantized weight; the k_major kernel's arithmetic is the same, which
    is why the CPU streams of both packages agree under k_major."""
    jpw, tpw = _packed("Q5_K", 128, 512, rng)
    x = rng.standard_normal((3, 512)).astype(np.float32)
    want = np.asarray(jq.qmatmul(jnp.asarray(x), jq.to_device(jpw, layout="k_major"),
                                 prefer_pallas=False))
    got = tq.qmatmul(torch.from_numpy(x), tq.to_device(tpw, layout="k_major", device="cpu"))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=RTOL * float(np.abs(want).max()))


@pytest.mark.parametrize("qname,k", [("Q6_K", 512), ("Q8_0", 512), ("Q4_0", 160)])
def test_k4_falls_back_to_i8(qname, k, rng):
    """k4 is for 4-bit formats with K % 256 == 0; anything else becomes i8,
    as in the JAX package."""
    jpw, tpw = _packed(qname, 64, k, rng)
    jqt = jq.to_device(jpw, layout="k4")
    tqt = tq.to_device(tpw, layout="k4", device="cpu")
    assert tqt.layout == jqt.layout == "i8"
    _planes_equal(jqt, tqt)
    x = torch.from_numpy(rng.standard_normal((2, k)).astype(np.float32))
    want = tq.qmatmul(x, tq.to_device(tpw, layout="i8", device="cpu"))
    torch.testing.assert_close(tq.qmatmul(x, tqt), want, rtol=0, atol=0)


@pytest.mark.parametrize("layout,qname", [("k_major", "Q5_K"), ("k_major", "Q6_K"),
                                          ("k_major", "Q3_K"), ("k4", "Q4_K"), ("i8", "Q4_1")])
def test_concat_qt_joins_every_plane(layout, qname, rng):
    """Fused projections (wq+wk+wv, gate+up): qh and k4's second planes are
    concatenated along N with the rest, and the fused weight gives the
    same output columns as its parts, as in the JAX package."""
    parts = [_packed(qname, n, 512, rng) for n in (256, 128, 64)]
    jf = jq.concat_qt([jq.to_device(jp, layout=layout) for jp, _ in parts])
    tparts = [tq.to_device(tp, layout=layout, device="cpu") for _, tp in parts]
    fused = tq.concat_qt(tparts)
    _planes_equal(jf, fused)
    assert fused.nbytes() == sum(p.nbytes() for p in tparts) == jf.nbytes()
    x = torch.from_numpy(rng.standard_normal((4, 512)).astype(np.float32))
    want = torch.cat([tq.qmatmul(x, p) for p in tparts], dim=1)
    torch.testing.assert_close(tq.qmatmul(x, fused), want, rtol=0,
                               atol=RTOL * float(want.abs().max()))


def test_dense_fallback_for_shapes_the_kernels_do_not_take(rng):
    """K that is not whole 256-row pack groups keeps k_major off its kernel
    (the JAX package's _pallas_supported), as does N % 4 != 0."""
    _, tpw = _packed("Q4_0", 64, 160, rng)
    qt = tq.to_device(tpw, layout="k_major", device="cpu")
    assert not tq.kernel_supported(qt)
    _, tpw = _packed("Q4_K", 130, 256, rng)
    for layout in ("k_major", "i8", "k4"):
        assert not tq.kernel_supported(tq.to_device(tpw, layout=layout, device="cpu"))
