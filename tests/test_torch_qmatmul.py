"""The port's i4g / i8g kernels (their plain PyTorch versions, which the CPU
runs) against the JAX package's Pallas kernels in interpret mode, on the
same weight planes carried across, and the n_major embedding gather.

Tolerance: the s8 x s8 dots are exact integers on both sides and the
activation quantization is the same arithmetic (one absmax scale per slab,
shared by all rows, round half to even), so what remains is f32
summation order in the per-slab scaling: rtol 1e-5 of the output's scale."""

import importlib
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pipeinfer_tpu.gguf.constants import GGMLQuantType as JQ
from pipeinfer_tpu.quant import pack as jpack
from pipeinfer_tpu_torch.gguf.constants import GGMLQuantType as TQ
from pipeinfer_tpu_torch.models.convert import quant_from_numpy
from pipeinfer_tpu_torch.quant import pack as tpack
from pipeinfer_tpu_torch.ops import qmatmul as tq

# the JAX package's ops/__init__ re-exports the function under the module's name
jq = importlib.import_module("pipeinfer_tpu.ops.qmatmul")
RTOL = 1e-5


def _carry(qt):
    """A JAX QuantTensor's planes as the port's QuantTensor (CPU)."""
    planes = {f: None if getattr(qt, f) is None else np.asarray(getattr(qt, f))
              for f in ("qs", "qh", "scales", "bias")}
    return quant_from_numpy(types.SimpleNamespace(**planes, qtype=qt.qtype, shape=qt.shape,
                                                  layout=qt.layout), torch.device("cpu"))


def _check(layout, qtype, m, k, n, rng):
    w = (rng.standard_normal((n, k)) * 0.1).astype(np.float32)
    x = rng.standard_normal((m, k)).astype(np.float32)
    jqt = jq.to_device(jpack.pack_array(w, qtype), layout=layout)
    assert jqt.layout == layout
    want = np.asarray(jq.qmatmul(jnp.asarray(x), jqt, prefer_pallas=True, interpret=True))
    before = (tq.i4g_matmul.launches, tq.i8g_matmul.launches)
    got = tq.qmatmul(torch.from_numpy(x), _carry(jqt)).numpy()
    # CPU tensors take the plain version: no kernel launch is counted
    assert (tq.i4g_matmul.launches, tq.i8g_matmul.launches) == before
    assert got.shape == (m, n)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * scale)


@pytest.mark.parametrize("n", [128, 384])
@pytest.mark.parametrize("k", [256, 768])
@pytest.mark.parametrize("m", [1, 5, 33])
def test_i4g_plain_matches_pallas_interpret(m, k, n, rng):
    _check("i4g", JQ.Q4_K, m, k, n, rng)


@pytest.mark.parametrize("qtype", [JQ.Q6_K, JQ.Q8_0])
@pytest.mark.parametrize("n", [128, 384])
@pytest.mark.parametrize("k", [512, 1536])
@pytest.mark.parametrize("m", [1, 5, 33])
def test_i8g_plain_matches_pallas_interpret(m, k, n, qtype, rng):
    _check("i8g", qtype, m, k, n, rng)


def test_activation_scale_shared_across_rows(rng):
    """One absmax scale per slab over ALL rows: a row of large values
    changes the quantization (and so the output) of the other rows, as in
    the reference; zero padding rows change nothing."""
    x = rng.standard_normal((3, 512)).astype(np.float32)
    xq, sx = tq.quantize_activations(torch.from_numpy(x), 512, tq.I4G_HALF)
    assert sx.shape == (4,)
    np.testing.assert_allclose(sx.numpy(), np.abs(x.reshape(3, 4, 128)).max(axis=(0, 2)) / 127,
                               rtol=1e-7)
    padded = np.concatenate([x, np.zeros((5, 512), np.float32)])
    xq2, sx2 = tq.quantize_activations(torch.from_numpy(padded), 512, tq.I4G_HALF)
    assert torch.equal(sx, sx2) and torch.equal(xq, xq2[:3])


def test_dequant_rows_n_major_exact(rng):
    n, k = 64, 512
    w = rng.standard_normal((n, k)).astype(np.float32)
    jqt = jq.to_device(jpack.pack_array(w, JQ.Q4_K), layout="n_major")
    ids = np.array([[3, 7, 63], [0, 31, 3]], np.int32)
    want = np.asarray(jq.dequant_rows(jqt, jnp.asarray(ids)))
    got = tq.dequant_rows(_carry(jqt), torch.from_numpy(ids)).numpy()
    assert got.shape == (2, 3, k)
    np.testing.assert_array_equal(got, want)


def test_concat_qt_is_columnwise(rng):
    """Fusing projections along N gives the same output columns: the
    activation scales depend on x alone and every plane is per column."""
    k = 512
    x = torch.from_numpy(rng.standard_normal((4, k)).astype(np.float32))
    parts = [tq.to_device(tpack.pack_array(rng.standard_normal((n, k)).astype(np.float32),
                                           TQ.Q4_K), layout="i4g", device="cpu")
             for n in (256, 128)]
    fused = tq.concat_qt(parts)
    assert fused.shape == (384, k)
    want = torch.cat([tq.qmatmul(x, p) for p in parts], dim=1)
    torch.testing.assert_close(tq.qmatmul(x, fused), want, rtol=0, atol=0)



def test_ragged_n_takes_the_dense_fallback(rng):
    """A head whose N is not a multiple of 4 (a 32003-token vocabulary, say)
    goes to the dense bf16 fallback, as the JAX package routes shapes its
    kernels do not take; the kernels' own layouts otherwise."""
    k = 256
    w = rng.standard_normal((130, k)).astype(np.float32)
    x = torch.from_numpy(rng.standard_normal((3, k)).astype(np.float32))
    qt = tq.to_device(tpack.pack_array(w, TQ.Q4_K), layout="i4g", device="cpu")
    assert not tq.kernel_supported(qt)
    assert tq.kernel_supported(tq.to_device(tpack.pack_array(w[:128], TQ.Q4_K), device="cpu"))
    want = x.to(torch.bfloat16).float() @ tq.dequant_T(qt, torch.bfloat16).float()
    torch.testing.assert_close(tq.qmatmul(x, qt), want, rtol=0, atol=0)
