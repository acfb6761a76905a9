"""The port's own load_model (GGUF -> planes built by the port) against the
JAX package's to_device planes for the same files: the nano Q4_K bench
target (i4g) and a tiny Q6_K llama (i8g).

Both plane fits dequantize the same raw blocks and refit them in f32,
but they sum in different orders, so a value on a rounding boundary may
land one nibble (or one s8 step) apart: the integer planes must agree on
>= 99.9% of entries with every difference a single step. The scales agree
within rtol 1e-5 on >= 99.9% of entries; the rest are (half-slab, column)
fits where such a flip happened inside the i4g least-squares refit, which
moves that column's (step, wmin) pair as a whole, so for those the bar is
the weights they reconstruct: within one quantization step of the JAX
package's. The n_major embedding planes are copies and agree exactly."""

import importlib

import numpy as np
import pytest

from pipeinfer_tpu.gguf.constants import GGMLQuantType as JQ
from pipeinfer_tpu.models import load_model as j_load
from pipeinfer_tpu.ops.qmatmul import QuantTensor as JQuantTensor
from pipeinfer_tpu.tools import testmodel
from pipeinfer_tpu_torch.models import load_model
from pipeinfer_tpu_torch.ops import qmatmul as tq
from pipeinfer_tpu_torch.ops.qmatmul import QuantTensor

jq = importlib.import_module("pipeinfer_tpu.ops.qmatmul")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_loader")
    testmodel.build_bench_pair(d / "t.gguf", d / "d.gguf", scale="nano", eps=0.5)
    testmodel.build_tiny_llama(d / "q6.gguf", seed=5, n_layers=2, n_embd=512, n_heads=4,
                               n_kv_heads=2, n_ff=1024, n_vocab=256, qtype=JQ.Q6_K)
    return {"nano_q4k": (d / "t.gguf", "i4g"), "tiny_q6k": (d / "q6.gguf", "i8g")}


def _pairs(jparams, tparams):
    """(slot name, JAX leaf, port leaf) over both trees."""
    assert sorted(jparams) == sorted(tparams)
    for k in jparams:
        if k == "layers":
            for li, (jl, tl) in enumerate(zip(jparams[k], tparams[k], strict=True)):
                assert sorted(jl) == sorted(tl)
                for s in jl:
                    yield f"blk.{li}.{s}", jl[s], tl[s]
        else:
            yield k, jparams[k], tparams[k]


def _int_planes_close(name, j, t, nibbles):
    j, t = j.astype(np.int16), t.astype(np.int16)
    if nibbles:  # compare each nibble as its own value
        j = np.stack([j & 15, j >> 4])
        t = np.stack([t & 15, t >> 4])
    diff = np.abs(j - t)
    assert diff.max() <= 1, f"{name}: a plane entry differs by {diff.max()} steps"
    assert (diff == 0).mean() >= 0.999, f"{name}: only {(diff == 0).mean():.5f} equal"


@pytest.mark.parametrize("model", ["nano_q4k", "tiny_q6k"])
def test_port_planes_match_jax_planes(files, model, monkeypatch):
    path, layout = files[model]
    monkeypatch.setenv("PIPEINFER_WEIGHT_LAYOUT", "i4g")  # i8g for non-4-bit formats
    jparams, _ = j_load(path)
    tparams, _ = load_model(path, device="cpu")
    seen = set()
    n_close = n_scale = 0
    for name, j, t in _pairs(jparams, tparams):
        if not isinstance(j, JQuantTensor):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=name)
            continue
        assert isinstance(t, QuantTensor) and t.layout == j.layout and t.shape == j.shape
        seen.add(t.layout)
        jqs, tqs = np.asarray(j.qs), t.qs.numpy()
        assert jqs.shape == tqs.shape and jqs.dtype == tqs.dtype, name
        if t.layout == "n_major":
            np.testing.assert_array_equal(tqs, jqs, err_msg=name)
            np.testing.assert_array_equal(t.scales.numpy(), np.asarray(j.scales), err_msg=name)
            np.testing.assert_array_equal(t.bias.numpy(), np.asarray(j.bias), err_msg=name)
            continue
        _int_planes_close(name, jqs, tqs, nibbles=t.layout == "i4g")
        for plane in ("scales", "bias"):
            jp, tp = np.asarray(getattr(j, plane)), getattr(t, plane).numpy()
            n_close += int(np.isclose(tp, jp, rtol=1e-5, atol=0).sum())
            n_scale += jp.size
        # reconstructed weights W^T [Kp, N] within one quantization step
        jw, tw = np.asarray(jq.dequant_T(j)), tq.dequant_T(t).numpy()
        rows = 128 if t.layout == "i4g" else 512  # rows per scale row
        step = np.repeat(np.maximum(np.asarray(j.scales), t.scales.numpy()), rows, axis=0)
        assert (np.abs(tw - jw) <= 1.01 * step[: jw.shape[0]] + 1e-7).all(), \
            f"{name}: weights off by more than one step"
    assert n_close >= 0.999 * n_scale, f"{n_close} of {n_scale} scales within rtol 1e-5"
    assert seen == {"n_major", layout}
