"""The port's `tools.quantize` (a copy of the JAX package's) against the
JAX package's on a tiny f32 llama, on the CPU.

Every format, Q6_K included, gives the JAX package's bytes: the port's
quant/formats.py rounds through its own native runtime (native.py) where
the JAX package rounds through its native library, Q6_K as
`round_clip(qv + 32, 0, 63)`. Before the port had that runtime it rounded
qv in numpy and added 32, which parts from the JAX package on a few f32
near-ties; the file-level Q6_K check below, which reads both files back
and bounds each value to one quantization step of its 16-value group
(max|x| / 31, 5% over for the scales' own rounding) and the share of
differing values to 1e-3, now finds none.
"""

import hashlib

import numpy as np
import pytest

from pipeinfer_tpu.tools import quantize as jq
from pipeinfer_tpu_torch.gguf.constants import GGMLQuantType
from pipeinfer_tpu_torch.gguf.reader import GGUFReader
from pipeinfer_tpu_torch.models import load_model
from pipeinfer_tpu_torch.tools import quantize as tq
from pipeinfer_tpu_torch.tools import testmodel


@pytest.fixture(scope="module")
def f32_model(tmp_path_factory):
    path = tmp_path_factory.mktemp("torch_quantize") / "f32.gguf"
    testmodel.build_tiny_llama(path, seed=3, n_layers=2, n_embd=256, n_heads=4, n_kv_heads=2,
                               n_ff=512, n_vocab=300)
    return path


def _sha(path) -> str:
    return hashlib.sha256(open(path, "rb").read()).hexdigest()


@pytest.mark.parametrize("ftype", ["q4_k", "q8_0", "q4_0", "q5_k", "q6_k"])
def test_quantize_gives_the_jax_packages_bytes(f32_model, tmp_path, ftype):
    j_out, t_out = tmp_path / "j.gguf", tmp_path / "t.gguf"
    jq.quantize_file(str(f32_model), str(j_out), jq.FTYPES[ftype])
    tq.quantize_file(str(f32_model), str(t_out), tq.FTYPES[ftype])
    assert _sha(t_out) == _sha(j_out)
    with GGUFReader(t_out) as r:
        assert r.tensors["blk.0.ffn_down.weight"].qtype == tq.FTYPES[ftype]
        assert r.tensors["blk.0.attn_norm.weight"].qtype == GGMLQuantType.F32
        head = GGMLQuantType.Q6_K if ftype.endswith("_k") else GGMLQuantType.Q8_0
        assert r.tensors["output.weight"].qtype == head


def test_q6_k_within_one_step_of_the_jax_package(f32_model, tmp_path):
    j_out, t_out = tmp_path / "j.gguf", tmp_path / "t.gguf"
    jq.quantize_file(str(f32_model), str(j_out), jq.FTYPES["q6_k"])
    tq.quantize_file(str(f32_model), str(t_out), tq.FTYPES["q6_k"])
    n_diff = n_all = 0
    with GGUFReader(j_out) as rj, GGUFReader(t_out) as rt, GGUFReader(f32_model) as rs:
        assert list(rj.tensors) == list(rt.tensors)
        for name, info in rt.tensors.items():
            assert info.qtype == rj.tensors[name].qtype and info.shape == rj.tensors[name].shape
            got, want = np.asarray(rt.tensor(name)), np.asarray(rj.tensor(name))
            src = np.asarray(rs.tensor(name))
            if info.qtype != GGMLQuantType.Q6_K:
                assert bytes(rt.tensor_bytes(name)) == bytes(rj.tensor_bytes(name))
                continue
            step = np.repeat(np.abs(src.reshape(-1, 16)).max(1) / 31, 16).reshape(src.shape)
            d = np.abs(got - want)
            assert (d <= 1.05 * step).all(), name
            n_diff += int((d > 0).sum())
            n_all += d.size
    assert n_diff <= 1e-3 * n_all


def test_quantize_main_and_the_output_loads(f32_model, tmp_path):
    out = tmp_path / "q.gguf"
    assert tq.main([str(f32_model), str(out), "q4_k", "--output-ftype", "q8_0", "-q",
                    "--device", "cpu"]) == 0
    with GGUFReader(out) as r:
        assert r.tensors["output.weight"].qtype == GGMLQuantType.Q8_0
        assert int(r.metadata["general.file_type"]) == int(GGMLQuantType.Q4_K)
    params, cfg = load_model(out, device="cpu")
    assert params["layers"][0]["wq"].qtype == GGMLQuantType.Q4_K and cfg.n_layers == 2
