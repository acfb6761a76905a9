"""The split-K frame the i4g, i8g, i8, k_major and k4 kernels share
(pipeinfer_tpu_torch/csrc/split_merge.cuh): its constants against their
Python mirrors in ops/qmatmul.py, which the plans and the scratch buffer
are cut by; every split-K kernel takes them from the header and defines
none of its own; and an edit of the header renames every kernel library,
so a stale build never loads. Also the profiler tool's reading of the
port's kernel names from csrc/*.cu. (The kernels themselves need the
card: tests/test_torch_cuda.py.)"""

import re

import pytest

from pipeinfer_tpu_torch.ops import cuda_build
from pipeinfer_tpu_torch.ops import qmatmul as Q
from pipeinfer_tpu_torch.tools import profile_decode

HEADER = cuda_build.CSRC / "split_merge.cuh"
SPLIT_KERNELS = ("qmatmul_i4g", "qmatmul_i8g", "qmatmul_i8", "qmatmul_kmajor", "qmatmul_k4")
SHARED = ("TN", "KG", "THREADS", "BLOCKS_PER_SM", "TICKETS")


def _constants(text: str) -> dict[str, str]:
    return dict(re.findall(r"constexpr int (\w+) = ([^;]+);", text))


def test_header_constants_match_the_plans():
    c = _constants(HEADER.read_text())
    assert int(c["TN"]) == Q.I4G_TN
    assert int(c["BLOCKS_PER_SM"]) == Q.I4G_BLOCKS_PER_SM
    assert int(c["TICKETS"]) == Q.I4G_TICKETS
    # a chunk of the i8g and i8 kernels is KG warps of 16 rows
    assert int(c["KG"]) * 16 == Q.I8G_CHUNK


def test_kmajor_chunk_matches_its_plan():
    """k_major's chunk is KG warps of CH qs rows, the unit kmajor_plan cuts."""
    kg = int(_constants(HEADER.read_text())["KG"])
    c = _constants((cuda_build.CSRC / "qmatmul_kmajor.cu").read_text())
    assert c["CHUNK"] == "KG * CH"
    assert kg * int(c["CH"]) == Q.KMAJOR_CHUNK


def test_k4_chunk_matches_its_plan():
    """k4's chunk is KG warps of CH byte rows, the unit k4_plan cuts: one
    256-element pack group, two elements a byte."""
    kg = int(_constants(HEADER.read_text())["KG"])
    c = _constants((cuda_build.CSRC / "qmatmul_k4.cu").read_text())
    assert c["CHUNK"] == "KG * CH"
    assert kg * int(c["CH"]) == Q.K4_CHUNK
    assert 2 * Q.K4_CHUNK == Q.PACK_GROUP


@pytest.mark.parametrize("name", SPLIT_KERNELS)
def test_split_kernels_take_the_frame_from_the_header(name):
    text = (cuda_build.CSRC / f"{name}.cu").read_text()
    assert '#include "split_merge.cuh"' in text
    assert not set(_constants(text)) & set(SHARED)
    assert "split_merge::finish<MT>(" in text and "split_merge::launch<Args>(" in text
    assert "atomicAdd" not in text and "__threadfence" not in text


def test_a_header_edit_renames_every_library(tmp_path, monkeypatch):
    (tmp_path / "a.cu").write_text('#include "frame.cuh"\n')
    (tmp_path / "b.cu").write_text("int b;\n")
    (tmp_path / "frame.cuh").write_text("constexpr int X = 1;\n")
    monkeypatch.setattr(cuda_build, "CSRC", tmp_path)
    before = {n: cuda_build._lib_path(n) for n in ("a", "b")}
    assert cuda_build._lib_path("a") == before["a"]  # stable while nothing changes
    (tmp_path / "frame.cuh").write_text("constexpr int X = 2;\n")
    assert all(cuda_build._lib_path(n) != p for n, p in before.items())


def test_profile_reads_the_port_kernels_from_csrc():
    kernels = profile_decode.port_kernels()
    assert set(kernels.values()) == {p.stem for p in cuda_build.CSRC.glob("*.cu")}
    assert kernels["i8_kernel"] == "qmatmul_i8"
    assert kernels["split_kernel"] == "cell_attention"  # its __launch_bounds__ nests a call
    src = profile_decode.port_source
    assert src("void (anonymous namespace)::i8_kernel<1>((anonymous namespace)::Args)",
               kernels) == "qmatmul_i8"
    assert src("void (anonymous namespace)::split_kernel<16, 1>((anonymous namespace)::Args)",
               kernels) == "cell_attention"
    assert src("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float>>(...)",
               kernels) is None
