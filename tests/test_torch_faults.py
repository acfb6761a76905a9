"""Faults must surface: an error raised inside the draft chain ends the
controller's run (only a full KV cache skips a speculation), and a kernel
launch the CUDA runtime refuses raises without counting as a launch."""

import ctypes

import pytest
import torch

from pipeinfer_tpu_torch.models import load_model
from pipeinfer_tpu_torch.ops import cuda_build
from pipeinfer_tpu_torch.runtime.context import CacheFull, InferenceContext
from pipeinfer_tpu_torch.sampling.samplers import SamplingParams
from pipeinfer_tpu_torch.spec.controller import PipeInferController
from pipeinfer_tpu_torch.spec.params import SpecParams
from pipeinfer_tpu_torch.tools import testmodel

PROMPT = list(range(5, 25))


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_faults")
    testmodel.build_bench_pair(d / "t.gguf", d / "d.gguf", scale="nano", eps=0.5)
    return load_model(d / "t.gguf", device="cpu"), load_model(d / "d.gguf", device="cpu")


def _controller(pair):
    """A host-drafted controller whose drafts go through draft_chain: one
    branch, and a repetition penalty that is a no-op at the pair's margin
    keeps the fused and corrected paths off."""
    (tp, tc), (dp, dc) = pair
    sampling = SamplingParams(temp=0.0, penalty_repeat=1.0001, penalty_last_n=1)
    sp = SpecParams(n_draft=4, n_parallel=1, p_accept=0.0, max_inflight=3, min_inflight=2)
    c = PipeInferController(InferenceContext(tp, tc, n_cells=1024, device="cpu"),
                            InferenceContext(dp, dc, n_cells=1024, device="cpu"),
                            sampling, sp, eos_id=-1)
    assert not c.use_fused and not c.use_corrected
    return c


@pytest.fixture(scope="module")
def reference(pair):
    return _controller(pair).generate(list(PROMPT), 24, ignore_eos=True)


def test_draft_chain_error_ends_the_run(pair, monkeypatch):
    c = _controller(pair)

    def broken(*a, **kw):
        raise RuntimeError("CUDA kernel pi_kmajor_matmul failed to launch: cudaError 9")

    monkeypatch.setattr(c.dft, "draft_chain", broken)
    with pytest.raises(RuntimeError, match="cudaError 9"):
        c.generate(list(PROMPT), 24, ignore_eos=True)


def test_cache_full_in_the_draft_chain_skips_the_speculation(pair, reference, monkeypatch):
    c = _controller(pair)
    calls = []

    def full(*a, **kw):
        calls.append(a)
        raise CacheFull("KV cache full: need 5 cells, 0 free")

    monkeypatch.setattr(c.dft, "draft_chain", full)
    assert c.generate(list(PROMPT), 24, ignore_eos=True) == reference
    assert calls and c.stats.n_drafted == 0  # every speculation skipped, the stream intact


class _Counted:
    launches = 0


@pytest.mark.parametrize("err", [0, 9])
def test_launch_counts_only_launches_that_went_through(err, monkeypatch):
    """cuda_build.launch passes tensors as pointers, ints as ints and the
    stream last; a non-zero cudaError raises and leaves the count alone."""
    seen = []

    def entry(*args):
        seen.append(args)
        return err

    monkeypatch.setitem(cuda_build._fns, "fake:pi_fake", entry)
    monkeypatch.setattr(cuda_build, "_stream", lambda: 77)
    counted = _Counted()
    t = torch.zeros(4)
    if err:
        with pytest.raises(RuntimeError, match="cudaError 9"):
            cuda_build.launch("fake", "pi_fake", t, 3, count=counted)
    else:
        cuda_build.launch("fake", "pi_fake", t, 3, count=counted)
    assert counted.launches == (0 if err else 1)
    (args,) = seen
    assert args[0].value == t.data_ptr() and args[1] == 3
    assert isinstance(args[2], ctypes.c_void_p) and args[2].value == 77
