"""The port's async PipeInfer controller: tests/test_async_spec.py's six
tests with their configs and seeds. Golden-token equivalence with plain
decoding (the port's and the JAX package's, on the same file), plus the
state-machine invariants (offsets recycled). The stochastic test holds
the seeded stream to plain sampled decoding token for token: every
position is sampled once, in order, from the one numpy generator."""

import pytest

from pipeinfer_tpu_torch.sampling.samplers import SamplingParams
from pipeinfer_tpu_torch.spec.controller import PipeInferController
from pipeinfer_tpu_torch.spec.params import SpecParams

from .test_torch_sync_spec import CFG, N_PREDICT, PROMPT, build, plain_both, tctx


@pytest.fixture(scope="module")
def target(tmp_path_factory):
    return build(tmp_path_factory.mktemp("taspec") / "tgt.gguf", seed=7, **CFG)


@pytest.fixture(scope="module")
def want(target):
    return plain_both(target)


def _run_controller(target_model, draft_model, sp, sampling=None):
    c = PipeInferController(tctx(target_model, 256), tctx(draft_model, 256),
                            sampling or SamplingParams(temp=0.0), sp, eos_id=-1)
    out = c.generate(list(PROMPT), N_PREDICT)
    assert not c.runs
    assert len(c.free_offsets) == sp.max_inflight, "leaked sequence offsets"
    return out, c


def test_async_self_draft_equivalence(target, want):
    got, c = _run_controller(
        target, target, SpecParams(n_draft=4, n_parallel=2, p_accept=0.0, max_inflight=3))
    assert got == want, f"async spec diverges: {got} vs {want}"
    assert c.stats.n_drafted > 0
    assert c.stats.n_accept > 0


def test_async_bad_draft_exact(target, want, tmp_path):
    bad = build(tmp_path / "bad.gguf", seed=1234, **CFG)
    got, _ = _run_controller(
        target, bad, SpecParams(n_draft=4, n_parallel=2, p_accept=0.0, max_inflight=3))
    assert got == want, f"async spec with bad draft diverges: {got} vs {want}"


def test_async_single_inflight(target, want):
    got, _ = _run_controller(
        target, target, SpecParams(n_draft=3, n_parallel=1, p_accept=0.0, max_inflight=1))
    assert got == want


def test_async_deep_inflight_with_splits(target, want):
    got, c = _run_controller(
        target, target,
        SpecParams(n_draft=6, n_parallel=3, p_accept=0.0, p_split=0.05, max_inflight=4))
    assert got == want
    assert c.metrics.n_runs > c.stats.n_rounds - 2


def test_async_throttle_disables_speculation(target, want):
    """p_accept >= 1 means pure non-spec decoding through the async path."""
    got, c = _run_controller(
        target, target, SpecParams(n_draft=4, n_parallel=2, p_accept=1.0, max_inflight=2))
    assert got == want
    assert c.stats.n_drafted == 0


def test_async_stochastic_sampling_exact(target):
    """temp 0.9, top_k 20, seed 1234 (the default penalties on): the same
    stream as plain sampled decoding, the port's and the JAX package's."""
    kw = dict(temp=0.9, top_k=20, seed=1234)
    want = plain_both(target, sampling_kw=kw, accept_prompt=True, n_cells=256)
    got, _ = _run_controller(
        target, target, SpecParams(n_draft=4, n_parallel=1, p_accept=0.0, max_inflight=3),
        sampling=SamplingParams(**kw))
    assert got == want, f"stochastic spec diverges: {got} vs {want}"
