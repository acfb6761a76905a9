"""Speculation x continuous batching in the port: tests/test_multi_spec.py's
four tests with their configs and seeds. Concurrent PipeInfer streams over
one shared target/draft context pair each emit exactly the tokens of
plain decoding (the port's and the JAX package's, on the same file), with
slot reclamation, hot-join, seeded stochastic streams and a staged target."""

import pytest

from pipeinfer_tpu_torch.parallel.stages import StagedInferenceContext
from pipeinfer_tpu_torch.sampling.samplers import SamplingParams
from pipeinfer_tpu_torch.spec.multi import MultiPipeInfer
from pipeinfer_tpu_torch.spec.params import SpecParams

from .test_torch_sync_spec import CFG, N_PREDICT, PROMPT, build, plain_both, tctx

PROMPTS = [list(PROMPT), [3, 14, 15, 9, 2], [31, 4, 1, 5, 9, 26]]


@pytest.fixture(scope="module")
def target(tmp_path_factory):
    return build(tmp_path_factory.mktemp("tmspec") / "tgt.gguf", seed=7, **CFG)


def _plain(target, prompt, sampling_kw=None):
    """Plain decoding with the controller's sampling chain (the prompt in
    the penalty window, as start_generation puts it)."""
    return plain_both(target, prompt, N_PREDICT, sampling_kw or dict(temp=0.0),
                      accept_prompt=True, n_cells=256)


def test_multi_streams_each_exact(target):
    want = [_plain(target, p) for p in PROMPTS]
    ctx_t, ctx_d = tctx(target, 512), tctx(target, 512)
    sp = SpecParams(n_draft=4, n_parallel=1, p_accept=0.0, max_inflight=2)
    eng = MultiPipeInfer(ctx_t, ctx_d, SamplingParams(temp=0.0), sp, eos_id=-1)
    reqs = [eng.submit(p, N_PREDICT) for p in PROMPTS]
    eng.run_until_idle()
    for r, w in zip(reqs, want):
        assert r.done
        assert r.tokens == w, f"stream {r.id} diverges: {r.tokens} vs {w}"
    assert len(eng.free_bases) == eng.max_streams
    assert not eng.active and not eng.pending
    assert (ctx_t.h_pos[: ctx_t.trash_cell] < 0).all(), "leaked target cells"
    assert (ctx_d.h_pos[: ctx_d.trash_cell] < 0).all(), "leaked draft cells"


def test_multi_hot_join_and_overcommit(target):
    """More requests than stream slots: later requests queue, join as
    earlier streams finish, and still decode exactly."""
    prompts = PROMPTS + [[9, 9, 2, 7], [1, 2, 3, 4, 5]]
    want = [_plain(target, p) for p in prompts]
    sp = SpecParams(n_draft=4, n_parallel=2, p_accept=0.0, max_inflight=2)
    eng = MultiPipeInfer(tctx(target, 512), tctx(target, 512), SamplingParams(temp=0.0), sp,
                         eos_id=-1, max_streams=2)
    assert eng.max_streams == 2
    reqs = [eng.submit(p, N_PREDICT) for p in prompts[:3]]
    for _ in range(4):
        eng.step()
    reqs += [eng.submit(p, N_PREDICT) for p in prompts[3:]]
    eng.run_until_idle()
    for r, w in zip(reqs, want):
        assert r.done and r.tokens == w, f"stream {r.id}: {r.tokens} vs {w}"
    assert len(eng.free_bases) == eng.max_streams


def test_multi_stochastic_streams_independent(target):
    """Seeded stochastic sampling per stream: each stream's rng is its own
    controller's, so concurrency perturbs no stream's tokens."""
    kw = dict(temp=0.9, top_k=20, seed=77)
    want = [_plain(target, p, kw) for p in PROMPTS[:2]]
    sp = SpecParams(n_draft=4, n_parallel=1, p_accept=0.0, max_inflight=2)
    eng = MultiPipeInfer(tctx(target, 512), tctx(target, 512), SamplingParams(**kw), sp,
                         eos_id=-1)
    reqs = [eng.submit(p, N_PREDICT) for p in PROMPTS[:2]]
    eng.run_until_idle()
    for r, w in zip(reqs, want):
        assert r.tokens == w, f"stream {r.id} diverges: {r.tokens} vs {w}"


def test_multi_streams_over_staged_target(target):
    """Concurrent speculative streams over a 2-stage target: stages x
    streams x speculation at once, still token-exact."""
    want = [_plain(target, p) for p in PROMPTS[:2]]
    ctx_t = StagedInferenceContext(*target.port, n_cells=512, devices=["cpu"] * 2)
    sp = SpecParams(n_draft=4, n_parallel=1, p_accept=0.0, max_inflight=2)
    eng = MultiPipeInfer(ctx_t, tctx(target, 512), SamplingParams(temp=0.0), sp, eos_id=-1)
    reqs = [eng.submit(p, N_PREDICT) for p in PROMPTS[:2]]
    eng.run_until_idle()
    for r, w in zip(reqs, want):
        assert r.done and r.tokens == w, f"staged stream {r.id}: {r.tokens} vs {w}"
