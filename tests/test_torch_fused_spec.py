"""Fused one-dispatch speculative runs in the port (spec/fused.py):
tests/test_fused_spec.py's eight tests with their configs and seeds.
Golden equivalence with plain greedy decoding (the port's and the JAX
package's, on the same file) with a perfect draft (the target itself) and
a divergent one (another random model: cancellation, deferred chain
resolution, reseeding), the stochastic fused path and the
acceptance-adaptive depth ladder."""

import numpy as np
import pytest

from pipeinfer_tpu_torch.sampling.samplers import SamplingParams
from pipeinfer_tpu_torch.spec.controller import PipeInferController
from pipeinfer_tpu_torch.spec.params import SpecParams

from .test_torch_sync_spec import build, plain_both, tctx

GREEDY = SamplingParams(temp=0.0, penalty_repeat=1.0, penalty_last_n=0)
GREEDY_KW = dict(temp=0.0, penalty_repeat=1.0, penalty_last_n=0)
PROMPT = [3, 17, 42]
N = 40


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    d = tmp_path_factory.mktemp("tfused")
    return (build(d / "t.gguf", seed=5, n_layers=2, n_embd=128, n_heads=4, n_kv_heads=2,
                  n_ff=256, n_vocab=512),
            build(d / "d.gguf", seed=9, n_layers=1, n_embd=64, n_heads=2, n_kv_heads=2,
                  n_ff=128, n_vocab=512))


def _ctx(m):
    return tctx(m, 256)


@pytest.fixture(scope="module")
def ref(models):
    return plain_both(models[0], PROMPT, N, GREEDY_KW, n_cells=256)


def test_fused_controller_selected(models):
    tgt, dft = models
    c = PipeInferController(_ctx(tgt), _ctx(dft), GREEDY,
                            SpecParams(n_draft=6, n_parallel=1, device_verify=False), eos_id=-1)
    assert c.use_fused
    # penalties force the host drafting path
    c2 = PipeInferController(_ctx(tgt), _ctx(dft), SamplingParams(temp=0.0),
                             SpecParams(n_draft=6, n_parallel=1, device_verify=False), eos_id=-1)
    assert not c2.use_fused


def test_fused_token_exact_perfect_draft(models, ref):
    tgt, _ = models
    sp = SpecParams(n_draft=6, n_parallel=1, p_accept=0.0, p_split=0.9, max_inflight=3,
                    device_verify=False)
    c = PipeInferController(_ctx(tgt), _ctx(tgt), GREEDY, sp, eos_id=-1)
    assert c.use_fused
    assert c.generate(list(PROMPT), N) == ref
    assert c.stats.n_accept > 0


def test_fused_token_exact_divergent_draft(models, ref):
    tgt, dft = models
    sp = SpecParams(n_draft=4, n_parallel=1, p_accept=0.0, p_split=0.9, max_inflight=3,
                    device_verify=False)
    c = PipeInferController(_ctx(tgt), _ctx(dft), GREEDY, sp, eos_id=-1)
    assert c.use_fused
    assert c.generate(list(PROMPT), N) == ref
    assert c.metrics.n_canceled_runs > 0 or c.stats.accept_rate < 0.9


STOCH = SamplingParams(temp=0.8, penalty_repeat=1.0, penalty_last_n=0, seed=42)


def test_fused_stochastic_selected_and_reproducible(models):
    """temp > 0 keeps the fused path (device Gumbel drafting); seeded
    generations repeat across fresh engines."""
    tm, dm = models

    def run():
        c = PipeInferController(
            _ctx(tm), _ctx(dm), STOCH,
            SpecParams(n_draft=4, n_parallel=1, p_accept=0.0, max_inflight=3,
                       device_verify=False), eos_id=-1)
        assert c.use_fused
        return c.generate([3, 17, 42], 12)

    a, b = run(), run()
    assert a == b, f"seeded stochastic fused runs diverge: {a} vs {b}"
    assert len(a) == 12


def test_fused_stochastic_top1_matches_greedy(models, ref):
    """top_k = 1 collapses the chain to argmax: the fused stochastic run
    equals plain greedy decoding."""
    tm, dm = models
    c = PipeInferController(
        _ctx(tm), _ctx(dm),
        SamplingParams(temp=0.7, top_k=1, penalty_repeat=1.0, penalty_last_n=0, seed=1),
        SpecParams(n_draft=4, n_parallel=1, p_accept=0.0, max_inflight=3, device_verify=False),
        eos_id=-1)
    assert c.use_fused
    assert c.generate([3, 17, 42], 12) == ref[:12]


def test_depth_ladder_and_pick():
    sp = SpecParams(n_draft=8)
    assert sp.ladder() == (2, 4, 8)
    assert SpecParams(n_draft=32).ladder() == (4, 8, 16, 32)
    assert SpecParams(n_draft=8, adapt_depth=False).ladder() == (8,)
    assert sp.pick_depth(1.0) == 8
    assert sp.pick_depth(0.1) == 2
    prev = 0
    for a in np.linspace(0.05, 0.999, 40):
        d = sp.pick_depth(float(a))
        assert d >= prev, f"pick_depth not monotone at a={a}: {d} < {prev}"
        prev = d


def test_adaptive_depth_token_exact_across_transitions(models, ref):
    tgt, dft = models
    sp = SpecParams(n_draft=8, n_parallel=1, p_accept=0.0, max_inflight=3, device_verify=False)
    c = PipeInferController(_ctx(tgt), _ctx(dft), GREEDY, sp, eos_id=-1)
    assert c.use_fused
    assert c.generate(list(PROMPT), N) == ref
    assert len(c.depth_counts) >= 2, f"divergent draft should cross depth rungs: {c.depth_counts}"
    assert c.accept_ema < 0.9


def test_adaptive_depth_perfect_draft_stays_deep(models, ref):
    tgt, _ = models
    sp = SpecParams(n_draft=8, n_parallel=1, p_accept=0.0, max_inflight=3, device_verify=False)
    c = PipeInferController(_ctx(tgt), _ctx(tgt), GREEDY, sp, eos_id=-1)
    assert c.generate(list(PROMPT), N) == ref
    assert set(c.depth_counts) == {8}, c.depth_counts
