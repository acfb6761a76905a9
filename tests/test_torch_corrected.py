"""Device-corrected chaining in the port (spec/corrected.py):
tests/test_corrected.py's ten tests with their configs and seeds, on the
nano bench pair (eps 0.5) written by the port's tools/testmodel. Greedy
output equals plain decoding (the port's and the JAX package's) with zero
cancellations and zero cross-run dead work at any draft quality, and the
acceptance EMA tracks the true per-token acceptance.

The p_chain gate is consulted only while the oldest run is still in
flight. A CPU step is done when it returns (AsyncHandle.ready() is always
true there, where the JAX package's CPU dispatch is asynchronous), so
that test makes every run look in flight until fetched: the device-bound
regime the gate is for."""

import numpy as np
import pytest

from pipeinfer_tpu.models import load_model as j_load
from pipeinfer_tpu_torch.models import load_model
from pipeinfer_tpu_torch.runtime.context import AsyncHandle, Batch, CacheFull
from pipeinfer_tpu_torch.sampling.samplers import SamplingParams
from pipeinfer_tpu_torch.spec.controller import PipeInferController
from pipeinfer_tpu_torch.spec.params import SpecParams
from pipeinfer_tpu_torch.tools import testmodel

from .test_torch_sync_spec import Model, plain_both, tctx

GREEDY = SamplingParams(temp=0.0, penalty_repeat=1.0, penalty_last_n=0)
GREEDY_KW = dict(temp=0.0, penalty_repeat=1.0, penalty_last_n=0)
PROMPT = list(range(5, 25))
N = 96


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    d = tmp_path_factory.mktemp("tcorr")
    testmodel.build_bench_pair(d / "t.gguf", d / "d.gguf", scale="nano", eps=0.5)
    return tuple(Model(str(d / f), load_model(d / f, device="cpu"), j_load(d / f))
                 for f in ("t.gguf", "d.gguf"))


def _ctx(m, n_cells=1024):
    return tctx(m, n_cells)


@pytest.fixture(scope="module")
def want(pair):
    return plain_both(pair[0], PROMPT, N, GREEDY_KW, n_cells=1024)


def _true_accept(tgt, dft, stream):
    """Teacher-forced over the committed stream: how often the draft's
    argmax agrees with the target's."""
    rows = []
    for m in (tgt, dft):
        b = Batch()
        for i, t in enumerate(stream):
            b.add(t, i, 0, want_logits=True)
        rows.append(np.argmax(_ctx(m).decode(b), axis=-1))
    return float(np.mean(rows[0] == rows[1]))


SP = dict(n_draft=8, n_parallel=1, p_accept=0.0, max_inflight=4, min_inflight=2)


@pytest.fixture(scope="module")
def corrected_run(pair):
    """(controller, stream) of one corrected greedy run: the JAX file runs
    this same generation in three tests, which here read one run."""
    tgt, dft = pair
    c = PipeInferController(_ctx(tgt), _ctx(dft), GREEDY, SpecParams(**SP), eos_id=-1)
    assert c.use_corrected, "corrected mode should engage for this config"
    return c, c.generate(list(PROMPT), N, ignore_eos=True)


def test_corrected_greedy_exact_and_no_dead_work(corrected_run, want):
    c, got = corrected_run
    assert got == want, "corrected chaining diverged from plain greedy"
    assert c.metrics.n_canceled_runs == 0
    assert c.metrics.n_dead_tokens == 0
    assert not c.runs
    assert len(c.free_offsets) == c.sp.max_inflight


def test_corrected_depth_ladder_engages(corrected_run):
    c, _ = corrected_run
    assert len(c.depth_counts) >= 2, f"ladder never engaged: {c.depth_counts}"
    assert min(c.depth_counts) < 8, f"never left the top rung: {c.depth_counts}"


def test_accept_ema_tracks_true_acceptance(pair, corrected_run):
    tgt, dft = pair
    c, out = corrected_run
    truth = _true_accept(tgt, dft, PROMPT + out)
    assert truth < 0.85, f"pair not divergent enough to test ({truth})"
    assert abs(c.accept_ema - truth) <= 0.1, (
        f"EMA {c.accept_ema:.3f} vs true per-token acceptance {truth:.3f}")


def test_accept_ema_tracks_true_acceptance_host_path(pair, want):
    tgt, dft = pair
    sp = SpecParams(**SP, device_verify=False)
    c = PipeInferController(_ctx(tgt), _ctx(dft), GREEDY, sp, eos_id=-1)
    assert not c.use_corrected and c.use_fused
    out = c.generate(list(PROMPT), N, ignore_eos=True)
    assert out == want  # host path exactness unchanged
    truth = _true_accept(tgt, dft, PROMPT + out)
    assert abs(c.accept_ema - truth) <= 0.12, (
        f"host-path EMA {c.accept_ema:.3f} vs true {truth:.3f}")


def test_ema_unit_convergence_bernoulli():
    """Run-shaped evidence from a Bernoulli(0.5) acceptance process: the
    EMA converges to 0.5."""
    sp = SpecParams(ema_decay=0.96)
    ctrl = type("C", (), {"sp": sp, "accept_ema": 1.0, "_ema_version": 0})()
    update = PipeInferController._update_accept_ema
    rng = np.random.default_rng(0)
    depth, trace = 8, []
    for _ in range(600):
        m = 0
        while m < depth and rng.random() < 0.5:
            m += 1
        update(ctrl, m, m + (1 if m < depth else 0))
        trace.append(ctrl.accept_ema)
    assert abs(float(np.mean(trace[200:])) - 0.5) <= 0.05, np.mean(trace[200:])
    assert abs(ctrl.accept_ema - 0.5) <= 0.1, ctrl.accept_ema


def test_corrected_stochastic_seeded_reproducible(pair):
    tgt, dft = pair
    stoch = SamplingParams(temp=0.9, top_k=40, penalty_repeat=1.0, penalty_last_n=0, seed=13)
    sp = SpecParams(n_draft=6, n_parallel=1, p_accept=0.0, max_inflight=3, min_inflight=2)

    def run():
        c = PipeInferController(_ctx(tgt), _ctx(dft), stoch, sp, eos_id=-1)
        assert c.use_corrected
        return c.generate(list(PROMPT), 40, ignore_eos=True)

    a, b = run(), run()
    assert a == b
    assert len(a) == 40


def test_corrected_eos_stops(pair, want):
    tgt, dft = pair
    eos = want[20]
    first = want.index(eos)
    c = PipeInferController(_ctx(tgt), _ctx(dft), GREEDY, SpecParams(**SP), eos_id=eos)
    got = c.generate(list(PROMPT), 64)
    assert got == want[: first + 1]


def test_corrected_no_cell_leaks(pair):
    tgt, dft = pair
    tctx_, dctx_ = _ctx(tgt), _ctx(dft)
    free0 = tctx_.n_free_cells
    c = PipeInferController(tctx_, dctx_, GREEDY, SpecParams(**SP), eos_id=-1)
    out1 = c.generate(list(PROMPT), N, ignore_eos=True)
    live = len(PROMPT) + len(out1)
    assert free0 - live <= tctx_.n_free_cells <= free0 - live + 1
    tctx_.seq_rm(0, 0, -1)
    dctx_.seq_rm(0, 0, -1)
    assert tctx_.n_free_cells == free0
    c2 = PipeInferController(tctx_, dctx_, GREEDY, SpecParams(**SP), eos_id=-1)
    assert c2.generate(list(PROMPT), N, ignore_eos=True) == out1


def test_p_chain_gate_cuts_dead_work(pair, want, monkeypatch):
    """On the assume-chained host-verified path with a ~50%-divergent
    draft, a high p_chain refuses chained runs whose assumed prefix is
    doomed: less dead work and no more cancellations, output exact. Runs
    look in flight until fetched (see the module docstring)."""
    tgt, dft = pair
    monkeypatch.setattr(AsyncHandle, "ready", lambda self: False)
    dead, canceled = {}, {}
    for pc in (0.0, 0.9):
        sp = SpecParams(n_draft=4, n_parallel=1, p_accept=0.0, p_split=0.9, max_inflight=4,
                        adapt_depth=False, device_verify=False, p_chain=pc)
        c = PipeInferController(_ctx(tgt, 4096), _ctx(dft, 4096), GREEDY, sp, eos_id=-1)
        out = c.generate(list(PROMPT), N)
        assert out == want, f"p_chain={pc} broke greedy exactness"
        dead[pc] = c.metrics.dead_work_frac
        canceled[pc] = c.metrics.n_canceled_runs
    assert dead[0.9] < dead[0.0], (dead, canceled)
    assert canceled[0.9] <= canceled[0.0], (dead, canceled)


def test_corrected_stall_surfaces_cachefull(pair, monkeypatch):
    """An empty pipeline that cannot relaunch must surface CacheFull from
    tick(), not read as done and silently truncate the generation."""
    tgt, dft = pair
    sp = SpecParams(n_draft=4, n_parallel=1, max_inflight=2, adapt_depth=False)
    c = PipeInferController(_ctx(tgt), _ctx(dft), GREEDY, sp, eos_id=-1)
    assert c.use_corrected
    c.start_generation(list(PROMPT), N, ignore_eos=True)
    monkeypatch.setattr(c, "_launch_corrected", lambda: False)
    with pytest.raises(CacheFull):
        for _ in range(64):
            c.tick(block=True)
            assert not c.done or len(c.generated) >= N, \
                "controller read as done before the budget (silent truncation)"
