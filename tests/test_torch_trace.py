"""The port's in-program tracer (utils/trace.py) and the serving engine's
spans and stamps, on the CPU.

Spans nest under the span open on their thread; one request's spans and
stamps share its id; the buffer keeps the newest spans; with tracing off
a served request reads no clock and makes no CUDA event; the lane-round
counts the spans carry add up; device spans read an event only once it
has completed;
and the engine thread runs on while a profiler starts and stops on
another thread.
"""

import threading

import pytest
import torch

from pipeinfer_tpu_torch.models import load_model
from pipeinfer_tpu_torch.runtime.context import InferenceContext
from pipeinfer_tpu_torch.sampling.samplers import SamplingParams
from pipeinfer_tpu_torch.serving.batching import Request, SpecBatchScheduler
from pipeinfer_tpu_torch.spec.device_multi import DeviceLoopServer
from pipeinfer_tpu_torch.spec.params import SpecParams
from pipeinfer_tpu_torch.tools import testmodel
from pipeinfer_tpu_torch.utils import trace

torch.set_num_threads(1)  # several test processes share the machine (test_torch_cli.py)

GREEDY = dict(temp=0.0, penalty_repeat=1.0, penalty_last_n=0)
PENALTY = dict(temp=0.0, penalty_repeat=1.3, penalty_last_n=64)
STAMPS = ("submit", "admit")

# the span each span opens under (None: none), as the engine nests them
PARENTS = {
    "engine.step": {None}, "engine.idle": {None},
    "engine.drain": {"engine.step", None}, "engine.host": {"engine.step"},
    "lanes.collect": {"engine.step"}, "lanes.collect.wait": {"lanes.collect"},
    "lanes.commit": {"lanes.collect"}, "lanes.retire": {"engine.step", "lanes.admit"},
    "lanes.admit": {"engine.step"}, "lanes.admit.plan": {"lanes.admit"},
    "lanes.admit.enqueue": {"lanes.admit"}, "lanes.admit.wait": {"lanes.admit"},
    "lanes.dispatch": {"engine.step"}, "lanes.dispatch.cells": {"lanes.dispatch"},
    "lanes.dispatch.enqueue": {"lanes.dispatch"}, "lanes.round": {"lanes.dispatch.enqueue"},
}


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_trace")
    testmodel.build_tiny_llama(d / "t.gguf", seed=5, n_layers=2, n_embd=128, n_heads=4,
                               n_kv_heads=2, n_ff=256, n_vocab=512)
    testmodel.build_tiny_llama(d / "d.gguf", seed=9, n_layers=1, n_embd=64, n_heads=2,
                               n_kv_heads=2, n_ff=128, n_vocab=512)
    return {k: load_model(d / f"{k}.gguf", device="cpu") for k in ("t", "d")}


@pytest.fixture(autouse=True)
def tracer_off():
    """Every test starts and ends with tracing off."""
    trace.disable()
    yield
    trace.disable()


def ctx(m, n_cells=2048):
    return InferenceContext(*m, n_cells=n_cells, cache_dtype=torch.float32, device="cpu")


def scheduler(models, **kw):
    return SpecBatchScheduler(ctx(models["t"]), ctx(models["d"]), spec_params=SpecParams(n_draft=3),
                              max_slots=2, eos_id=-1, device_lanes=2, device_rounds=2, **kw)


def request(prompt, n, sampling=GREEDY):
    return Request(prompt_ids=list(prompt), n_predict=n, sampling=SamplingParams(**sampling),
                   ignore_eos=True)


def by_id(spans):
    return {s[3]: s for s in spans}


def check_well_formed(spans):
    """Every span ends after it starts, lies inside its parent, and has
    the parent its name calls for."""
    ids = by_id(spans)
    assert len(ids) == len(spans)
    for name, t0, t1, sid, parent, rid, args in spans:
        assert t0 <= t1, name
        assert isinstance(args, tuple)
        if parent == 0:
            assert None in PARENTS[name], name
            continue
        p = ids[parent]
        assert p[1] <= t0 and t1 <= p[2], (name, p[0])
        assert p[0] in PARENTS[name], (name, p[0])


def test_spans_nest_under_their_parents(models):
    """Device-lane and host-engine requests served with tracing on: every
    span of the fixed set appears and nests as the engine calls it."""
    sched = scheduler(models)
    reqs = [request(range(5, 17), 12), request([3, 1, 4, 1, 5], 9),
            request(range(40, 48), 6, PENALTY)]
    trace.enable()
    for r in reqs:
        sched.submit(r)
    sched.run_until_idle()
    trace.disable()
    assert all(r.done and r.error is None for r in reqs)
    assert sched.n_device_served == 2 and sched.n_host_served == 1
    snap = trace.snapshot()
    spans = snap["spans"]
    check_well_formed(spans)
    names = {s[0] for s in spans}
    assert names >= set(PARENTS) - {"engine.idle"}
    assert snap["device_spans"] == [] and snap["anchors"] is None  # no CUDA device
    assert snap["counters"] == dict(spans_dropped=0, stamps_dropped=0, device_spans_skipped=0,
                                    errors=0)
    rounds = [s for s in spans if s[0] == "lanes.round"]
    dispatches = [s for s in spans if s[0] == "lanes.dispatch"]
    assert len(rounds) == 2 * len(dispatches)
    for r in reqs:  # the host engine's request is stamped like a lane's
        st = snap["stamps"][r.rid]
        assert set(st) == set(STAMPS)
        assert [st[k] for k in STAMPS] == sorted(st[k] for k in STAMPS)


def test_one_requests_spans_and_stamps_share_its_rid(models):
    sched = scheduler(models)
    first = request(range(5, 17), 4)
    sched.submit(first)
    sched.run_until_idle()  # untraced: gives the next request another id
    req = request([3, 1, 4, 1, 5], 10)
    trace.enable()
    sched.submit(req)
    sched.run_until_idle()
    trace.disable()
    snap = trace.snapshot()
    assert req.rid != first.rid and list(snap["stamps"]) == [req.rid]
    admits = [s for s in snap["spans"] if s[0] == "lanes.admit" and s[6]]
    assert len(admits) == 1
    name, t0, t1, sid, parent, rid, args = admits[0]
    assert rid == req.rid
    assert dict(args) == {"rids": (req.rid,), "prompt_lens": (5,)}
    st = snap["stamps"][req.rid]
    assert st["admit"] == t0  # the start of the lanes.admit that took it
    assert st["submit"] <= t0
    assert len(req.generated) == 10


def test_buffer_keeps_the_newest_spans(monkeypatch):
    monkeypatch.setattr(trace, "CAP", 8)
    trace.enable()
    for i in range(20):
        with trace.span("engine.step", args=(("i", i),)):
            pass
    trace.disable()
    snap = trace.snapshot()
    assert [dict(s[6])["i"] for s in snap["spans"]] == list(range(12, 20))
    assert snap["counters"]["spans_dropped"] == 12


def test_tracing_off_reads_no_clock_and_makes_no_event(models, monkeypatch):
    """Tracing off: a served request records nothing; the tracer's clock
    and the CUDA event constructor are never called."""
    calls = []

    def clock():
        calls.append("clock")
        return 0

    class Event:
        def __init__(self, *a, **k):
            calls.append("event")

    trace.enable()
    trace.disable()  # an empty session, so that a stray record would show
    monkeypatch.setattr(trace, "clock", clock)
    monkeypatch.setattr(torch.cuda, "Event", Event)
    sched = scheduler(models)
    reqs = [request(range(5, 17), 8), request(range(40, 48), 5, PENALTY)]
    for r in reqs:
        sched.submit(r)
    sched.run_until_idle()
    assert all(r.done and r.error is None for r in reqs)
    assert calls == []
    snap = trace.snapshot()
    assert snap["spans"] == [] and snap["stamps"] == {}


def test_a_tracer_fault_never_reaches_the_engine(models, monkeypatch):
    def clock():
        raise OSError("clock failed")

    sched = scheduler(models)
    req = request(range(5, 17), 8)
    trace.enable()
    monkeypatch.setattr(trace, "clock", clock)
    sched.submit(req)
    sched.run_until_idle()
    trace.disable()
    assert req.done and req.error is None and len(req.generated) == 8
    assert trace.snapshot()["counters"]["errors"] > 0


def test_lane_round_counts_add_up(models):
    """The lane-round counts a 3-lane server's spans carry: every dispatch
    runs S x R lane rounds, the active lanes' part of them live, each of
    them one of a request's SpecStats rounds; the commits carry the rounds
    thrown away for retiring lanes."""
    srv = DeviceLoopServer(ctx(models["t"]), ctx(models["d"]), SamplingParams(**GREEDY),
                           SpecParams(n_draft=3), n_lanes=3, seq_base=60, eos_id=-1, rounds=2)
    prompts = [list(range(5, 17)), [3, 1, 4, 1, 5], list(range(40, 48)), [9] * 7]
    budgets = [12, 30, 5, 9]
    trace.enable()
    hs = [srv.submit(p, n, rid=i) for i, (p, n) in enumerate(zip(prompts, budgets))]
    srv.run_until_idle()
    trace.disable()
    assert all(h.done and h.error is None for h in hs)
    assert [len(h.tokens) for h in hs] == budgets
    spans = trace.snapshot()["spans"]
    disp = [dict(s[6]) for s in spans if s[0] == "lanes.dispatch"]
    commits = [dict(s[6]) for s in spans if s[0] == "lanes.commit"]
    assert disp and len(commits) == len(disp)  # one commit per dispatch's pack
    assert all(a["lane_rounds"] == 3 * 2 for a in disp)
    assert all(0 < a["live_lane_rounds"] <= a["lane_rounds"] for a in disp)
    assert all(len(a["bases"]) * 2 == a["live_lane_rounds"] for a in disp)
    live = sum(a["live_lane_rounds"] for a in disp)
    retiring = sum(a["retiring_lane_rounds"] for a in commits)
    assert live == sum(h.stats.n_rounds for h in hs)
    assert retiring * 3 == sum(h.stats.n_drafted_unverified for h in hs)
    assert retiring <= live
    admits = [dict(s[6]) for s in spans if s[0] == "lanes.admit" and s[6]]
    assert 2 <= len(admits) <= 4
    assert sorted(r for a in admits for r in a["rids"]) == [0, 1, 2, 3]
    assert sum(sum(a["prompt_lens"]) for a in admits) == sum(map(len, prompts))


class FakeEvent:
    """A timing event on a fake device clock (ms), which completes when
    the test says so; elapsed_time on one not completed fails as CUDA's
    does."""

    now = 0.0

    def __init__(self):
        self.t, self.done = None, True

    def record(self):
        self.t, self.done = FakeEvent.now, False

    def query(self):
        return self.done

    def elapsed_time(self, other):
        if not (self.done and other.done):
            raise RuntimeError("event not ready")
        return other.t - self.t


def fake_session(n_events, h0=10_000_000):
    """A session as enable() makes one on a card, on fake events."""
    trace.enable()
    st = trace._st
    FakeEvent.now = 0.0
    a = FakeEvent()
    a.record()
    a.done = True
    st.anchor0 = (a, h0)
    st.pool = [FakeEvent() for _ in range(n_events)]
    return st


def test_device_spans_wait_for_completion_and_place_on_the_host_clock():
    st = fake_session(4)
    with trace.span("lanes.dispatch.enqueue") as host:
        FakeEvent.now = 2.0
        with trace.dev("dev.dispatch"):
            FakeEvent.now = 5.0
        with trace.dev("dev.dispatch"):
            pass
        with trace.dev("dev.dispatch"):  # the pool is empty: skipped
            pass
    first, second = st.pending
    assert st.counters["device_spans_skipped"] == 1
    second.ev[0].done = second.ev[1].done = True  # the second completed, the first has not
    first.ev[0].done = True
    trace.resolve_ready()  # reads only the completed pair, waits on neither
    assert st.pending == [first] and len(st.pool) == 2
    assert st.device_spans == [("dev.dispatch", 5.0, 5.0, host.sid)]
    first.ev[1].done = True
    trace.resolve_ready()
    assert st.pending == [] and len(st.pool) == 4
    assert st.device_spans[1] == ("dev.dispatch", 2.0, 5.0, host.sid)
    with trace.dev("dev.dispatch"):  # left pending: disable() reads it
        FakeEvent.now = 7.0
    for ev in st.pending[0].ev:
        ev.done = True
    # the second anchor: the device ran 1000 ms while the host clock ran
    # 1000.5 ms, so device times stretch by that ratio from the first
    b = FakeEvent()
    FakeEvent.now = 1000.0
    b.record()
    b.done = True
    st.anchor1 = (b, 10_000_000 + 1_000_500_000)
    trace.disable()
    snap = trace.snapshot()
    assert snap["anchors"]["drift_ns"] == pytest.approx(500_000)
    (_, t0, t1, _), (_, t2, t3, _), (_, t4, t5, _) = snap["device_spans"]
    assert t0 == t1 == t3 == t4 == 10_000_000 + round(5.0e6 * 1.0005)
    assert t2 == 10_000_000 + round(2.0e6 * 1.0005)
    assert t5 == 10_000_000 + round(7.0e6 * 1.0005)
    assert st.pending == [] and len(st.pool) == 4


def test_engine_runs_on_while_a_profiler_starts_and_stops(models):
    """serve_forever on its thread with tracing on while the benchmark's
    profiler (portbench.trace.Tracer; CPU activity here) is started and
    stopped three times on this thread: every request completes and the
    spans are well formed."""
    from portbench.trace import Tracer

    sched = scheduler(models)
    reqs = [request(range(5 + i, 17 + i), 16 + 2 * i) for i in range(5)]
    reqs.append(request(range(40, 48), 8, PENALTY))
    trace.enable()
    stop = threading.Event()
    eng = threading.Thread(target=sched.serve_forever, args=(stop,), daemon=True)
    eng.start()
    try:
        for r in reqs:
            sched.submit(r)
        for _ in range(3):
            prof = Tracer()
            prof.prepare()
            prof.start()
            torch.ones(64).add_(1)
            prof.stop()
        for r in reqs:
            assert r.done_event.wait(120)
    finally:
        stop.set()
        eng.join(timeout=60)
    assert not eng.is_alive()
    trace.disable()
    assert all(r.done and r.error is None and len(r.generated) == r.n_predict for r in reqs)
    snap = trace.snapshot()
    check_well_formed(snap["spans"])
    assert snap["counters"]["errors"] == 0
    assert all(set(snap["stamps"][r.rid]) == set(STAMPS) for r in reqs)

