"""The metric arithmetic on hand-made inputs."""

from types import SimpleNamespace

import numpy as np

import pytest

from portbench import roofline as rl
from portbench.cell import load_metric
from portbench.run import RunData, end_to_end
from portbench.trace import Kernels, label_gaps


def _timed(due, stamps, done=True):
    return SimpleNamespace(due=due, stamps=stamps, req=SimpleNamespace(done=done, error=None),
                           planned=SimpleNamespace(prompt=[0] * 10))


def test_tails_count_every_request_and_stalls():
    t_open, t_close = 10.0, 20.0
    timed = [_timed(10.0 + i, [10.5 + i, 10.6 + i, 10.7 + i]) for i in range(9)]
    timed.append(_timed(15.0, []))  # never served: its TTFT runs to the close
    timed.append(_timed(5.0, [12.0, 13.0]))  # due before the window: not in the tails
    timed.append(_timed(19.5, [19.9, 20.5]))  # one token before the close: no TPOT yet
    e = end_to_end(timed, t_open, t_close)
    assert e["n_due"] == 11
    # TTFT: nine of 0.5 s, 0.4 s, and one of 5 s (the stalled request)
    ttft = sorted([0.5] * 9 + [0.4, 5.0])
    assert e["ttft_p90_ms"] == pytest.approx(1e3 * float(np.percentile(ttft, 90)))
    assert e["tpot_p90_ms"] == pytest.approx(100.0)
    # every token committed in [10, 20) counts, also those of earlier requests
    assert e["out_tok_s"] == pytest.approx((27 + 2 + 1) / 10.0)


def test_i4g_and_cell_attention_work():
    b, ops = rl.i4g_work(1, 4096, 4096)
    assert ops == 2 * 4096 * 4096
    assert b == 4096 + 4 * 32 + 4 * 32 + 2048 * 4096 + 2 * 4 * 32 * 4096 + 4 * 4096
    assert rl.least_s(b, ops, rl.PEAK_INT8_OPS) == pytest.approx(b / rl.HBM_BPS)
    b, ops = rl.i4g_work(4096, 4096, 4096)
    assert rl.least_s(b, ops, rl.PEAK_INT8_OPS) == pytest.approx(ops / rl.PEAK_INT8_OPS)
    b, f = rl.cell_attn_work(rows=2, visible=100, pairs=150, n_heads=32, n_kv_heads=8, head_dim=128)
    assert b == 2 * 4 * 2 * 32 * 128 + 2 * 2 * 100 * 8 * 128
    assert f == 4 * 32 * 128 * 150


def test_mfu_denominator_is_the_int8_peak():
    mb = SimpleNamespace(n_layers=1, n_heads=1, head_dim=1, n_vocab=1, n_embd=1,
                         slots=lambda: [("w", 1, 1)])
    run = RunData(mb=mb, roofline=rl, t_open=0.0, t_close=2.0,
                  timed=[SimpleNamespace(planned=SimpleNamespace(prompt=[0, 0]),
                                         stamps=[0.5, 1.0, 3.0])])
    # prompt of 2: 2 * (2 * 2 weights) + 4 * (1 + 2); one output token at context 3
    flops = 2 * 4 + 4 * 3 + 4 + 4 * 3
    assert load_metric("mfu_pct").read(run) == pytest.approx(100 * flops / (2.0 * 1979e12))


def test_device_idle_and_gaps():
    k = Kernels([("a", 0.0, 1.0), ("b", 0.5, 2.0), ("c", 3.0, 4.0)], 0.0, 5.0)
    assert k.busy_s() == pytest.approx(3.0)
    assert k.gaps() == [(2.0, 3.0), (4.0, 5.0)]
    run = SimpleNamespace(kernels=k)
    assert load_metric("device_idle_pct").read(run) == pytest.approx(40.0)
    spans = [("dispatch", 2.2, 2.8), ("collect", 4.0, 5.0)]
    assert label_gaps(k.gaps(), spans) == [["dispatch", 1.0], ["collect", 1.0]]


def test_readers_return_nothing_without_input():
    empty = Kernels([], 0.0, 1.0)
    rec = SimpleNamespace(admits=[], dispatches=[], handles=[], spans=[])
    run = RunData(kernels=empty, rec=rec, timed=[], t_open=0.0, t_close=1.0, i4g_calls=[],
                  port_kernels={}, roofline=rl, spec={"n_draft": 8}, rounds=4,
                  mb=SimpleNamespace(n_layers=1, n_heads=1, head_dim=1, n_vocab=1, n_embd=1,
                                     n_kv_heads=1, draft_layers=1, slots=lambda: []))
    for name in ("prefill_ms.p50", "accept_len.device", "kernels_per_tok", "i4g_roofline",
                 "cell_attn_roofline", "mfu_pct", "device_idle_pct"):
        assert load_metric(name).read(run) is None, name


def test_draft_decisions_follow_the_rounds():
    """Served token 0 is the prefill's; a round of depth 4 that accepted m
    shows m accepted picks and, where m < 4, one rejected; rounds past the
    served tokens show nothing."""
    from portbench.check import draft_decisions

    served = list(range(12))
    idx, acc = draft_decisions(served, [2, 4, 0, 3, 4, 4], 4)
    # round 1: 1, 2 accepted, 3 rejected; round 2: 4-7 accepted (8 the
    # bonus); round 3: 9 rejected; round 4: 10, 11 accepted, then the end
    assert idx == [1, 2, 3, 4, 5, 6, 7, 9, 10, 11]
    assert acc == [True, True, False, True, True, True, True, False, True, True]


def test_decision_gaps_read_a_wrong_decision_by_its_margin():
    import torch

    from portbench.check import decision_gaps

    lg = torch.tensor([[0.0, 1.0, 0.5], [0.0, 1.0, 0.5], [0.0, 1.0, 0.5], [0.0, 1.0, 0.5]])
    tok = torch.tensor([1, 2, 1, 2])
    acc = torch.tensor([True, True, False, False])
    # accepted argmax 0; accepted non-argmax: 1.0 - 0.5; rejected argmax:
    # its margin 1.0 - 0.5; rejected non-argmax 0
    assert decision_gaps(lg, tok, acc).tolist() == [0.0, 0.5, 0.5, 0.0]


def test_traced_slice_runs_on_until_the_lanes_step():
    """A slice ends only once a dispatch started and a token came in it;
    without device lanes a token is enough."""
    from portbench.run import Window

    rec = SimpleNamespace(dispatches=[(4.0, [])])
    drv = SimpleNamespace(timed=[SimpleNamespace(stamps=[3.0, 4.5]), SimpleNamespace(stamps=[])])
    assert Window._lanes_stepped(rec, drv, 4.0)
    assert not Window._lanes_stepped(rec, drv, 4.2)  # no dispatch since
    assert not Window._lanes_stepped(rec, drv, 4.6)
    assert Window._lanes_stepped(SimpleNamespace(dispatches=[]), drv, 4.2)
    assert not Window._lanes_stepped(SimpleNamespace(dispatches=[]), drv, 5.0)
