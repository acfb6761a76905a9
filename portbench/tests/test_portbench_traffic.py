"""The traffic generator: one plan per seed, the same work for every seed,
lengths as the mix states."""

import numpy as np
import pytest

from portbench import traffic
from portbench.cell import HERE
import json


def _mix(name):
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


@pytest.mark.parametrize("name", ["greedy_open", "greedy_closed16"])
def test_plan_is_deterministic_per_seed(name):
    mix = _mix(name)
    a = traffic.plan(mix, 2**31 + 12345, 32000, 64)
    b = traffic.plan(mix, 2**31 + 12345, 32000, 64)
    c = traffic.plan(mix, 7, 32000, 64)
    assert [(p.due, p.prompt, p.n_predict) for p in a] == [(p.due, p.prompt, p.n_predict) for p in b]
    assert [p.prompt for p in a] != [p.prompt for p in c]


@pytest.mark.parametrize("name", ["greedy_open", "greedy_closed16"])
def test_every_seed_replays_one_pattern(name):
    """Every seed gets the same sizes and arrivals in the same order, and
    prompts of its own."""
    mix = _mix(name)
    a, b = (traffic.plan(mix, s, 32000, 40) for s in (3, 2**32 + 9))
    assert [(x.due, len(x.prompt), x.n_predict) for x in a] == \
        [(x.due, len(x.prompt), x.n_predict) for x in b]
    assert [x.prompt for x in a] != [x.prompt for x in b]


def test_lengths_follow_the_mix():
    mix = _mix("greedy_open")
    plan = traffic.plan(mix, 99, 50432, 4 * mix["block"])
    p = np.array([len(x.prompt) for x in plan])
    o = np.array([x.n_predict for x in plan])
    assert p.min() >= 64 and p.max() <= 1536 and abs(np.median(p) - 512) <= 40
    assert o.min() >= 16 and o.max() <= 512 and abs(np.median(o) - 128) <= 12
    assert all(0 <= t < 50432 for x in plan for t in x.prompt)
    assert len({len(x.prompt) for x in plan}) > mix["block"] // 2  # heavy-tailed, not fixed


def test_open_loop_arrivals():
    mix = _mix("greedy_open")
    plan = traffic.plan(mix, 5, 32000, 10 * mix["block"])
    dues = np.array([p.due for p in plan])
    gaps = np.diff(dues)
    assert dues[0] == 0.0 and (gaps > 0).all()
    assert abs(gaps.mean() * mix["rate_rps"] - 1.0) < 0.1
    assert traffic.n_requests(mix, 45) == int(np.ceil((mix["lead_s"] + 45) * mix["rate_rps"])) + 1
    assert all(p.due is None for p in traffic.plan(_mix("greedy_closed16"), 5, 32000, 8))
