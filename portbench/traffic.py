"""The one traffic generator: a mix's parameters (``traffic/<name>.json``)
and a seed give the requests of a run.

Every seed gets the same set of sizes and arrival gaps, so that two seeds
give the same work. Sizes come in blocks of ``block`` requests: each block
holds the ``block`` quantiles of the prompt-length and of the output-length
distribution once, each list in an order of its own. Open-loop arrival
gaps are the quantiles of the exponential distribution of the mix's rate,
in blocks likewise. The orders are one fixed draw (``ORDER_SEED``), the
same for every seed: with orders drawn from the seed, an open loop's tails
hung on where its bursts fell (one seed read itself within 3%, another
seed 3.4 times as high), so every seed replays one arrival pattern with
prompts of its own. Prompt token ids are uniform over the vocabulary, from
the seed.
"""

from __future__ import annotations

import dataclasses
import math
from statistics import NormalDist

import numpy as np

ORDER_SEED = 0  # the one order of sizes and arrival gaps
CLOSED_MIN_S = 1.0  # a closed-loop client finishes at most one request per this many seconds


@dataclasses.dataclass
class Planned:
    """One request of the plan: when it is due (s after the generator
    starts; closed loops: None), its prompt and its output budget."""

    due: float | None
    prompt: list
    n_predict: int


def _quantiles(dist: dict, block: int) -> np.ndarray:
    """The block's lengths: the quantiles (i + 0.5) / block of a lognormal
    with the given median and sigma, rounded and clipped to [min, max]."""
    nd = NormalDist()
    z = np.array([nd.inv_cdf((i + 0.5) / block) for i in range(block)])
    x = np.round(dist["median"] * np.exp(dist["sigma"] * z))
    return np.clip(x, dist["min"], dist["max"]).astype(np.int64)


def plan(mix: dict, seed: int, n_vocab: int, n_requests: int) -> list[Planned]:
    """The first n_requests requests of mix under seed."""
    rng = np.random.default_rng(seed)
    order = np.random.default_rng(ORDER_SEED)
    block = int(mix["block"])
    p_q, o_q = _quantiles(mix["prompt"], block), _quantiles(mix["output"], block)
    n_blocks = -(-n_requests // block)
    prompts = np.concatenate([order.permutation(p_q) for _ in range(n_blocks)])[:n_requests]
    outputs = np.concatenate([order.permutation(o_q) for _ in range(n_blocks)])[:n_requests]
    dues = [None] * n_requests
    if mix["loop"] == "open":
        u = (np.arange(block) + 0.5) / block
        gaps_q = -np.log1p(-u) / float(mix["rate_rps"])
        gaps = np.concatenate([order.permutation(gaps_q) for _ in range(n_blocks)])[:n_requests]
        dues = np.concatenate([[0.0], np.cumsum(gaps)[:-1]]).tolist()
    return [Planned(due, rng.integers(0, n_vocab, int(p)).tolist(), int(o))
            for due, p, o in zip(dues, prompts, outputs)]


def n_requests(mix: dict, seconds: float) -> int:
    """Requests a run plans: for an open loop all that fall due in the
    lead-in and the window, for a closed loop more than its clients can
    finish (at most one per client per CLOSED_MIN_S seconds)."""
    span = float(mix["lead_s"]) + seconds
    if mix["loop"] == "open":
        return int(math.ceil(span * float(mix["rate_rps"]))) + 1
    return int(mix["clients"]) * (int(math.ceil(span / CLOSED_MIN_S)) + 1)
