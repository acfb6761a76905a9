"""The sampled path's statistics: does what an engine samples follow the
sampler chain's distribution?

Both checks hold draws against the host sampler's exact distribution,
``sampling.samplers.top_probs`` of the (temp, top_k, top_p, min_p) chain:

- the device sampler alone (``runtime.context._device_draft_sample``): N
  draws from logits rows, counted per token, against N times the exact
  probabilities by a chi-square test whose cells with an expected count
  under 5 are merged (``chi_square``, bar ``CHI2_MIN_P``). A draw outside
  the chain's kept set fails it by itself;
- an engine's stream (``pit``): each emitted token t at its prefix, with
  that prefix's exact probabilities p in ``top_probs``' order, gives U =
  F(t-) + V p(t), V uniform from a fixed numpy seed: a randomized
  probability integral transform. When every token is a sample of the
  target's chain at its prefix the U are i.i.d. U(0, 1) (the Rosenblatt
  transform of sequential sampling), so the Kolmogorov-Smirnov statistic
  must stay within ``ks_bar(n)`` (alpha = 1e-3). The prefixes' logits
  come from a plain context teacher-forced over the prompt and the stream
  (``teacher_rows``).

A bar says something only if a fault fails it: ``SAMPLER_FAULTS`` are the
device sampler with the temperature dropped, the top-p/min-p gates taken
on the post-temperature probabilities, and a 64-token window in place of
top_k; ``target_temp_fault`` samples spec_round's rows at temp 1.0, the
fault sent through the device-verified engines. A test is only as strong
as the spread of the chain's distribution: at nearly flat logits the
temperature barely moves it, so ``entropy_bits`` is reported beside every
PIT test, which needs at least ``MIN_ENTROPY_BITS``.

Where host-sampled streams that should be equal part (the verify pass's
rows are not the plain decode's when a matmul rounds its activations by
the step's rows), ``recorded_draws`` and ``part_report`` say whether that
difference moved the draw across a boundary of the sampler's CDF.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from ..runtime.context import Batch
from ..sampling.samplers import SamplerState, SamplingParams, top_probs

CHAIN = (0.8, 40, 0.95, 0.05)  # (temp, top_k, top_p, min_p): the CLI's defaults
CHI2_MIN_P = 1e-3  # the chi-square's p-value must reach this
MIN_EXPECTED = 5.0  # cells expecting fewer draws are merged
KS_C = 1.95  # D <= KS_C / sqrt(n): the KS bar at alpha = 1e-3
MIN_ENTROPY_BITS = 1.0  # below this mean entropy a PIT test is too weak to count


def chain_params(chain: tuple = CHAIN, **kw) -> SamplingParams:
    """SamplingParams of a (temp, top_k, top_p, min_p) chain with no
    penalties: what the device samplers express."""
    temp, top_k, top_p, min_p = chain
    return SamplingParams(temp=temp, top_k=top_k, top_p=top_p, min_p=min_p,
                          penalty_repeat=1.0, penalty_last_n=0, **kw)


def exact(row, chain: tuple = CHAIN) -> tuple[np.ndarray, np.ndarray]:
    """(ids, probs) of the chain's distribution over one logits row (or
    SparseLogits), in top_probs' order (descending), its zero tail cut."""
    top = top_probs(SamplerState(params=chain_params(chain)), row, int(chain[1]))
    ids = np.array([i for i, _ in top], np.int64)
    probs = np.array([p for _, p in top], np.float64)
    keep = probs > 0
    return ids[keep], probs[keep]


def entropy_bits(probs: np.ndarray) -> float:
    p = probs[probs > 0]
    return float(-(p * np.log2(p)).sum())


# -- chi-square -------------------------------------------------------------


def _gamma_q(a: float, x: float) -> float:
    """The regularized upper incomplete gamma function Q(a, x): a series
    below a + 1, Lentz's continued fraction above it."""
    if x <= 0:
        return 1.0
    lead = a * math.log(x) - x - math.lgamma(a)
    if x < a + 1:
        term = total = 1.0 / a
        ap = a
        for _ in range(10000):
            ap += 1
            term *= x / ap
            total += term
            if abs(term) < abs(total) * 1e-15:
                break
        return max(0.0, 1.0 - total * math.exp(lead))
    tiny = 1e-300
    b = x + 1 - a
    c, d = 1 / tiny, 1 / b
    h = d
    for i in range(1, 10000):
        an = -i * (i - a)
        b += 2
        d = an * d + b
        d = tiny if abs(d) < tiny else d
        c = b + an / c
        c = tiny if abs(c) < tiny else c
        d = 1 / d
        step = d * c
        h *= step
        if abs(step - 1) < 1e-15:
            break
    return h * math.exp(lead)


def chi2_sf(stat: float, dof: int) -> float:
    """P(X >= stat) for X chi-square with `dof` degrees of freedom."""
    return _gamma_q(dof / 2.0, stat / 2.0)


def merged_cells(expected: np.ndarray) -> list[np.ndarray]:
    """Index groups of cells so that each group expects >= MIN_EXPECTED:
    cells in descending order, the small tail pooled from the end, a pool
    left under the minimum joined to the group before it."""
    order = np.argsort(-expected, kind="stable")
    groups, pool, acc = [], [], 0.0
    for j in order:
        if expected[j] >= MIN_EXPECTED and not pool:
            groups.append([j])
            continue
        pool.append(j)
        acc += expected[j]
        if acc >= MIN_EXPECTED:
            groups.append(pool)
            pool, acc = [], 0.0
    if pool:
        if groups:
            groups[-1] = list(groups[-1]) + pool
        else:
            groups.append(pool)
    return [np.asarray(g) for g in groups]


def chi_square(counts: np.ndarray, probs: np.ndarray, outside: int = 0) -> dict:
    """Observed counts per kept token against their probabilities (the
    kept set's, summing to 1), cells under MIN_EXPECTED merged. `outside`
    counts draws of tokens the chain does not keep. Returns {stat, dof, p,
    n, outside, cells}; p is 0 when anything fell outside."""
    n = int(counts.sum()) + int(outside)
    expected = probs / probs.sum() * n
    groups = merged_cells(expected)
    obs = np.array([counts[g].sum() for g in groups], np.float64)
    exp = np.array([expected[g].sum() for g in groups], np.float64)
    stat = float(((obs - exp) ** 2 / exp).sum())
    dof = max(len(groups) - 1, 1)
    p = 0.0 if outside else chi2_sf(stat, dof)
    return dict(stat=stat, dof=dof, p=p, n=n, outside=int(outside), cells=len(groups))


def chi_square_draws(draws: np.ndarray, ids: np.ndarray, probs: np.ndarray) -> dict:
    """chi_square of draws (token ids) against the kept set (ids, probs)."""
    pos = {int(t): j for j, t in enumerate(ids)}
    counts = np.zeros(len(ids), np.int64)
    outside = 0
    tok, cnt = np.unique(np.asarray(draws).reshape(-1), return_counts=True)
    for t, c in zip(tok.tolist(), cnt.tolist()):
        if t in pos:
            counts[pos[t]] += c
        else:
            outside += c
    return chi_square(counts, probs, outside)


def combine(results: list[dict]) -> dict:
    """Independent chi-square tests as one: statistics and degrees of
    freedom add."""
    stat = sum(r["stat"] for r in results)
    dof = sum(r["dof"] for r in results)
    outside = sum(r["outside"] for r in results)
    return dict(stat=stat, dof=dof, p=0.0 if outside else chi2_sf(stat, dof),
                n=sum(r["n"] for r in results), outside=outside,
                cells=sum(r["cells"] for r in results))


# -- the device sampler and its faults -------------------------------------


def _gates_post_temp(rows: torch.Tensor, samp: tuple, gen: torch.Generator) -> torch.Tensor:
    """_device_draft_sample with its top-p and min-p gates taken on the
    post-temperature probabilities (the chain order reversed)."""
    temp, top_k, top_p, min_p = samp
    vals, ids = torch.topk(rows, min(max(int(top_k), 1), rows.shape[-1]), dim=-1)
    logp = torch.log_softmax(vals / max(temp, 1e-6), dim=-1)
    probs = logp.exp()
    allow = (torch.cumsum(probs, dim=-1) - probs) < top_p
    if min_p > 0:
        allow &= probs >= min_p * probs[..., :1]
    allow[..., 0] = True
    u = torch.rand(vals.shape, generator=gen, device=rows.device) * (1.0 - 1e-9) + 1e-9
    pick = torch.argmax(torch.where(allow, logp - torch.log(-torch.log(u)), float("-inf")),
                        dim=-1, keepdim=True)
    return ids.gather(-1, pick).squeeze(-1).to(torch.int32)


def sampler_fault(name: str):
    """The device sampler (rows, samp, gen) -> tokens under fault `name`."""
    from ..runtime.context import _device_draft_sample as real

    if name == "temp_dropped":
        return lambda rows, samp, gen: real(rows, (1.0,) + tuple(samp[1:]), gen)
    if name == "gates_post_temp":
        return _gates_post_temp
    if name == "window_64":
        return lambda rows, samp, gen: real(rows, (samp[0], 64) + tuple(samp[2:]), gen)
    raise KeyError(name)


SAMPLER_FAULTS = ("temp_dropped", "gates_post_temp", "window_64")


def draw(sampler, rows: torch.Tensor, n: int, chain: tuple, seed: int,
         chunk: int = 8192) -> np.ndarray:
    """n draws [n] from `sampler` over the R logits rows (row r % R for
    draw r), `chunk` rows a call, from one torch.Generator seeded `seed`
    on the rows' device."""
    gen = torch.Generator(device=rows.device)
    gen.manual_seed(int(seed))
    r = rows.shape[0]
    out = []
    for i in range(0, n, chunk):
        idx = torch.arange(i, min(i + chunk, n), device=rows.device) % r
        out.append(sampler(rows[idx], chain, gen).cpu().numpy())
    return np.concatenate(out)


def sampler_check(sampler, rows: torch.Tensor, n: int, chain: tuple = CHAIN,
                  seed: int = 0) -> dict:
    """n draws of `sampler` over R rows (n / R each) against each row's
    exact distribution: one chi-square per row, combined."""
    draws = draw(sampler, rows, n, chain, seed)
    host = rows.float().cpu().numpy()
    per_row = []
    for r in range(host.shape[0]):
        ids, probs = exact(host[r], chain)
        per_row.append(chi_square_draws(draws[r::host.shape[0]], ids, probs))
    out = combine(per_row)
    out["rows"] = len(per_row)
    return out


@contextlib.contextmanager
def target_temp_fault(temp: float = 1.0):
    """spec_round's device sampler at `temp`: the device-verified engines'
    target samples (and drafts, which only shape acceptance) drawn at the
    wrong temperature."""
    from ..spec import corrected

    real = corrected._device_draft_sample
    corrected._device_draft_sample = lambda rows, samp, gen: real(
        rows, (float(temp),) + tuple(samp[1:]), gen)
    try:
        yield
    finally:
        corrected._device_draft_sample = real


# -- engines' streams -------------------------------------------------------


def teacher_rows(ctx, runs: list, step: int = 0, topk: int | None = None) -> list:
    """Teacher-forced logits of (prompt, stream) runs on a fresh context,
    run k on sequence k: per run, rows [len(stream)] where row i is the
    target's at the prefix that stream[i] was sampled at (numpy [n, V], or
    SparseLogits when topk is set, which top_probs reads exactly for a
    chain whose top_k fits). The prompts go in one pass; the streams with
    them (step 0) or `step` tokens a run at a time, all runs in one step.
    A quantized matmul that shares one activation scale across a step's
    rows (i4g, i8g) rounds a row by the step's largest value: steps of a
    few rows round as the engines' verify passes do (on the card one pass
    left 3.1-3.4% of the engines' tokens outside the rows' kept sets,
    3-row steps 1.5-2.0%)."""
    seqs = [list(p) + list(s[:-1]) for p, s in runs]
    starts = [len(p) - 1 for p, _ in runs]  # the position whose row decides stream[0]
    cut = [len(t) if step <= 0 else len(p) for t, (p, _) in zip(seqs, runs)]
    spans = [[(k, 0, cut[k]) for k in range(len(runs))]]
    for lo in range(0, max((len(t) - c for t, c in zip(seqs, cut)), default=0), max(step, 1)):
        spans.append([(k, cut[k] + lo, min(cut[k] + lo + step, len(t)))
                      for k, t in enumerate(seqs) if cut[k] + lo < len(t)])
    rows: list = [[] for _ in runs]
    for span in spans:
        b, order = Batch(), []
        for k, lo, hi in span:
            for i in range(lo, hi):
                b.add(int(seqs[k][i]), i, k)
                order.append((k, i))
        for (k, i), row in zip(order, ctx.decode(b, topk)):
            if i >= starts[k]:
                rows[k].append(row)
    return [r if topk else np.asarray(r) for r in rows]


def pit(stream: list[int], rows: np.ndarray, chain: tuple, rng: np.random.Generator) -> dict:
    """Randomized PIT values of `stream` under its rows' exact
    distributions. Returns {u [n], outside, entropy_bits (mean)}. A token
    the row's chain does not keep has p = 0 and sits after every kept
    token, so its u is 1; `outside` counts them. (Rows that are not the
    engine's own, such as a teacher-forced pass through a matmul that
    rounds its activations by the step's rows, can move a token at the
    edge of the kept set across it.)"""
    us, ents, outside = [], [], 0
    for t, row in zip(stream, rows):
        ids, probs = exact(row, chain)
        ents.append(entropy_bits(probs))
        hit = np.nonzero(ids == int(t))[0]
        v = rng.random()
        if len(hit) == 0:
            outside += 1
            us.append(1.0)
            continue
        j = int(hit[0])
        us.append(float(probs[:j].sum() + v * probs[j]))
    return dict(u=np.asarray(us), outside=outside, entropy_bits=float(np.mean(ents)))


def ks_stat(u: np.ndarray) -> float:
    """The Kolmogorov-Smirnov distance of u's empirical CDF from U(0, 1)."""
    x = np.sort(np.asarray(u, np.float64))
    n = len(x)
    i = np.arange(1, n + 1)
    return float(max((i / n - x).max(), (x - (i - 1) / n).max()))


def ks_bar(n: int) -> float:
    return KS_C / math.sqrt(n)


@contextlib.contextmanager
def recorded_draws(*modules):
    """Record every host draw made through `modules`' name `sample` (the
    host sampler, as cli.main's loop and the controller's verification
    call it): yields a list that gets (sampler state copy before the
    draw, logits row) per call, in order."""
    calls = []
    reals = [m.sample for m in modules]

    def make(real):
        def sample(state, logits, cfg_logits=None):
            calls.append((state.copy(), logits))
            return real(state, logits, cfg_logits)
        return sample

    for m, real in zip(modules, reals):
        m.sample = make(real)
    try:
        yield calls
    finally:
        for m, real in zip(modules, reals):
            m.sample = real


def _chain_cdf(state: SamplerState, row) -> tuple[np.ndarray, np.ndarray]:
    """(ids, cdf) of the host draw from `row` at `state`, in the order its
    rng.choice walks them (the draw's token is the first id whose cdf
    exceeds the draw's uniform)."""
    from ..sampling.samplers import sample_with_candidates

    _, cand = sample_with_candidates(state.copy(), row)
    cdf = np.cumsum(cand.probs.astype(np.float64))
    return np.asarray(cand.ids, np.int64), cdf / cdf[-1]


def part_report(calls_a: list, calls_b: list, k: int) -> dict:
    """Where two host-sampled streams from one seed part at draw k: the
    draw's uniform u (both samplers hold the same rng state there), its
    distance to the nearest boundary of stream a's CDF, and the largest
    shift of the CDF (taken in a's order) that b's logits row makes.
    explained: the shift reaches the distance, so logits that differ by
    that much move the draw across a boundary."""
    (sa, row_a), (sb, row_b) = calls_a[k], calls_b[k]
    rng = np.random.default_rng(0)
    rng.bit_generator.state = sa.rng.bit_generator.state
    u = float(rng.random())
    ids_a, cdf_a = _chain_cdf(sa, row_a)
    ids_b, cdf_b = _chain_cdf(sb, row_b)
    p_b = dict(zip(ids_b.tolist(), np.diff(np.concatenate([[0.0], cdf_b])).tolist()))
    cdf_b_in_a = np.cumsum([p_b.get(t, 0.0) for t in ids_a.tolist()])
    distance = float(np.abs(cdf_a[:-1] - u).min()) if len(cdf_a) > 1 else 1.0
    shift = float(np.abs(cdf_a - cdf_b_in_a).max())
    tok_a = int(ids_a[min(np.searchsorted(cdf_a, u, side="right"), len(ids_a) - 1)])
    tok_b = int(ids_b[min(np.searchsorted(cdf_b, u, side="right"), len(ids_b) - 1)])
    return dict(draw=k, u=u, distance=distance, shift=shift, token_a=tok_a, token_b=tok_b,
                explained=bool(shift >= distance and tok_a != tok_b))


def ks_check(pits: list[dict]) -> dict:
    """Pool PIT results: {n, D, bar, entropy_bits, outside, passes_ks, ok};
    ok needs D within the bar and a mean entropy of at least
    MIN_ENTROPY_BITS."""
    u = np.concatenate([p["u"] for p in pits])
    n = len(u)
    d = ks_stat(u)
    ent = float(np.mean([p["entropy_bits"] for p in pits]))
    return dict(n=n, D=d, bar=ks_bar(n), entropy_bits=ent,
                outside=sum(p["outside"] for p in pits), passes_ks=bool(d <= ks_bar(n)),
                ok=bool(d <= ks_bar(n) and ent >= MIN_ENTROPY_BITS))
