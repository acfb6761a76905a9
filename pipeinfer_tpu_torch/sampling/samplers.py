"""Token samplers: the reference's full chain re-implemented on numpy.

Chain order (ref: common/sampling.cpp:140-200 `llama_sampling_sample`):
logit_bias → CFG → repetition/freq/presence penalties (with newline
preservation) → grammar mask → then one of:
  temp < 0  : softmax + argmax ("greedy with probs", used for drafting —
              ref: speculative.cpp:274)
  temp == 0 : plain greedy
  mirostat 1/2, or the top_k → tail_free → typical → top_p → min_p → temp
  pipeline, each with min_keep=1.

Sampling runs on the host (the PipeInfer head node samples on CPU too);
logits arrive as numpy. Sampler state (prev-token ring, mirostat mu,
grammar stacks) is copyable for per-async-run snapshots
(ref: sampling.h:72 llama_sampling_cp, speculative.cpp:1234-1245).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class SamplingParams:
    """ref: common/sampling.h:17-40 llama_sampling_params."""

    n_prev: int = 64
    top_k: int = 40
    top_p: float = 0.95
    min_p: float = 0.05
    tfs_z: float = 1.0
    typical_p: float = 1.0
    temp: float = 0.8
    penalty_last_n: int = 64
    penalty_repeat: float = 1.1
    penalty_freq: float = 0.0
    penalty_present: float = 0.0
    mirostat: int = 0
    mirostat_tau: float = 5.0
    mirostat_eta: float = 0.1
    penalize_nl: bool = True
    logit_bias: dict[int, float] = dataclasses.field(default_factory=dict)
    cfg_scale: float = 1.0
    seed: int = -1


@dataclasses.dataclass
class SamplerState:
    """Mutable sampling context; `copy()` snapshots it for async runs."""

    params: SamplingParams
    prev: list[int] = dataclasses.field(default_factory=list)
    mirostat_mu: float = 0.0
    rng: np.random.Generator = None  # type: ignore[assignment]
    grammar: Optional[object] = None  # sampling.grammar.GrammarState

    def __post_init__(self):
        if self.rng is None:
            seed = self.params.seed
            self.rng = np.random.default_rng(None if seed < 0 else seed)

    def copy(self) -> "SamplerState":
        g = self.grammar.copy() if self.grammar is not None else None
        new = SamplerState(
            params=self.params,
            prev=list(self.prev),
            mirostat_mu=self.mirostat_mu,
            rng=np.random.default_rng(0),
            grammar=g,
        )
        new.rng.bit_generator.state = self.rng.bit_generator.state
        return new

    def accept(self, token: int, apply_grammar: bool = True):
        """ref: llama_sampling_accept."""
        self.prev.append(int(token))
        if len(self.prev) > self.params.n_prev:
            self.prev = self.prev[-self.params.n_prev :]
        if self.grammar is not None and apply_grammar:
            self.grammar.accept_token(token)

    def reset(self):
        self.prev.clear()
        self.mirostat_mu = 0.0
        if self.grammar is not None:
            self.grammar.reset()


# ---------------------------------------------------------------------------
# primitive transforms on (ids, logits) candidate arrays
# ---------------------------------------------------------------------------


def _softmax(logits: np.ndarray) -> np.ndarray:
    m = logits.max()
    e = np.exp(logits - m)
    return e / e.sum()


def apply_repetition_penalties(
    logits: np.ndarray,
    last_tokens: np.ndarray,
    penalty_repeat: float,
    penalty_freq: float,
    penalty_present: float,
) -> np.ndarray:
    """ref: llama_sample_repetition_penalties (llama.cpp sampler prims)."""
    if len(last_tokens) == 0 or (
        penalty_repeat == 1.0 and penalty_freq == 0.0 and penalty_present == 0.0
    ):
        return logits
    out = logits.copy()
    ids, counts = np.unique(np.asarray(last_tokens, dtype=np.int64), return_counts=True)
    keep = (ids >= 0) & (ids < len(logits))
    ids, counts = ids[keep], counts[keep]
    vals = out[ids]
    vals = np.where(vals <= 0, vals * penalty_repeat, vals / penalty_repeat)
    vals = vals - counts * penalty_freq - (counts > 0) * penalty_present
    out[ids] = vals
    return out


def top_k_filter(logits: np.ndarray, k: int, min_keep: int = 1) -> np.ndarray:
    """Returns a mask of kept ids (True=keep)."""
    n = len(logits)
    k = n if k <= 0 else max(min_keep, min(k, n))
    if k >= n:
        return np.ones(n, bool)
    thresh = np.partition(logits, -k)[-k]
    return logits >= thresh


def top_p_filter(probs_sorted: np.ndarray, p: float, min_keep: int = 1) -> int:
    """Given descending probs, how many to keep (ref: llama_sample_top_p)."""
    if p >= 1.0:
        return len(probs_sorted)
    cum = np.cumsum(probs_sorted)
    keep = int(np.searchsorted(cum, p) + 1)
    return max(min_keep, min(keep, len(probs_sorted)))


def min_p_filter(probs_sorted: np.ndarray, p: float, min_keep: int = 1) -> int:
    """Keep candidates with prob >= p * max_prob (ref: llama_sample_min_p)."""
    if p <= 0.0:
        return len(probs_sorted)
    thresh = probs_sorted[0] * p
    keep = int((probs_sorted >= thresh).sum())
    return max(min_keep, keep)


def tail_free_filter(probs_sorted: np.ndarray, z: float, min_keep: int = 1) -> int:
    """Tail-free sampling on second derivative (ref: llama_sample_tail_free)."""
    n = len(probs_sorted)
    if z >= 1.0 or n <= 2:
        return n
    d2 = np.abs(np.diff(probs_sorted, n=2))
    s = d2.sum()
    if s > 0:
        d2 = d2 / s
    cum = np.cumsum(d2)
    keep = int(np.searchsorted(cum, z) + 1)
    return max(min_keep, min(keep, n))


def typical_filter(probs_sorted: np.ndarray, p: float, min_keep: int = 1) -> np.ndarray:
    """Locally-typical sampling; returns kept *indices into the sorted
    array* in typicality order (ref: llama_sample_typical)."""
    n = len(probs_sorted)
    if p >= 1.0:
        return np.arange(n)
    entropy = -np.sum(probs_sorted * np.log(np.maximum(probs_sorted, 1e-30)))
    shifted = np.abs(-np.log(np.maximum(probs_sorted, 1e-30)) - entropy)
    order = np.argsort(shifted, kind="stable")
    cum = np.cumsum(probs_sorted[order])
    keep = max(min_keep, int(np.searchsorted(cum, p) + 1))
    return order[:keep]


# ---------------------------------------------------------------------------
# the chain
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Candidates:
    """Post-chain candidate list: descending-prob ids + probs (the
    counterpart of llama_token_data_array after llama_sample_softmax).
    Used by the draft controller for p_accept/p_split decisions."""

    ids: np.ndarray
    probs: np.ndarray


@dataclasses.dataclass
class SparseLogits:
    """Device-computed top-K logits + the exact full-vocab softmax
    normalizer. Shipping (K ids, K vals, lse) instead of the whole vocab
    row keeps decode off the host-transfer bottleneck; `lse` makes
    probabilities exact (softmax over the full vocabulary, not just K)."""

    ids: np.ndarray  # int32 [K], descending by value
    vals: np.ndarray  # float32 [K]
    lse: float  # logsumexp over the FULL vocab row

    def probs(self) -> np.ndarray:
        return np.exp(self.vals.astype(np.float64) - self.lse).astype(np.float32)


def _chain_filter(logits: np.ndarray, p: SamplingParams) -> Candidates:
    mask = top_k_filter(logits, p.top_k)
    ids = np.nonzero(mask)[0]
    lg = logits[ids]
    order = np.argsort(-lg, kind="stable")
    ids, lg = ids[order], lg[order]
    probs = _softmax(lg)

    keep = tail_free_filter(probs, p.tfs_z)
    ids, probs = ids[:keep], probs[:keep]
    probs = probs / probs.sum()

    t_idx = typical_filter(probs, p.typical_p)
    ids, probs = ids[t_idx], probs[t_idx]
    order = np.argsort(-probs, kind="stable")
    ids, probs = ids[order], probs[order]
    probs = probs / probs.sum()

    keep = top_p_filter(probs, p.top_p)
    ids, probs = ids[:keep], probs[:keep]
    probs = probs / probs.sum()

    keep = min_p_filter(probs, p.min_p)
    ids, probs = ids[:keep], probs[:keep]

    if p.temp != 1.0 and p.temp > 0:
        lg = np.log(np.maximum(probs, 1e-30)) / p.temp
        probs = _softmax(lg)
    else:
        probs = probs / probs.sum()
    return Candidates(ids, probs)


def _sample_sparse(state: SamplerState, sl: SparseLogits) -> tuple[int, Candidates]:
    """Chain over device-computed top-K candidates. Exact for greedy and
    for chains whose top_k fits within K; penalties apply to candidates in
    the window (tokens outside top-K are already improbable)."""
    p = state.params
    ids = sl.ids.astype(np.int64)
    vals = sl.vals.astype(np.float32).copy()
    for tid, bias in p.logit_bias.items():
        hit = np.nonzero(ids == tid)[0]
        if len(hit):
            vals[hit[0]] += bias
    if state.prev and p.penalty_last_n != 0:
        last_n = p.penalty_last_n if p.penalty_last_n > 0 else len(state.prev)
        window = np.asarray(state.prev[-last_n:], dtype=np.int64)
        w_ids, w_counts = np.unique(window, return_counts=True)
        for wid, cnt in zip(w_ids, w_counts):
            hit = np.nonzero(ids == wid)[0]
            if len(hit):
                v = vals[hit[0]]
                v = v * p.penalty_repeat if v <= 0 else v / p.penalty_repeat
                vals[hit[0]] = v - cnt * p.penalty_freq - p.penalty_present

    if p.temp < 0.0:
        # exact full-vocab probabilities via the shipped normalizer
        probs = np.exp(vals.astype(np.float64) - sl.lse).astype(np.float32)
        order = np.argsort(-probs, kind="stable")
        return int(ids[order[0]]), Candidates(ids[order], probs[order])
    if p.temp == 0.0:
        j = int(np.argmax(vals))
        return int(ids[j]), Candidates(np.array([ids[j]]), np.array([1.0], np.float32))

    cand = _chain_filter(vals, p)
    # cand.ids index into the candidate window; map back to vocab ids
    vocab_ids = ids[cand.ids]
    idx = state.rng.choice(len(vocab_ids), p=cand.probs / cand.probs.sum())
    return int(vocab_ids[idx]), Candidates(vocab_ids, cand.probs)


def sample_with_candidates(
    state: SamplerState,
    logits: np.ndarray | SparseLogits,
    cfg_logits: np.ndarray | None = None,
) -> tuple[int, Candidates]:
    """Full chain; returns (token, post-chain candidates).

    ref: llama_sampling_sample (common/sampling.cpp:123-208).
    """
    p = state.params
    if isinstance(logits, SparseLogits):
        if state.grammar is not None or cfg_logits is not None or p.mirostat:
            raise ValueError("grammar/CFG/mirostat need full logits (topk=None)")
        return _sample_sparse(state, logits)
    logits = np.asarray(logits, dtype=np.float32).copy()
    for tid, bias in p.logit_bias.items():
        logits[tid] += bias

    if cfg_logits is not None and p.cfg_scale != 1.0:
        # classifier-free guidance (ref: llama_sample_classifier_free_guidance)
        logits = p.cfg_scale * (logits - cfg_logits) + cfg_logits

    if state.prev and p.penalty_last_n != 0:
        last_n = p.penalty_last_n if p.penalty_last_n > 0 else len(state.prev)
        window = state.prev[-last_n:]
        nl_id = getattr(state, "nl_token", None)
        nl_logit = logits[nl_id] if (not p.penalize_nl and nl_id is not None) else None
        logits = apply_repetition_penalties(
            logits, window, p.penalty_repeat, p.penalty_freq, p.penalty_present
        )
        if nl_logit is not None:
            logits[nl_id] = nl_logit

    if state.grammar is not None:
        logits = state.grammar.mask_logits(logits)

    if p.temp < 0.0:
        probs = _softmax(logits)
        order = np.argsort(-probs, kind="stable")
        return int(order[0]), Candidates(order, probs[order])
    if p.temp == 0.0:
        tok = int(np.argmax(logits))
        return tok, Candidates(np.array([tok]), np.array([1.0], np.float32))

    if p.mirostat == 1:
        return _mirostat_v1(state, logits)
    if p.mirostat == 2:
        return _mirostat_v2(state, logits)

    cand = _chain_filter(logits, p)
    idx = state.rng.choice(len(cand.ids), p=cand.probs / cand.probs.sum())
    return int(cand.ids[idx]), cand


def sample(state: SamplerState, logits: np.ndarray, cfg_logits=None) -> int:
    return sample_with_candidates(state, logits, cfg_logits)[0]


def top_probs(
    state: SamplerState, logits: np.ndarray | SparseLogits, n: int
) -> list[tuple[int, float]]:
    """Top-n (token_id, prob) of the post-transform target distribution at
    the CURRENT sampler state — the server's per-token `n_probs` payload
    (ref: examples/server/server.cpp:1106-1123, probs_output from the
    post-chain candidate array). Pure query: does not advance the rng,
    penalties, or grammar (call before `accept`). At temp<=0 the
    distribution before the argmax collapse (plain softmax) is reported;
    at temp>0 the chain-filtered, renormalized sampling distribution."""
    p = state.params
    if isinstance(logits, SparseLogits):
        ids = logits.ids.astype(np.int64)
        vals = logits.vals.astype(np.float32).copy()
        lse = float(logits.lse)
        for tid, bias in p.logit_bias.items():
            hit = np.nonzero(ids == tid)[0]
            if len(hit):
                old = float(vals[hit[0]])
                vals[hit[0]] += bias
                # keep the full-vocab normalizer exact under the bias:
                # Z' = Z - e^old + e^(old+bias), folded in log space
                # (biases on tokens outside the shipped top-K window are
                # inherently unrepresentable in the sparse head)
                delta = np.exp(old + bias - lse) - np.exp(old - lse)
                # Z > e^old strictly, but fp rounding can hit -1 exactly
                # when a banned token carried ~all the mass
                lse += float(np.log1p(max(delta, -1.0 + 1e-12)))
        penalized = bool(state.prev) and p.penalty_last_n != 0
        if penalized:
            # same candidate-window penalty transform as _sample_sparse —
            # the reported distribution must be the one sample() draws from
            last_n = p.penalty_last_n if p.penalty_last_n > 0 else len(state.prev)
            window = np.asarray(state.prev[-last_n:], dtype=np.int64)
            w_ids, w_counts = np.unique(window, return_counts=True)
            for wid, cnt in zip(w_ids, w_counts):
                hit = np.nonzero(ids == wid)[0]
                if len(hit):
                    v = vals[hit[0]]
                    v = v * p.penalty_repeat if v <= 0 else v / p.penalty_repeat
                    vals[hit[0]] = v - cnt * p.penalty_freq - p.penalty_present
        if p.temp <= 0:
            if penalized:
                # penalties invalidate the full-vocab normalizer; softmax
                # over the candidate window instead
                probs = _softmax(vals).astype(np.float64)
            else:
                # exact full-vocab probabilities via the shipped normalizer
                probs = np.exp(vals.astype(np.float64) - lse)
        else:
            cand = _chain_filter(vals, p)
            out = np.zeros(len(ids))
            out[cand.ids] = cand.probs / cand.probs.sum()
            probs = out
        order = np.argsort(-probs, kind="stable")[:n]
        return [(int(ids[i]), float(probs[i])) for i in order]

    row = np.asarray(logits, dtype=np.float32).copy()
    for tid, bias in p.logit_bias.items():
        row[tid] += bias
    if state.prev and p.penalty_last_n != 0:
        last_n = p.penalty_last_n if p.penalty_last_n > 0 else len(state.prev)
        window = state.prev[-last_n:]
        nl_id = getattr(state, "nl_token", None)
        nl_logit = row[nl_id] if (not p.penalize_nl and nl_id is not None) else None
        row = apply_repetition_penalties(
            row, window, p.penalty_repeat, p.penalty_freq, p.penalty_present
        )
        if nl_logit is not None:
            row[nl_id] = nl_logit
    if state.grammar is not None:
        row = state.grammar.mask_logits(row)
    if p.temp <= 0 or p.mirostat:
        probs = _softmax(row)
        order = np.argsort(-probs, kind="stable")[:n]
        return [(int(i), float(probs[i])) for i in order]
    cand = _chain_filter(row, p)
    pr = cand.probs / cand.probs.sum()
    order = np.argsort(-pr, kind="stable")[:n]
    return [(int(cand.ids[i]), float(pr[i])) for i in order]


def _mirostat_v1(state: SamplerState, logits: np.ndarray) -> tuple[int, Candidates]:
    """ref: llama_sample_token_mirostat (m=100)."""
    p = state.params
    if state.mirostat_mu == 0.0:
        state.mirostat_mu = 2.0 * p.mirostat_tau
    lg = logits / p.temp
    probs = _softmax(lg)
    order = np.argsort(-probs, kind="stable")
    probs = probs[order]
    m = min(100, len(probs) - 1)
    n_vocab = float(len(logits))
    if m > 1:
        i = np.arange(1, m, dtype=np.float64)
        t = (i + 2) / (i + 1)
        b = probs[:m - 1] / np.maximum(probs[1:m], 1e-30)
        s_hat = np.sum(np.log(t) * np.log(np.maximum(b, 1e-30))) / max(np.sum(np.log(t) ** 2), 1e-9)
    else:
        s_hat = 1.0
    eps = s_hat - 1.0
    k = int(((eps * (2.0 ** state.mirostat_mu)) / (1.0 - n_vocab ** -eps)) ** (1.0 / max(s_hat, 1e-6)))
    k = max(1, min(k, len(probs)))
    kept = probs[:k] / probs[:k].sum()
    idx = state.rng.choice(k, p=kept)
    tok = int(order[idx])
    surprise = -np.log2(max(probs[idx], 1e-30))
    state.mirostat_mu -= p.mirostat_eta * (surprise - p.mirostat_tau)
    return tok, Candidates(order[:k], kept)


def _mirostat_v2(state: SamplerState, logits: np.ndarray) -> tuple[int, Candidates]:
    """ref: llama_sample_token_mirostat_v2."""
    p = state.params
    if state.mirostat_mu == 0.0:
        state.mirostat_mu = 2.0 * p.mirostat_tau
    lg = logits / p.temp
    probs = _softmax(lg)
    order = np.argsort(-probs, kind="stable")
    probs = probs[order]
    surprises = -np.log2(np.maximum(probs, 1e-30))
    mask = surprises <= state.mirostat_mu
    if not mask.any():
        mask[0] = True
    kept = probs[mask] / probs[mask].sum()
    idx = state.rng.choice(int(mask.sum()), p=kept)
    tok = int(order[mask][idx])
    surprise = surprises[mask][idx]
    state.mirostat_mu -= p.mirostat_eta * (surprise - p.mirostat_tau)
    return tok, Candidates(order[mask], kept)
