"""How ``correct`` is decided for a served model: after the window, a
sample of the finished requests, drawn from the seed and holding the one
with the longest output, is run through the reference (reference/model.py)
once over each prompt with its served tokens. For each served token the gap
by which the reference's logit of that token lies below the reference's
best logit at its position is read; the widest gap over the sample is
compared with the configuration's limit. A served token that is the
reference's own argmax reads 0.

The draft chain is judged by its decisions, which the served rounds show
(``draft_gaps``): each round proposes ``n_draft`` tokens from the last
committed one, the first m of them were accepted (so each was the served
draft's argmax) and, where m < n_draft, the next served token was not the
draft's pick. The reference's draft (its lower layers and the draft's
head) runs once over each prompt with its served tokens; an accepted token
reads the gap by which its logit lies below the best, a rejected one the
margin by which its logit lies above every other. A decision that the
reference's draft shares reads 0, so a draft that skips or changes its
layers shows where its picks move. The draft's reading is logged, not
compared: at the configurations' widths the draft's head makes every pick
with or without the draft's layers, so no limit would separate the two.

The control (``control_gaps``, ``draft_control_gaps``) puts the reference,
at a lower activation precision, in the program's place: at each position
of the same prompts and served tokens it reads the gap of the token that
the lower precision puts first, or of the decision that it takes.
"""

from __future__ import annotations

import numpy as np
import torch


def sample(finished: list, seed: int, min_tokens: int, max_requests: int) -> list:
    """Requests to judge: the one with the most served tokens, then others
    in an order drawn from the seed, until `min_tokens` served tokens or
    `max_requests` requests. Each entry is (prompt ids, served ids, the
    accepted count of each round the device lanes ran for it, or None)."""
    if not finished:
        return []
    order = sorted(range(len(finished)), key=lambda i: -len(finished[i][1]))
    first, rest = order[0], order[1:]
    rng = np.random.default_rng(seed ^ 0x5EED)
    rest = [rest[i] for i in rng.permutation(len(rest))]
    out, n = [], 0
    for i in [first] + rest:
        if n >= min_tokens or len(out) >= max_requests:
            break
        out.append(finished[i])
        n += len(finished[i][1])
    return out


def _rows(prompt: list, served: list) -> tuple[list, list]:
    """The sequence to run (prompt and every served token but the last)
    and the positions whose next token was served."""
    seq = list(prompt) + list(served[:-1])
    return seq, list(range(len(prompt) - 1, len(seq)))


def served_gaps(ref, judged: list) -> np.ndarray:
    """Per served token, the reference's best logit minus its logit of the
    served token (all requests of `judged`, in order)."""
    out = []
    for prompt, served, *_ in judged:
        seq, rows = _rows(prompt, served)
        lg = ref.logits(seq, rows)
        tok = torch.tensor(served, dtype=torch.long, device=lg.device)
        out.append((lg.amax(dim=1) - lg.gather(1, tok[:, None])[:, 0]).cpu().numpy())
        del lg
    return np.concatenate(out) if out else np.zeros(0)


def control_gaps(ref, low, judged: list) -> np.ndarray:
    """Per position, the gap in the reference of the token that the
    lower-precision reference `low` puts first."""
    out = []
    for prompt, served, *_ in judged:
        seq, rows = _rows(prompt, served)
        lg = ref.logits(seq, rows)
        pick = low.logits(seq, rows).argmax(dim=1)
        out.append((lg.amax(dim=1) - lg.gather(1, pick[:, None])[:, 0]).cpu().numpy())
        del lg
    return np.concatenate(out) if out else np.zeros(0)


def draft_decisions(served: list, rounds: list, depth: int) -> tuple[list, list]:
    """(indices into `served`, accepted?) of the draft's decisions that the
    rounds show. Served token 0 comes from the prefill; a round from token
    c commits its m accepted drafts and one token of the target's; rounds
    past the last served token (a finished lane's) show nothing."""
    idx, acc, c = [], [], 1
    for m in rounds:
        if c >= len(served):
            break
        for j in range(c, min(c + m, len(served))):
            idx.append(j)
            acc.append(True)
        if m < depth and c + m < len(served):
            idx.append(c + m)
            acc.append(False)
        c += m + 1
    return idx, acc


def decision_gaps(lg: torch.Tensor, tok: torch.Tensor, accept: torch.Tensor) -> torch.Tensor:
    """Per row of logits `lg`: where `accept`, the gap of `tok` below the
    best logit; elsewhere the margin by which `tok` lies above every other
    logit, or 0."""
    lt = lg.gather(1, tok[:, None])[:, 0]
    other = lg.scatter(1, tok[:, None], float("-inf")).amax(dim=1)
    return torch.where(accept, lg.amax(dim=1) - lt, (lt - other).clamp_min(0.0))


def _draft_rows(ref_draft, judged: list, depth: int):
    """Per judged request the device lanes ran: the reference draft's
    logits at its decisions, the served tokens there and the served
    decisions."""
    for prompt, served, *rest in judged:
        rounds = rest[0] if rest else None
        if not rounds:
            continue
        idx, acc = draft_decisions(served, rounds, depth)
        if not idx:
            continue
        seq, rows = _rows(prompt, served)
        lg = ref_draft.logits(seq, [rows[j] for j in idx])
        tok = torch.tensor([served[j] for j in idx], dtype=torch.long, device=lg.device)
        yield seq, [rows[j] for j in idx], lg, tok, torch.tensor(acc, device=lg.device)


def draft_gaps(ref_draft, judged: list, depth: int) -> np.ndarray:
    """Per draft decision the served rounds show, its gap in the reference
    draft (decision_gaps)."""
    out = [decision_gaps(lg, tok, acc).cpu().numpy()
           for _, _, lg, tok, acc in _draft_rows(ref_draft, judged, depth)]
    return np.concatenate(out) if out else np.zeros(0)


def draft_control_gaps(ref_draft, low_draft, judged: list, depth: int) -> np.ndarray:
    """Per decision position, the gap in the reference draft of the
    decision that the draft `low_draft` (lower precision, or fewer layers)
    takes there: accept where the served token is its argmax."""
    out = []
    for seq, rows, lg, tok, _ in _draft_rows(ref_draft, judged, depth):
        acc = low_draft.logits(seq, rows).argmax(dim=1) == tok
        out.append(decision_gaps(lg, tok, acc).cpu().numpy())
    return np.concatenate(out) if out else np.zeros(0)
