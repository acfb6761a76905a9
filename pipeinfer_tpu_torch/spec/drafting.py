"""Draft-tree generation, shared by the sync baseline and the async
PipeInfer controller.

Re-implementation of the reference's tree drafting
(ref: examples/speculative/speculative.cpp:957-1104): at each depth every
drafting branch samples the draft model ("greedy with probs" when the main
chain is deterministic, ref temp<0 mode sampling.cpp:172-175), stops when
the top candidate's probability falls below p_accept (+ adaptive p_adjust),
splits new branches on runner-up candidates above p_split, and appends
chosen tokens to both the draft batch (synchronously decoded per depth) and
the accumulating target batch (tree-positions + per-token branch seq lists).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..runtime.context import Batch, CacheFull, InferenceContext
from ..sampling.samplers import SamplerState, sample_with_candidates
from .params import SpecParams


@dataclasses.dataclass
class DraftBranch:
    """ref: seq_draft (speculative.cpp:16-28)."""

    active: bool = False
    drafting: bool = False
    skip: bool = False
    i_batch_dft: int = 0
    i_batch_tgt: list[int] = dataclasses.field(default_factory=list)
    tokens: list[int] = dataclasses.field(default_factory=list)
    prefix_tokens: list[int] = dataclasses.field(default_factory=list)
    sampler: SamplerState | None = None

    def copy(self) -> "DraftBranch":
        return DraftBranch(
            active=self.active,
            drafting=self.drafting,
            skip=self.skip,
            i_batch_dft=self.i_batch_dft,
            i_batch_tgt=list(self.i_batch_tgt),
            tokens=list(self.tokens),
            prefix_tokens=list(self.prefix_tokens),
            sampler=self.sampler.copy() if self.sampler else None,
        )


def new_branches(n: int, sampler_proto: SamplerState) -> list[DraftBranch]:
    return [DraftBranch(sampler=sampler_proto.copy()) for _ in range(n)]


def _chain_samp(params) -> tuple | None:
    """(temp, top_k, top_p, min_p) for ON-DEVICE chain sampling, or None
    when the sampler chain needs host-side features (penalties window,
    mirostat state, logit bias). Greedy (temp<0 "greedy with probs") is
    handled separately — the chain program's argmax."""
    no_pen = params.penalty_last_n == 0 or (
        params.penalty_repeat == 1.0
        and params.penalty_freq == 0.0
        and params.penalty_present == 0.0
    )
    if params.temp <= 0 or not no_pen or params.mirostat != 0 or params.logit_bias:
        return None
    return (float(params.temp), int(params.top_k),
            float(params.top_p), float(params.min_p))


def draft_tree(
    ctx_dft: InferenceContext,
    sp: SpecParams,
    branches: list[DraftBranch],
    root_token: int,
    root_logits: np.ndarray | None,
    *,
    seq_offset: int,
    dft_base: int,  # draft-side position of the root token's slot
    tgt_base: int,  # target-side position where drafted tokens start
    batch_tgt: Batch,
    p_adjust: float = 0.0,
    topk: int | None = None,
    seed: int = 0,  # keys on-device stochastic chain draws
) -> tuple[int, np.ndarray | None]:
    """Grow a draft tree from `root_token`.

    `root_logits` are the draft model's logits for the position *after*
    the root token, if already available; otherwise the root token is
    decoded first. Fills `batch_tgt` with tree tokens at positions
    tgt_base+depth on seqs seq_offset+branch. Returns (n_drafted,
    last draft logits of branch 0).
    """
    n_par = sp.n_parallel

    for s in range(n_par):
        branches[s].active = False
        branches[s].drafting = False
        branches[s].skip = True
        branches[s].tokens.clear()
        branches[s].i_batch_tgt.clear()
    root = branches[0]
    root.active = True
    root.drafting = True
    root.skip = False
    root.tokens.append(root_token)  # chained token; erased before launch

    # fast path: single-branch chains run entirely ON DEVICE (one dispatch
    # + one fetch instead of a host round trip per depth) — the decisive
    # optimization when per-call latency dominates (TPU tunnels). Greedy
    # chains use the program's argmax; temp>0 samplers without host-side
    # state (penalties/mirostat/bias) draft via the on-device Gumbel chain,
    # so staged/DCN-target speculation keeps the one-dispatch shape in the
    # common serving regime too (ref: the per-depth draft loop this
    # replaces, speculative.cpp:957-1104).
    samp = None
    if root.sampler is not None and root.sampler.params.temp > 0:
        samp = _chain_samp(root.sampler.params)
    if (
        n_par == 1
        and root_logits is None
        and root.sampler is not None
        and (root.sampler.params.temp < 0 or samp is not None)
        and root.sampler.grammar is None
        and hasattr(ctx_dft, "draft_chain")
    ):
        try:
            tokens, cands = ctx_dft.draft_chain(
                root_token, dft_base, seq_offset, sp.n_draft,
                samp=samp, seed=seed,
            )
        except CacheFull:
            # cache full: skip this speculation. Only CacheFull: any other
            # error (a kernel that fails to build or launch) ends the run
            # instead of passing for "no speculation"
            return 0, None
        for i, (tok, cand) in enumerate(zip(tokens, cands)):
            if cand.probs()[0] < sp.p_accept + p_adjust:
                break
            root.sampler.accept(tok)
            root.tokens.append(tok)
            root.i_batch_tgt.append(len(batch_tgt))
            batch_tgt.add(tok, tgt_base + i, [seq_offset], want_logits=True)
        return len(root.tokens) - 1, None

    batch_dft = Batch()
    if root_logits is None:
        batch_dft.add(root_token, dft_base, seq_offset, want_logits=True)
        logits = ctx_dft.decode(batch_dft, topk)
        cur_logits = {0: logits[0]}
        batch_dft.clear()
    else:
        cur_logits = {0: root_logits}

    n_drafted = 0
    n_branches = 0  # splits so far (ref n_seq_cur)
    max_ran_seq = 0
    n_past_cur = dft_base + 1  # next draft-side position to write

    for depth in range(sp.n_draft):
        batch_dft.clear()
        for s in range(max_ran_seq + 1):
            br = branches[s]
            if not br.drafting or br.skip:
                continue
            tok, cand = sample_with_candidates(br.sampler, cur_logits[s])
            del tok  # drafting picks from candidates explicitly below

            if cand.probs[0] < sp.p_accept + p_adjust:
                br.drafting = False
                continue

            chosen = [s]
            # split on strong runner-up candidates (ref :1009-1051)
            for f in range(1, min(8, len(cand.probs))):
                if n_branches < n_par - 1 and cand.probs[f] > sp.p_split + p_adjust:
                    n_branches += 1
                    nb = branches[n_branches]
                    nb.active = True
                    nb.drafting = True
                    nb.skip = False
                    nb.tokens = list(br.tokens)
                    nb.i_batch_tgt = list(br.i_batch_tgt)
                    nb.sampler = br.sampler.copy()
                    # share the draft-side prefix cells
                    ctx_dft.seq_rm(n_branches + seq_offset, dft_base, n_past_cur)
                    ctx_dft.seq_cp(s + seq_offset, n_branches + seq_offset, dft_base, n_past_cur)
                    # prefix tokens in the target batch belong to the new
                    # branch too
                    for t_idx in range(len(batch_tgt)):
                        if s + seq_offset in batch_tgt.seqs[t_idx]:
                            batch_tgt.add_seq_to(t_idx, n_branches + seq_offset)
                    chosen.append(n_branches)
                else:
                    break

            for rank, sb in enumerate(chosen):
                tok_id = int(cand.ids[rank])
                b2 = branches[sb]
                b2.sampler.accept(tok_id)
                b2.tokens.append(tok_id)
                b2.i_batch_tgt.append(len(batch_tgt))
                batch_tgt.add(tok_id, tgt_base + depth, [sb + seq_offset], want_logits=True)
                b2.i_batch_dft = len(batch_dft)
                batch_dft.add(tok_id, n_past_cur, sb + seq_offset, want_logits=True)
                if len(batch_tgt) > sp.n_draft:
                    b2.drafting = False

        if len(batch_dft) == 0:
            break
        logits = ctx_dft.decode(batch_dft, topk)
        for s in range(n_par):
            if branches[s].drafting and not branches[s].skip:
                cur_logits[s] = logits[branches[s].i_batch_dft]
        n_past_cur += 1
        n_drafted += len(batch_dft)
        max_ran_seq = n_branches
        if len(batch_tgt) > sp.n_draft:
            break

    return n_drafted, cur_logits.get(0)
