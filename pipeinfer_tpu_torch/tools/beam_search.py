"""`python -m pipeinfer_tpu_torch.tools.beam_search` — beam-search decoding
(ref: examples/beam-search): beams live on KV sequence slots; surviving
beams re-share their parent's cells via seq_cp (zero-copy), dead beams
roll back via seq_rm — the same cache machinery speculation uses.

Torch counterpart of pipeinfer_tpu.tools.beam_search."""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..runtime.context import Batch, InferenceContext


def beam_search(
    ctx: InferenceContext,
    prompt_ids: list[int],
    n_predict: int,
    *,
    n_beams: int = 4,
    eos_id: int = 2,
    topk: int | None = 64,
) -> list[tuple[float, list[int]]]:
    """Returns beams as (logprob, tokens), best first."""
    b = Batch()
    for i, t in enumerate(prompt_ids):
        b.add(t, i, 0, want_logits=(i == len(prompt_ids) - 1))
    logits = ctx.decode(b, topk)[-1]
    n_past = len(prompt_ids)

    # fan the prompt out to every beam seq
    for s in range(1, n_beams):
        ctx.seq_cp(0, s, 0, n_past)

    def logprobs(row):
        if hasattr(row, "ids"):  # SparseLogits
            return row.ids, row.vals - row.lse
        lp = row - np.logaddexp.reduce(row)
        ids = np.argsort(-lp)[: max(64, n_beams * 4)]
        return ids, lp[ids]

    ids, lps = logprobs(logits)
    order = np.argsort(-lps)[:n_beams]
    beams = [(float(lps[i]), [int(ids[i])], s, False) for s, i in enumerate(order)]

    for step in range(1, n_predict):
        live = [bm for bm in beams if not bm[3]]
        if not live:
            break
        batch = Batch()
        idx_of = {}
        for score, toks, seq, _ in live:
            idx_of[seq] = len(batch)
            batch.add(toks[-1], n_past, seq, want_logits=True)
        rows = ctx.decode(batch, topk)
        n_past += 1

        candidates = []  # (score, parent_beam, token)
        for bm in beams:
            score, toks, seq, done = bm
            if done:
                candidates.append((score, bm, None))
                continue
            ids, lps = logprobs(rows[idx_of[seq]])
            for i in range(min(len(ids), n_beams + 1)):
                candidates.append((score + float(lps[i]), bm, int(ids[i])))
        candidates.sort(key=lambda c: -c[0])
        winners = candidates[:n_beams]

        # reassign sequence slots: children of the same parent share cells
        old_seqs = {bm[2] for bm in beams}
        new_beams = []
        scratch = [s for s in range(2 * n_beams) if s not in old_seqs]
        assigns = []
        for score, parent, tok in winners:
            if tok is None:
                new_beams.append(parent)
                continue
            s_new = scratch.pop(0)
            ctx.seq_rm(s_new, 0, -1)
            ctx.seq_cp(parent[2], s_new, 0, n_past)
            assigns.append((score, parent[1] + [tok], s_new, tok == eos_id))
        for old in old_seqs:
            if not any(bm[2] == old for bm in new_beams):
                ctx.seq_rm(old, 0, -1)
        new_beams.extend(assigns)
        beams = new_beams

    beams.sort(key=lambda bm: -bm[0])
    return [(score, toks) for score, toks, _, _ in beams]


def main(argv=None):
    from ..cli.args import add_gen_args, add_model_args, read_prompt
    from ..cli.main import build_context

    p = argparse.ArgumentParser("pipeinfer-beam", description=__doc__.split("\n\n")[0])
    add_model_args(p)
    add_gen_args(p)
    p.add_argument("--beams", type=int, default=4)
    args = p.parse_args(argv)
    ctx, tok = build_context(args.model, args.ctx_size, args.cache_dtype, device=args.device)
    ids = tok.encode(read_prompt(args), add_bos=True)
    beams = beam_search(ctx, ids, args.n_predict, n_beams=args.beams, eos_id=tok.vocab.eos_id)
    for score, toks in beams:
        print(f"[{score:9.3f}] {tok.decode(toks)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
