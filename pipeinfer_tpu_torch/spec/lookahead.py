"""Lookahead decoding: model-free speculation via Jacobi iteration + n-gram
verification (ref: examples/lookahead/lookahead.cpp, after the lmsys
lookahead-decoding blog). No draft model: a W-wide window of N-1 Jacobi
levels free-runs alongside the committed stream, its trajectories feed a
per-first-token n-gram pool (vocab × G ring buffers), and every step the
pool's n-grams for the current token are verified in the same batch.

Sequence layout per decode step (one batch, one device dispatch — the same
cell/seq-bitmask tree attention the PipeInfer controller uses):
  seq 0          — the committed stream (input token joins ALL seqs)
  seq 1..W       — lookahead diagonals
  seq W+1..W+G   — verification n-grams
Every step ends with `rm_tail(n_past)` so the scratch cells vanish without
fragmentation; an accepted n-gram's cells survive via seq_keep + re-share.

Copy of pipeinfer_tpu.spec.lookahead over the port's contexts: it runs on
an InferenceContext or a StagedInferenceContext (parallel/stages.py), which
carry the same decode and seq-op surface.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from ..runtime.context import Batch, InferenceContext
from ..sampling.samplers import SamplerState, SamplingParams, sample


@dataclasses.dataclass
class LookaheadStats:
    n_predict: int = 0
    n_accept: int = 0  # tokens accepted from verification n-grams
    t_decode_s: float = 0.0


class LookaheadDecoder:
    def __init__(
        self,
        ctx: InferenceContext,  # or a StagedInferenceContext
        sampling: SamplingParams,
        *,
        W: int = 15,  # lookahead window (ref :44)
        N: int = 5,  # n-gram size (ref :45)
        G: int = 15,  # max verification n-grams per token (ref :46)
        eos_id: int = 2,
        topk: int | None = None,
    ):
        if W + G + 1 > 64:
            raise ValueError("W + G + 1 sequences must fit the 64-slot bitmask")
        self.ctx = ctx
        self.sampling = sampling
        self.W, self.N, self.G = W, N, G
        self.eos_id = eos_id
        self.topk = topk
        self.stats = LookaheadStats()
        n_vocab = ctx.cfg.n_vocab
        # n-gram pool: for each first-token, a ring of G (N-1)-grams (ref
        # ngram_container :20-34)
        self.pool = np.zeros((n_vocab, G, N - 1), np.int32)
        self.pool_cnt = np.zeros(n_vocab, np.int32)
        self.pool_head = np.zeros(n_vocab, np.int32)

    def generate(self, prompt_ids, n_predict, *, ignore_eos=False, stream=None):
        ctx, W, N, G = self.ctx, self.W, self.N, self.G
        sampler = SamplerState(params=self.sampling)
        for t in prompt_ids:
            sampler.accept(t, apply_grammar=False)

        b = Batch()
        for i, t in enumerate(prompt_ids):
            b.add(t, i, 0, want_logits=(i == len(prompt_ids) - 1))
        logits = ctx.decode(b, self.topk)[-1]
        for s in range(1, W + G + 1):
            ctx.seq_cp(0, s)

        n_past = len(prompt_ids)
        out: list[int] = []

        # Jacobi window levels [N-1][W], seeded deterministically from the
        # prompt (the reference seeds "100 + i"; any init works — the window
        # self-corrects within a few iterations)
        tokens_j = [
            [int(prompt_ids[(j * W + i) % len(prompt_ids)]) for i in range(W)]
            for j in range(N - 1)
        ]

        # first token comes straight from the prefill logits (ref :162-173)
        tok = sample(sampler, logits)
        sampler.accept(tok)
        out.append(tok)
        if stream:
            stream(tok)
        self.stats.n_predict += 1
        t0 = time.perf_counter()
        done = (not ignore_eos and tok == self.eos_id) or len(out) >= n_predict

        while not done:
            b.clear()
            all_seqs = list(range(W + G + 1))
            b.add(tok, n_past, all_seqs, want_logits=True)

            # verification n-grams for the current token (ref :210-235)
            g_cur = int(self.pool_cnt[tok])
            ng_tokens = [[tok] for _ in range(g_cur)]
            ng_idx = [[0] for _ in range(g_cur)]
            for j in range(N - 1):
                for g in range(g_cur):
                    t = int(self.pool[tok, g, j])
                    ng_tokens[g].append(t)
                    ng_idx[g].append(len(b))
                    b.add(t, n_past + j + 1, [W + 1 + g], want_logits=True)

            # lookahead level 0 rows i=1..W-1 on seqs {i+1..W} (ref :238-246)
            for i in range(1, W):
                b.add(tokens_j[0][i], n_past + i, list(range(i + 1, W + 1)))
            # levels 1..N-2 on seq {i+1}; last level produces logits
            last_idx = []
            for j in range(1, N - 1):
                for i in range(W):
                    if j == N - 2:
                        last_idx.append(len(b))
                    b.add(tokens_j[j][i], n_past + j + i, [i + 1],
                          want_logits=(j == N - 2))

            logits = ctx.decode(b, self.topk)

            active = list(range(g_cur))
            seq_best = 0
            for v in range(N):
                if v > 0:
                    if not active:
                        break
                    g = active[0]
                    i_batch = ng_idx[g][v]
                    seq_best = W + 1 + g
                    self.stats.n_accept += 1
                else:
                    i_batch = 0

                tok = sample(sampler, logits[i_batch])
                sampler.accept(tok)
                out.append(tok)
                if stream:
                    stream(tok)
                self.stats.n_predict += 1
                n_past += 1
                if (not ignore_eos and tok == self.eos_id) or len(out) >= n_predict:
                    done = True
                    break

                # keep only n-grams whose next token matches (ref :319-329)
                if v == N - 1:
                    active = []
                else:
                    active = [g for g in active if ng_tokens[g][v + 1] == tok]

                # Jacobi update: shift levels up; refresh the last level from
                # its own logits on the first pass (ref :352-380)
                prev_level0 = list(tokens_j[0])
                for j in range(N - 2):
                    tokens_j[j] = tokens_j[j + 1]
                if v == 0:
                    guess = sampler.copy()
                    tokens_j[N - 2] = [
                        sample(guess, logits[last_idx[i]]) for i in range(W)
                    ]
                else:
                    tokens_j[N - 2] = list(tokens_j[0])

                # harvest window trajectories into the n-gram pool (ref :383-425)
                if v == 0:
                    for f in range(W):
                        ft = prev_level0[f]
                        ngram = [tokens_j[j][f] for j in range(N - 1)]
                        known = self.pool[ft, : self.pool_cnt[ft], :]
                        if any((row == ngram).all() for row in known):
                            continue
                        head = int(self.pool_head[ft])
                        self.pool[ft, head, :] = ngram
                        self.pool_cnt[ft] = min(G, int(self.pool_cnt[ft]) + 1)
                        self.pool_head[ft] = (head + 1) % G

            # KV management (ref :441-458): drop all scratch cells past the
            # committed frontier; keep an accepted n-gram's cells on seq 0
            ctx.rm_tail(n_past)
            if seq_best != 0:
                ctx.seq_keep(seq_best)
                ctx.seq_cp(seq_best, 0)
                ctx.seq_rm(seq_best)
                for s in range(1, W + G + 1):
                    ctx.seq_cp(0, s)

        self.stats.t_decode_s = time.perf_counter() - t0
        return out
