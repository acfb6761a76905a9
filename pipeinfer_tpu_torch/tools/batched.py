"""`python -m pipeinfer_tpu_torch.tools.batched` — N parallel continuations
of one prompt in a single batch (ref: examples/batched/batched.cpp): the
prompt is prefilled once on sequence 0, shared to sequences 1..N-1
zero-copy via the cell seq-bitmask (the counterpart of
llama_kv_cache_seq_cp), then every step decodes one token per live
sequence in one batch.

Torch counterpart of pipeinfer_tpu.tools.batched."""

from __future__ import annotations

import argparse
import dataclasses
import sys

from ..cli.args import add_model_args, add_sampling_args, read_prompt, sampling_from_args
from ..cli.main import build_context
from ..runtime.context import Batch
from ..sampling.samplers import SamplerState, sample


def batched_generate(ctx, prompt_ids, n_predict: int, n_parallel: int,
                     sampling, eos_id: int = -1) -> list[list[int]]:
    """Decode n_parallel continuations; returns per-sequence token lists."""
    b = Batch()
    for i, t in enumerate(prompt_ids):
        b.add(t, i, 0, want_logits=(i == len(prompt_ids) - 1))
    logits0 = ctx.decode(b)[-1]
    # share the prefix cells with every other sequence (zero-copy bit-OR)
    for s in range(1, n_parallel):
        ctx.seq_cp(0, s, 0, len(prompt_ids))

    # decorrelate parallel streams: each sequence gets its own RNG stream
    # (seed+s when seeded, so runs stay reproducible)
    samplers = [
        SamplerState(
            params=dataclasses.replace(
                sampling, seed=sampling.seed + s if sampling.seed >= 0 else -1
            )
        )
        for s in range(n_parallel)
    ]
    for st in samplers:
        for t in prompt_ids:
            st.accept(t, apply_grammar=False)
    outs: list[list[int]] = [[] for _ in range(n_parallel)]
    alive = list(range(n_parallel))
    cur = {s: logits0 for s in alive}
    n_past = len(prompt_ids)
    for _ in range(n_predict):
        b.clear()
        idx = {}
        next_alive = []
        for s in alive:
            t = sample(samplers[s], cur[s])
            samplers[s].accept(t)
            outs[s].append(t)
            if t == eos_id:
                ctx.seq_rm(s)  # clears only this seq's bit; shared prefix
                continue       # cells stay for the others
            idx[s] = len(b)
            b.add(t, n_past, s, want_logits=True)
            next_alive.append(s)
        alive = next_alive
        if not alive:
            break
        logits = ctx.decode(b)
        cur = {s: logits[idx[s]] for s in alive}
        n_past += 1
    return outs


def main(argv=None):
    p = argparse.ArgumentParser("pipeinfer-batched", description=__doc__.split("\n\n")[0])
    add_model_args(p)
    add_sampling_args(p)
    p.add_argument("-p", "--prompt", default="Hello my name is")
    p.add_argument("-f", "--file", default=None, help="read prompt from file")
    p.add_argument("-n", "--n-predict", type=int, default=32)
    p.add_argument("-np", "--n-parallel", type=int, default=4)
    args = p.parse_args(argv)

    ctx, tok = build_context(args.model, args.ctx_size, args.cache_dtype, device=args.device)
    ids = tok.encode(read_prompt(args), add_bos=True)
    outs = batched_generate(ctx, ids, args.n_predict, args.n_parallel,
                            sampling_from_args(args), eos_id=tok.vocab.eos_id)
    print(tok.decode(ids))
    for s, toks in enumerate(outs):
        print(f"\n== sequence {s} ==\n{tok.decode(toks)}")
    ctx.print_timings(lambda s: print(s, file=sys.stderr))
    return 0


if __name__ == "__main__":
    sys.exit(main())
