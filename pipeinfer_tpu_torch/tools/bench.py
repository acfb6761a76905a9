"""`python -m pipeinfer_tpu_torch.tools.bench` — model micro-benchmark
(ref: examples/llama-bench/llama-bench.cpp): prefill (pp) and generation
(tg) throughput over configurable sizes, markdown or JSON output.

Torch counterpart of pipeinfer_tpu.tools.bench: each rep's wall time runs
from the dispatch to the host fetch of the step's (sparse) logits."""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from ..cli.main import build_context
from ..runtime.context import Batch


def bench_pp(ctx, n_tokens: int, reps: int = 3, topk: int | None = 64) -> float:
    rng = np.random.default_rng(0)
    best = 0.0
    for _ in range(reps):
        ctx.clear_cache()
        toks = rng.integers(4, ctx.cfg.n_vocab - 1, n_tokens)
        b = Batch()
        for i, t in enumerate(toks):
            b.add(int(t), i, 0, want_logits=(i == n_tokens - 1))
        t0 = time.perf_counter()
        ctx.decode(b, topk)
        dt = time.perf_counter() - t0
        best = max(best, n_tokens / dt)
    return best


def bench_tg(ctx, n_tokens: int, reps: int = 3, topk: int | None = 64) -> float:
    best = 0.0
    for _ in range(reps):
        ctx.clear_cache()
        b = Batch()
        b.add(1, 0, 0)
        out = ctx.decode(b, topk)
        t0 = time.perf_counter()
        for i in range(n_tokens):
            row = out[0]
            tok = int(row.ids[0]) if hasattr(row, "ids") else int(np.argmax(row))
            b.clear()
            b.add(tok, i + 1, 0)
            out = ctx.decode(b, topk)
        dt = time.perf_counter() - t0
        best = max(best, n_tokens / dt)
    return best


def main(argv=None):
    p = argparse.ArgumentParser("pipeinfer-bench", description=__doc__.split("\n\n")[0])
    p.add_argument("-m", "--model", required=True)
    p.add_argument("-pp", "--prompt-sizes", default="128,512", help="prefill sizes")
    p.add_argument("-tg", "--gen-sizes", default="64", help="generation lengths")
    p.add_argument("-r", "--reps", type=int, default=3)
    p.add_argument("-o", "--output", choices=["md", "json"], default="md")
    p.add_argument("-c", "--ctx-size", type=int, default=2048)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)

    ctx, _ = build_context(args.model, args.ctx_size, need_tokenizer=False, device=args.device)
    rows = []
    for n in [int(x) for x in args.prompt_sizes.split(",") if x]:
        tps = bench_pp(ctx, n, args.reps)
        rows.append({"test": f"pp{n}", "t/s": round(tps, 2)})
    for n in [int(x) for x in args.gen_sizes.split(",") if x]:
        tps = bench_tg(ctx, n, args.reps)
        rows.append({"test": f"tg{n}", "t/s": round(tps, 2)})

    if args.output == "json":
        print(json.dumps({"model": args.model, "results": rows}))
    else:
        print("| test | t/s |")
        print("|------|-----|")
        for r in rows:
            print(f"| {r['test']} | {r['t/s']} |")
    return 0


if __name__ == "__main__":
    sys.exit(main())
