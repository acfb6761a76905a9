"""`python -m pipeinfer_tpu_torch.tools.batched_bench` — batched decoding
throughput grid (ref: examples/batched-bench/batched-bench.cpp): for every
(pp, tg, pl) combination, prefill `pl` sequences of `pp` dummy tokens
(shared prompt, like the reference's `is_pp_shared` mode — or independent
with --no-share), then decode `tg` steps of `pl` tokens each, and report
S_PP/S_TG/S (t/s) in the reference's markdown table format.

Torch counterpart of pipeinfer_tpu.tools.batched_bench."""

from __future__ import annotations

import argparse
import sys
import time

from ..cli.args import add_model_args
from ..cli.main import build_context
from ..runtime.context import Batch


def _ints(s: str) -> list[int]:
    return [int(x) for x in s.split(",") if x]


def run_cell(ctx, pp: int, tg: int, pl: int, share_pp: bool) -> tuple[float, float]:
    """Returns (t_prefill_s, t_gen_s)."""
    ctx.clear_cache()
    b = Batch()
    t0 = time.perf_counter()
    if share_pp:
        for i in range(pp):
            b.add(0, i, 0, want_logits=(i == pp - 1))
        ctx.decode(b)
        for s in range(1, pl):
            ctx.seq_cp(0, s, 0, pp)
    else:
        for s in range(pl):
            b.clear()
            for i in range(pp):
                b.add(0, i, s, want_logits=(i == pp - 1))
            ctx.decode(b)
    t_pp = time.perf_counter() - t0

    t0 = time.perf_counter()
    for step in range(tg):
        b.clear()
        for s in range(pl):
            b.add(0, pp + step, s, want_logits=True)
        ctx.decode(b)
    t_tg = time.perf_counter() - t0
    return t_pp, t_tg


def grid(ctx, pps, tgs, pls, share_pp: bool, out=print) -> list[dict]:
    """Run every (pp, tg, pl) cell after one warm-up cell and print the
    reference's table through `out`; returns the rows."""
    run_cell(ctx, min(pps), 2, min(pls), share_pp)  # warm-up
    out("| PP | TG | B | N_KV | T_PP s | S_PP t/s | T_TG s | S_TG t/s | T s | S t/s |")
    out("|----|----|---|------|--------|----------|--------|----------|-----|-------|")
    rows = []
    for pp in pps:
        for tg in tgs:
            for pl in pls:
                t_pp, t_tg = run_cell(ctx, pp, tg, pl, share_pp)
                n_pp = pp if share_pp else pp * pl
                n_kv = n_pp + pl * tg
                s_pp = n_pp / t_pp if t_pp > 0 else 0.0
                s_tg = pl * tg / t_tg if t_tg > 0 else 0.0
                t_all = t_pp + t_tg
                s_all = (n_pp + pl * tg) / t_all if t_all > 0 else 0.0
                out(f"| {pp} | {tg} | {pl} | {n_kv} | {t_pp:.3f} | {s_pp:.2f} "
                    f"| {t_tg:.3f} | {s_tg:.2f} | {t_all:.3f} | {s_all:.2f} |")
                rows.append(dict(pp=pp, tg=tg, pl=pl, n_kv=n_kv, t_pp=t_pp, s_pp=s_pp,
                                 t_tg=t_tg, s_tg=s_tg, t=t_all, s=s_all))
    return rows


def main(argv=None):
    p = argparse.ArgumentParser("pipeinfer-batched-bench", description=__doc__.split("\n\n")[0])
    add_model_args(p)
    p.add_argument("-pp", "--pp", default="128", help="prompt lengths, comma-separated")
    p.add_argument("-tg", "--tg", default="32", help="generation lengths, comma-separated")
    p.add_argument("-pl", "--pl", default="1,2,4", help="parallel sequence counts")
    p.add_argument("--no-share", action="store_true",
                   help="independent prompts per sequence (default: shared)")
    args = p.parse_args(argv)

    pps, tgs, pls = _ints(args.pp), _ints(args.tg), _ints(args.pl)
    need = max(pp + tg + 8 for pp in pps for tg in tgs) * (
        max(pls) if args.no_share else 1
    ) + max(pls) * max(tgs)
    ctx, _ = build_context(args.model, max(args.ctx_size, need),
                           args.cache_dtype, need_tokenizer=False, device=args.device)
    grid(ctx, pps, tgs, pls, not args.no_share)
    return 0


if __name__ == "__main__":
    sys.exit(main())
