"""Find an open-loop mix's knee once, by a sweep on the chip: in one
process, a window at each offered rate (drained until idle before the
next), with the rate the system completed beside the offered one.

    python3 -m portbench.sweep --workload mpt7b_q4km.greedy_open \
        --rates 0.5,1,1.5,2,3 --seconds 30

The knee is the highest rate whose window completes what it offered (every
request due in it served within the drain, output tokens per second at the
offered rate) with TTFT that does not grow across the window.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys

import numpy as np

from .run import Built, Window, _set_env


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=30)
    ap.add_argument("--seed", type=int, default=4200000000)
    args = ap.parse_args(argv)
    _set_env()
    from .cell import Cell, benchmark

    cell = Cell(benchmark(), args.workload)

    def log(*a):
        print(*a, file=sys.stderr, flush=True)

    b = Built(cell, "cuda", log)
    for rate in map(float, args.rates.split(",")):
        mix = copy.deepcopy(cell.mix)
        mix["rate_rps"] = rate
        w = Window(b, mix, args.seed, args.seconds, False, log, until_idle=True)
        due = sorted(w.due, key=lambda tr: tr.due)
        ttft = [(tr.stamps[0] if tr.stamps else w.t_end) - tr.due for tr in due]
        half = len(ttft) // 2
        offered = sum(tr.planned.n_predict for tr in due) / args.seconds
        print(json.dumps(dict(rate=rate, due=len(due), failed=w.failed,
                              offered_tok_s=offered, **w.e2e,
                              ttft_first_half_ms=1e3 * float(np.median(ttft[:half])) if half else None,
                              ttft_second_half_ms=1e3 * float(np.median(ttft[half:])) if half else None,
                              drain_s=w.t_end - w.t_close)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
