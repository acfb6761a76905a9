"""The readings that a cell's limits are set from, in one process: for
each seed a window at the cell's own load, the widest gap of the program's
served tokens and of its draft's decisions, and the control's, the
reference at int4 activations in the program's place, on the same prompts
and tokens; for the draft also two faults, a draft that skips its upper
DRAFT_FAULT_SKIP layers and one that skips them all.

    python3 -m portbench.calibrate --workload mpt7b_q4km.greedy_open \
        --seeds 12 --seconds 20 [--first-seed 4100000000]

Prints one JSON line per seed. Windows follow each other in the one
process: requests left in flight by one window run on into the next, which
only judges what its own plan's requests finished. The program's state
stays on the card while the reference runs here (a run frees it first);
the readings are the same.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from . import check
from .run import Built, Window, _set_env, judge

DRAFT_FAULT_SKIP = 2  # layers the draft fault leaves out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first-seed", type=int, default=4100000000)
    ap.add_argument("--seconds", type=float, default=20)
    ap.add_argument("--control-seeds", type=int, default=3)
    args = ap.parse_args(argv)
    _set_env()
    from .cell import Cell, benchmark

    cell = Cell(benchmark(), args.workload)

    def log(*a):
        print(*a, file=sys.stderr, flush=True)

    b = Built(cell, "cuda", log)
    ck = cell.config["check"]
    depth = int(cell.mix["server"]["spec"]["n_draft"])

    def top(x):
        return float(x.max()) if len(x) else None

    for i in range(args.seeds):
        seed = args.first_seed + 7919 * i
        w = Window(b, cell.mix, seed, args.seconds, False, log)
        judged, ref, gaps, dgaps = judge(b.mb, w.finished, seed, ck, depth, "cuda", log)
        line = dict(workload=args.workload, seed=seed, failed=w.failed,
                    tokens=int(len(gaps)), gap_max=top(gaps), off=int((gaps > 0).sum()),
                    decisions=int(len(dgaps)), draft_gap_max=top(dgaps),
                    draft_off=int((dgaps > 0).sum()), out_tok_s=w.e2e["out_tok_s"])
        if i < args.control_seeds and judged:
            ctrl = check.control_gaps(ref, ref.with_bits(4), judged)
            rd = ref.draft()
            dctrl = check.draft_control_gaps(rd, ref.with_bits(4).draft(), judged, depth)
            dfault = check.draft_control_gaps(
                rd, ref.draft(b.mb.draft_layers - DRAFT_FAULT_SKIP), judged, depth)
            dnone = check.draft_control_gaps(rd, ref.draft(0), judged, depth)
            line.update(control_max=float(ctrl.max()), control_off=int((ctrl > 0).sum()),
                        control_p99=float(np.percentile(ctrl, 99)),
                        draft_control_max=top(dctrl), draft_control_off=int((dctrl > 0).sum()),
                        draft_fault_max=top(dfault), draft_fault_off=int((dfault > 0).sum()),
                        draft_none_max=top(dnone), draft_none_off=int((dnone > 0).sum()))
        print(json.dumps(line), flush=True)
        del ref
    return 0


if __name__ == "__main__":
    sys.exit(main())
