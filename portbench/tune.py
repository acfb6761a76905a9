"""The weight design's readings, for choosing a configuration's gains: for
each output gain and head margin, what the plain reference (no program)
gives on random prompts.

    python3 -m portbench.tune --config mpt7b_q4km --gains 0.05,0.1,0.2 \
        --margins 0.1,0.15,0.2 [--prompts 4 --length 384]

Per gain: the residual's growth over the embedding and the largest and
smallest relative update a layer makes. Per (gain, margin): the share of
positions whose greedy token is the margin's (perm[t]), the draft's greedy
agreement with the target, and the share of positions whose two best
logits lie within 0.05, 0.2 and 1.0 of each other.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
from pathlib import Path

import numpy as np
import torch

from . import weights
from .reference.model import Reference

HERE = Path(__file__).resolve().parent


def readings(conf: dict, device, prompts: list) -> dict:
    mb = weights.make_bytes(conf, device)
    tgt, dft = Reference(mb, device, stated=False), Reference(mb, device, stated=False, draft=True)
    out = dict(margin=[], agree=[], close=[], growth=[], upd_max=0.0, upd_min=1e9)
    for p in prompts:
        hs = tgt.hidden_trace(p)
        base = hs[0].norm(dim=1)
        out["growth"].append(float(((hs[-1] - hs[0]).norm(dim=1) / base).mean()))
        for a, b in zip(hs[:-1], hs[1:]):
            u = float(((b - a).norm(dim=1) / a.norm(dim=1)).mean())
            out["upd_max"], out["upd_min"] = max(out["upd_max"], u), min(out["upd_min"], u)
        lg = tgt.logits(p)
        top2 = lg.topk(2, dim=1).values
        gap = (top2[:, 0] - top2[:, 1]).cpu().numpy()
        arg = lg.argmax(dim=1)
        tok = torch.tensor(p, device=lg.device)
        out["margin"].append(float((arg == mb.perm[tok]).float().mean()))
        out["agree"].append(float((dft.logits(p).argmax(dim=1) == arg).float().mean()))
        out["close"].append([float((gap < c).mean()) for c in (0.05, 0.2, 1.0)])
    return dict(growth=float(np.mean(out["growth"])), upd_max=out["upd_max"],
                upd_min=out["upd_min"], margin_share=float(np.mean(out["margin"])),
                draft_agree=float(np.mean(out["agree"])),
                close_005_02_1=np.mean(out["close"], axis=0).tolist())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--gains", default="0.1")
    ap.add_argument("--margins", default="0.15")
    ap.add_argument("--prompts", type=int, default=4)
    ap.add_argument("--length", type=int, default=384)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    conf = json.loads((HERE / "configs" / f"{args.config}.json").read_text())
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, conf["model"]["n_vocab"], args.length).tolist()
               for _ in range(args.prompts)]
    for gain in map(float, args.gains.split(",")):
        for margin in map(float, args.margins.split(",")):
            c = copy.deepcopy(conf)
            c["weights"].update(out_gain=gain, head_margin=margin)
            r = readings(c, args.device, prompts)
            print(json.dumps(dict(config=args.config, out_gain=gain, head_margin=margin, **r)),
                  flush=True)
            torch.cuda.empty_cache() if torch.cuda.is_available() else None
    return 0


if __name__ == "__main__":
    sys.exit(main())
