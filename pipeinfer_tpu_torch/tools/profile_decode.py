"""Where the decode time goes on the card: torch.profiler over the port's
plain greedy decode and a device-corrected controller run of the bench pair.

    python -m pipeinfer_tpu_torch.tools.profile_decode [--scale 7b] [--tokens 32]

For each of the two phases it first times the phase with the profiler off
(tok/s), then again under the profiler, and reports the device's busy
share (union of kernel intervals over the profiled wall time), kernel
launches and kernel time per token, and the kernels that took the most
device time. Needs one CUDA card; writes chiprun_out/profile_decode.json.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

from ..models import load_model
from ..runtime.context import Batch, InferenceContext
from ..sampling.samplers import SamplingParams
from ..spec.controller import PipeInferController
from ..spec.params import SpecParams
from .benchpair import cached_bench_pair

ROOT = Path(__file__).resolve().parents[2]


def _kernel_stats(prof) -> tuple[float, int, dict[str, list[float]]]:
    """(busy µs as the union of kernel intervals, kernel count, per-name
    [count, total µs]) from a profiler's device events."""
    spans, by_name = [], defaultdict(lambda: [0, 0.0])
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t0, t1 = e.time_range.start, e.time_range.end
        spans.append((t0, t1))
        by_name[e.name][0] += 1
        by_name[e.name][1] += t1 - t0
    busy, end = 0.0, -1.0
    for t0, t1 in sorted(spans):
        if t1 <= end:
            continue
        busy += t1 - max(t0, end)
        end = t1
    return busy, len(spans), dict(by_name)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", default="7b")
    ap.add_argument("--qtype", default="Q4_K")
    ap.add_argument("--eps", type=float, default=0.02)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_decode: no CUDA device", file=sys.stderr)
        return 2

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    t_path, d_path = cached_bench_pair(ROOT / "build" / "bench", args.scale, args.qtype, args.eps)
    tparams, tcfg = load_model(t_path)
    dparams, dcfg = load_model(d_path)
    prompt = [1] + np.random.default_rng(1234).integers(3, tcfg.n_vocab, 31).tolist()
    greedy = SamplingParams(temp=0.0, penalty_repeat=1.0, penalty_last_n=0)
    sp = SpecParams(n_draft=8, n_parallel=1, p_accept=0.1, p_split=0.9, max_inflight=4)
    n = args.tokens

    def plain():
        """Prefill, then return the timed part: n greedy tokens in the
        device-resident chain (one fetch at the end waits for the device)."""
        ctx = InferenceContext(tparams, tcfg, n_cells=1024)
        b = Batch()
        for i, t in enumerate(prompt):
            b.add(t, i, 0, want_logits=(i == len(prompt) - 1))
        first = int(np.argmax(ctx.decode(b)[-1]))
        torch.cuda.synchronize()
        return lambda: len(ctx.draft_chain(first, len(prompt), 0, n, n_cand=0)[0])

    def controller():
        c = PipeInferController(InferenceContext(tparams, tcfg, n_cells=1024),
                                InferenceContext(dparams, dcfg, n_cells=1024),
                                greedy, sp, eos_id=-1)
        return lambda: len(c.generate(list(prompt), n, ignore_eos=True))  # with prefill

    def timed(run):
        t0 = time.perf_counter()
        toks = run()
        return time.perf_counter() - t0, toks

    report = dict(card=card, scale=args.scale, qtype=args.qtype, eps=args.eps, tokens=n,
                  torch=torch.__version__, cuda=torch.version.cuda, phases={})
    print(f"card: {card}", flush=True)
    for name, setup in (("plain", plain), ("controller", controller)):
        setup()()  # warm-up
        wall, toks = timed(setup())
        run = setup()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            p_wall, p_toks = timed(run)
        busy, n_k, by_name = _kernel_stats(prof)
        top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[: args.top]
        ph = dict(tok_s=toks / wall, wall_s=wall, tokens=toks, profiled_wall_s=p_wall,
                  busy_share=busy / 1e6 / p_wall, kernels_per_token=n_k / p_toks,
                  kernel_ms_per_token=busy / 1e3 / p_toks,
                  top=[dict(name=k, count=c, ms=us / 1e3) for k, (c, us) in top])
        report["phases"][name] = ph
        print(f"[{name}] {toks} tokens at {ph['tok_s']:.1f} tok/s (profiler off); profiled: "
              f"device busy {100 * ph['busy_share']:.1f}% of {p_wall:.3f} s, "
              f"{ph['kernels_per_token']:.0f} kernels and {ph['kernel_ms_per_token']:.3f} ms "
              f"of kernel time per token", flush=True)
        for row in ph["top"]:
            print(f"    {row['ms']:9.3f} ms  {row['count']:6d}x  {row['name'][:100]}")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "profile_decode.json").write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
