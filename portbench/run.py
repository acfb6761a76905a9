"""The port's benchmark: one run of one cell.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Set-up makes the cell's model pair on the
card from its configuration's weight seed (weights.py), builds the
program's contexts and its speculative scheduler, and warms them with a
fixed request set. The traffic generator (traffic.py) then loads the
scheduler from ``--seed``; after the mix's lead-in the window opens and
lasts ``--seconds``. With ``--trace 1`` the last TRACE_S seconds of the
window run under the device profiler (set up PREPARE_S seconds before,
while the engine runs on) and the per-layer metrics are reported, else the end-to-end metrics, each from what was stamped before
the window closed. Then the engine stops, the program's state is freed,
and a sample of the requests it finished is judged against the plain
reference (check.py). The last line of standard
output is the result as one JSON object; the numbers compared, each beside
its limit, are the last lines of standard error and the result's last key.

Exits 2, printing no result, without as many CUDA devices as the cell asks
for, and 3 if ``jax``, ``jaxlib``, ``flax`` or ``pipeinfer_tpu`` was
imported.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# every build and kernel cache at a fixed path inside the checkout; a
# library that would load JAX by itself is told not to
CACHE_ENV = {
    "PIPEINFER_CUDA_BUILD_DIR": ROOT / "build" / "cuda",
    "PIPEINFER_CACHE_DIR": ROOT / "build" / "portbench" / "compile",
    "TRITON_CACHE_DIR": ROOT / "build" / "portbench" / "triton",
    "TORCH_EXTENSIONS_DIR": ROOT / "build" / "portbench" / "torch_extensions",
}
FORBIDDEN = ("jax", "jaxlib", "flax", "pipeinfer_tpu")
WARM_REQUESTS, WARM_TOKENS = 2, 40  # the warm-up: two prompts of the mix's median length
TRACE_S = 4.0  # the traced slice at the window's end
PREPARE_S = 6.0  # the profiler's set-up starts this long before the slice
EXTEND_S = 20.0  # the most a slice runs on past TRACE_S while it holds no lane step
DRAIN_S = 120.0  # the tools' wait for what is in flight after a window


def _set_env() -> None:
    for k, v in CACHE_ENV.items():
        os.environ[k] = str(v)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def process_age_s() -> float:
    """Seconds since this process started (Linux /proc)."""
    try:
        start_ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return 0.0


_T_PROC0 = time.perf_counter() - process_age_s()


def forbidden_modules() -> list[str]:
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


class Recorder:
    """Wraps the device-lane server's entry points to keep its request
    handles, the admissions (span, prompt lengths), the dispatches (live
    lanes' contexts), the collects, each stamped on the perf_counter
    clock, and the accepted count of every round of every lane request,
    as the dispatch's pack brings it to the host. Cheap enough to run in
    every run."""

    def __init__(self, sched):
        self.handles, self.admits, self.dispatches, self.spans = [], [], [], []
        self._by_prompt, self._rounds = {}, {}
        srv = sched.devsrv
        if srv is None:
            return

        def submit(*a, _f=srv.submit, **k):
            h = _f(*a, **k)
            self.handles.append(h)
            self._by_prompt[tuple(h.prompt_ids)] = h
            return h

        def admit(_f=srv._admit):
            before = list(srv.lanes)
            t0 = time.perf_counter()
            n = _f()
            t1 = time.perf_counter()
            if n:
                lens = [len(h.prompt_ids) for h, b in zip(srv.lanes, before)
                        if h is not None and h is not b]
                self.admits.append((t0, t1, lens))
                self.spans.append(("admission", t0, t1))
            return n

        def dispatch(_f=srv._dispatch):
            ctxs = [h._host_base for h in srv.lanes
                    if h is not None and not h._retiring and len(h.tokens) < h.n_predict]
            t0 = time.perf_counter()
            ok = _f()
            t1 = time.perf_counter()
            if ok:
                self.dispatches.append((t0, ctxs))
                self.spans.append(("dispatch", t0, t1))
                self._keep_rounds(srv)
            return ok

        def collect(block=False, _f=srv._collect):
            t0 = time.perf_counter()
            n = _f(block=block)
            t1 = time.perf_counter()
            if n or t1 - t0 > 1e-3:
                self.spans.append(("collect", t0, t1))
            return n

        srv.submit, srv._admit, srv._dispatch, srv._collect = submit, admit, dispatch, collect

    def _keep_rounds(self, srv) -> None:
        """Keep each active lane's accepted counts from the pack of the
        dispatch just queued ([rounds, lanes, n_draft + 2], the count
        last), when the host fetches it."""
        import numpy as np

        handle, active = srv.inflight[-1][:2]
        lanes = [(int(i), srv.lanes[i]) for i in np.nonzero(active)[0]]

        def fetch(_f=handle.fetch):
            pack = _f()
            counts = np.asarray(pack)[:, :, -1]
            for i, h in lanes:
                self._rounds.setdefault(id(h), []).extend(int(m) for m in counts[:, i])
            return pack

        handle.fetch = fetch

    def rounds(self, prompt: list) -> list | None:
        """The accepted count of each round the lanes ran for the request
        of `prompt` (None if no lane served it)."""
        h = self._by_prompt.get(tuple(prompt))
        return None if h is None else list(self._rounds.get(id(h), []))


class ShapeLog:
    """Records the i4g kernel's call shapes (M, N, Kp) while on, by wrapping
    the Python entry ops.qmatmul.i4g_matmul."""

    def __init__(self):
        from pipeinfer_tpu_torch.ops import qmatmul

        self.calls, self.on = [], False
        self._mod, self._orig = qmatmul, qmatmul.i4g_matmul

        def wrapped(xq, xsum, sx, qs, step, wmin, _f=self._orig):
            if self.on:
                self.calls.append((xq.shape[0], qs.shape[1], xq.shape[1]))
            return _f(xq, xsum, sx, qs, step, wmin)

        wrapped.__dict__.update(self._orig.__dict__)
        qmatmul.i4g_matmul = wrapped

    def restore(self) -> None:
        self._mod.i4g_matmul = self._orig


class RunData:
    """What the per-layer readers see (metrics/<name>.py)."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def tokens_between(self, t0: float, t1: float) -> int:
        return sum(1 for tr in self.timed for s in tr.stamps if t0 <= s < t1)


def percentile(values, q: float) -> float:
    import numpy as np

    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def end_to_end(timed: list, t_open: float, t_close: float) -> dict:
    """The window's end-to-end numbers, from the tokens stamped before it
    closed: TTFT and TPOT tails over every request due in the window (one
    whose first token had not come counts t_close - due; TPOT, mean time
    between its tokens, over those with two tokens or more) and the output
    tokens committed in the window per second of it."""
    due = [tr for tr in timed if tr.req is not None and t_open <= tr.due < t_close]
    ttft, tpot = [], []
    for tr in due:
        s = [x for x in tr.stamps if x < t_close]
        ttft.append((s[0] if s else t_close) - tr.due)
        if len(s) >= 2:
            tpot.append((s[-1] - s[0]) / (len(s) - 1))
    n_out = sum(1 for tr in timed for s in tr.stamps if t_open <= s < t_close)
    return dict(ttft_p90_ms=1e3 * percentile(ttft, 90) if ttft else None,
                tpot_p90_ms=1e3 * percentile(tpot, 90) if tpot else None,
                out_tok_s=n_out / (t_close - t_open), n_due=len(due))


def warm_up(sched, mix: dict, n_vocab: int, log) -> None:
    """A fixed request set, the same in every run: WARM_REQUESTS prompts
    of the mix's median length admitted together, each decoding
    WARM_TOKENS tokens."""
    import numpy as np
    from pipeinfer_tpu_torch.serving.batching import Request

    from .serve import sampling_params

    rng = np.random.default_rng(0)
    samp = sampling_params(mix)
    reqs = [Request(prompt_ids=rng.integers(0, n_vocab, int(mix["prompt"]["median"])).tolist(),
                    n_predict=WARM_TOKENS, sampling=samp, ignore_eos=True)
            for _ in range(WARM_REQUESTS)]
    t0 = time.perf_counter()
    for r in reqs:
        sched.submit(r)
    sched.run_until_idle()
    bad = [r.error for r in reqs if r.error]
    if bad:
        raise RuntimeError(f"warm-up request failed: {bad[0]}")
    log(f"warm-up: {len(reqs)} requests in {time.perf_counter() - t0:.2f} s")


class Built:
    """A cell's set-up: the model pair's bytes, the program's contexts and
    scheduler, and the recorder on its device lanes."""

    def __init__(self, cell, device, log, trace: bool = False):
        import torch

        from pipeinfer_tpu_torch.runtime.context import InferenceContext

        from . import weights
        from .serve import build_scheduler

        self.dev = torch.device(device)
        server = cell.mix["server"]
        t0 = time.perf_counter()
        self.mb = mb = weights.make_bytes(cell.config, self.dev)
        tparams = weights.port_params(mb, self.dev)
        dparams = weights.port_params(mb, self.dev, draft=True)
        self.ctx = InferenceContext(tparams, weights.port_config(mb), n_cells=server["n_cells"],
                                    device=self.dev)
        self.ctx_dft = InferenceContext(dparams, weights.port_config(mb, draft=True),
                                        n_cells=server["n_cells"], device=self.dev)
        self.sched = build_scheduler(self.ctx, self.ctx_dft, server)
        if server["device_lanes"] and self.sched.devsrv is None:
            raise RuntimeError(f"the program refused {server['device_lanes']} device lanes")
        log(f"model pair built in {time.perf_counter() - t0:.2f} s")
        self.rec = Recorder(self.sched)
        warm_up(self.sched, cell.mix, mb.n_vocab, log)
        if trace and self.dev.type == "cuda":  # the profiler's first start is slow
            from .trace import Tracer

            t = Tracer()
            t.start()
            torch.ones(1, device=self.dev).add_(1)
            torch.cuda.synchronize(self.dev)
            t.stop()

    def free(self) -> None:
        """Drop the program's state (the bytes stay, for the reference)."""
        import torch

        del self.sched, self.ctx, self.ctx_dft, self.rec
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()


class Window:
    """One measured window of a traffic plan against a built cell."""

    def __init__(self, b: Built, mix: dict, seed: int, seconds: float, trace: bool, log,
                 until_idle: bool = False):
        from . import traffic
        from .serve import Driver
        from .trace import Tracer

        planned = traffic.plan(mix, seed, b.mb.n_vocab, traffic.n_requests(mix, seconds))
        drv = Driver(b.sched, mix, planned)
        self.shapes = ShapeLog() if trace else None
        self.tracer = Tracer() if trace else None
        drv.record_spans = trace
        n_rec = len(b.rec.spans)
        drv.start()
        try:
            self.t_open = t_open = drv.t_start + float(mix["lead_s"])
            self.t_close = t_close = t_open + seconds
            time.sleep(max(0.0, t_open - time.perf_counter()))
            self.setup_s = time.perf_counter() - _T_PROC0
            if trace:  # the slice ends at the close or, if the profiler was slow to start, after it
                trace_s = min(TRACE_S, seconds)
                time.sleep(max(0.0, t_close - trace_s - PREPARE_S - time.perf_counter()))
                t_req = time.perf_counter()
                self.tracer.prepare()
                t_prep = time.perf_counter()
                time.sleep(max(0.0, t_close - trace_s - time.perf_counter()))
                self.tracer.start()
                self.shapes.on = True
                log(f"profiler set up in {t_prep - t_req:.3f} s, started in "
                    f"{self.tracer.t0 - max(t_prep, t_close - trace_s):.3f} s; "
                    f"the slice opens {self.tracer.t0 - (t_close - trace_s):.3f} s late")
                time.sleep(max(0.0, self.tracer.t0 + trace_s - time.perf_counter()))
                # admissions can hold every lane for seconds: a slice runs
                # on until it holds a dispatch and a committed token
                t_ext = self.tracer.t0 + trace_s + EXTEND_S
                while (not self._lanes_stepped(b.rec, drv, self.tracer.t0)
                       and time.perf_counter() < t_ext):
                    time.sleep(0.05)
                self.shapes.on = False
                self.tracer.stop()
            time.sleep(max(0.0, t_close - time.perf_counter()))
        except BaseException:
            drv.stop()
            raise
        drv.stop_load()
        self.due = [tr for tr in drv.timed if tr.req is not None and t_open <= tr.due < t_close]
        if until_idle:  # the tools: leave nothing in flight for the next window
            drv.drain([tr for tr in drv.timed if tr.req is not None],
                      t_close + DRAIN_S)
        drv.stop()
        self.t_end = time.perf_counter()
        if self.shapes is not None:
            self.shapes.restore()
        self.timed = drv.timed
        self.spans = b.rec.spans[n_rec:] + drv.spans
        self.failed = sum(1 for tr in self.due if tr.error)
        self.e2e = end_to_end(drv.timed, t_open, t_close)
        # every request the timed path finished by the end (the window's
        # and the lead-in's), with its lanes' rounds, for the check
        self.finished = [(tr.planned.prompt, list(tr.req.generated),
                          b.rec.rounds(tr.planned.prompt)) for tr in drv.timed
                         if tr.done and not tr.error and tr.req.generated]
        e = self.e2e
        log(f"window {seconds} s: {e['n_due']} requests due, {self.failed} failed, "
            f"{e['out_tok_s']:.1f} output tokens/s, {len(self.finished)} finished; "
            f"stopped {self.t_end - t_close:.2f} s after")
        log(f"window: setup_s {self.setup_s}, ttft_p90_ms {e['ttft_p90_ms']}, "
            f"tpot_p90_ms {e['tpot_p90_ms']}, out_tok_s {e['out_tok_s']}")

    @staticmethod
    def _lanes_stepped(rec, drv, t0: float) -> bool:
        """Whether a token was committed since t0 and, where device lanes
        run, a lane dispatch started since t0."""
        dispatched = not rec.dispatches or rec.dispatches[-1][0] >= t0
        return dispatched and any(s >= t0 for tr in drv.timed for s in tr.stamps[-1:])


def per_layer(cell, b: Built, w: Window, log) -> tuple[dict, dict, dict]:
    """(metrics, the device's busy_s and window_s, breakdown) of a traced
    window, each per-layer metric from its own reader."""
    from . import roofline
    from .cell import load_metric
    from .trace import label_gaps, port_kernels

    kern = w.tracer.kernels()
    csrc = Path(sys.modules["pipeinfer_tpu_torch"].__file__).parent / "csrc"
    run = RunData(mb=b.mb, mix=cell.mix, cell=cell, timed=w.timed, t_open=w.t_open,
                  t_close=w.t_close, rec=b.rec, kernels=kern, i4g_calls=w.shapes.calls,
                  port_kernels=port_kernels(csrc), roofline=roofline,
                  spec=cell.mix["server"]["spec"],
                  rounds=b.sched.devsrv.rounds if b.sched.devsrv else 0)
    metrics = {}
    for m in cell.per_layer:
        v = load_metric(m["name"]).read(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    busy = kern.busy_s()
    top = sorted(kern.by_name().items(), key=lambda kv: -kv[1])[:10]
    breakdown = {"device_ops": [[n, s] for n, s in top],
                 "idle_gaps": label_gaps(kern.gaps(), w.spans)}
    log(f"traced {kern.window_s:.3f} s: {len(kern.events)} kernels, busy {busy:.3f} s")
    return metrics, {"busy_s": busy, "window_s": kern.window_s}, breakdown


def judge(mb, finished: list, seed: int, ck: dict, depth: int, device, log):
    """The sample of finished requests, the reference's gaps of their
    served tokens and its draft's gaps of the decisions their rounds show:
    (judged, reference, gaps, draft gaps)."""
    import numpy as np

    from . import check
    from .reference.model import Reference

    t0 = time.perf_counter()
    judged = check.sample(finished, seed, int(ck["min_tokens"]), int(ck["max_requests"]))
    ref = Reference(mb, device)
    gaps = check.served_gaps(ref, judged) if judged else np.zeros(0)
    dgaps = check.draft_gaps(ref.draft(), judged, depth) if judged else np.zeros(0)
    log(f"reference: {len(judged)} requests, {int(sum(len(j[1]) for j in judged))} served "
        f"tokens in {time.perf_counter() - t0:.2f} s; {int((gaps > 0).sum())} tokens off its "
        f"argmax; {len(dgaps)} draft decisions, {int((dgaps > 0).sum())} not its draft's")
    return judged, ref, gaps, dgaps


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
             log=lambda *a: print(*a, file=sys.stderr, flush=True), fault=None) -> dict:
    """One run of `cell` on `device`; returns the result (without the
    device block). `fault(sched)`, for the harness's own tests, may break
    the program under the timed path before the window."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    b = Built(cell, dev, log, trace)
    if fault is not None:
        fault(b.sched)
    w = Window(b, cell.mix, seed, seconds, trace, log)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        peak = int(torch.cuda.max_memory_allocated(dev))
    else:
        peak = 0
    metrics, device_extra, breakdown = {}, {}, None
    if trace:
        metrics, device_extra, breakdown = per_layer(cell, b, w, log)
    else:
        for m in cell.end_to_end:
            v = w.setup_s if m["name"] == "setup_s" else w.e2e.get(m["name"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    b.free()

    ck = cell.config["check"]
    depth = int(cell.mix["server"]["spec"]["n_draft"])
    judged, ref, gaps, dgaps = judge(b.mb, w.finished, seed, ck, depth, dev, log)
    n_tok = int(sum(len(j[1]) for j in judged))
    gap_max = float(gaps.max()) if len(gaps) else float("inf")
    # the draft's decisions are read, not compared: at the configurations'
    # widths its head's margin makes every pick, with or without its
    # layers, so no limit separates a sound draft from a broken one
    log(f"draft decisions (read, not compared): {len(dgaps)}, widest gap "
        f"{float(dgaps.max()) if len(dgaps) else None}")
    checks = {
        "gap_max": {"value": gap_max, "limit": float(ck["gap_limit"])},
        "failed": {"value": w.failed, "limit": 0},
        "judged_tokens": {"value": n_tok, "limit": int(ck["min_judged"])},
    }
    correct = gap_max <= ck["gap_limit"] and w.failed == 0 and n_tok >= int(ck["min_judged"])
    result = {"correct": bool(correct), "attempted": w.e2e["n_due"], "failed": w.failed,
              "metrics": metrics, "device_extra": device_extra, "peak": peak}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    result["_judged"] = (judged, ref, gaps, dgaps)  # for the harness's own tests; main drops it
    return result


def power_limit() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=20).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _set_env()

    from .cell import Cell, benchmark

    cell = Cell(benchmark(), args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: the cell needs {cell.chips} CUDA device(s), found {n}",
              file=sys.stderr)
        return 2
    res = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    del res["_judged"]
    bad = forbidden_modules()
    if bad:
        print(f"portbench: forbidden modules were imported: {', '.join(bad)}", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
              "memory_peak_bytes": res.pop("peak"), "card": power_limit()}
    device.update(res.pop("device_extra"))
    checks = res.pop("checks")
    out = dict(res, device=device)
    bd = out.pop("breakdown", None)
    if bd is not None:
        out["breakdown"] = bd
    out["checks"] = checks
    for k, v in checks.items():
        print(f"check {k}: {v['value']} (limit {v['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
