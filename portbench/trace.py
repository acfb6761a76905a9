"""The device trace of a traced run, and what the per-layer metrics read
from it.

``torch.profiler`` records the CUDA kernels of a slice of the window (the
host activity is left off: it would record every host op and slow the
host-bound step it measures). From the kernels: the busy time as the union
of their intervals, their count, their time by name and by the port's
source file (``csrc/<source>.cu``, whose ``__global__`` functions name them,
as tools/profile_decode.py groups them), and the idle gaps between them,
each labelled by the benchmark span that was open on the host at its
middle.
"""

from __future__ import annotations

import dataclasses
import re
import time
from collections import defaultdict
from pathlib import Path

_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\((?:[^()]|\([^()]*\))*\)\s*)?"
                     r"(\w+)\s*\(")


def port_kernels(csrc: Path) -> dict[str, str]:
    """{kernel function name: the csrc source that defines it}."""
    return {fn: src.stem for src in sorted(csrc.glob("*.cu"))
            for fn in _GLOBAL.findall(src.read_text())}


def port_source(name: str, kernels: dict[str, str]) -> str | None:
    m = re.search(r"::(\w+)[<(]", name) or re.match(r"(\w+)[<(]?", name)
    return kernels.get(m.group(1)) if m else None


@dataclasses.dataclass
class Kernels:
    """The traced slice: kernels as (name, start s, end s) on the
    perf_counter clock, and the slice's bounds on that clock."""

    events: list
    t0: float
    t1: float

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def busy_s(self) -> float:
        busy, end = 0.0, float("-inf")
        for _, s, e in sorted(self.events, key=lambda x: x[1]):
            if e <= end:
                continue
            busy += e - max(s, end)
            end = e
        return busy

    def by_name(self) -> dict[str, float]:
        out = defaultdict(float)
        for name, s, e in self.events:
            out[name] += e - s
        return dict(out)

    def by_source(self, kernels: dict[str, str]) -> dict[str, float]:
        out = defaultdict(float)
        for name, s, e in self.events:
            src = port_source(name, kernels)
            if src:
                out[src] += e - s
        return dict(out)

    def gaps(self) -> list[tuple[float, float]]:
        """Idle intervals (start, end) between the busy runs, and before
        the first and after the last kernel."""
        out, end = [], self.t0
        for _, s, e in sorted(self.events, key=lambda x: x[1]):
            if s > end:
                out.append((end, s))
            end = max(end, e)
        if self.t1 > end:
            out.append((end, self.t1))
        return out


def _events(prof) -> list:
    """(name, start ns on the wall clock, duration ns) of the profile's
    CUDA kernels."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name(), e.start_ns(), e.duration_ns())
            for e in prof.profiler.kineto_results.events() if e.device_type() == cuda]


class Tracer:
    """Start and stop the profiler around a slice; ``kernels()`` after.
    ``prepare`` does the slow part of a start (the profiler's set-up)
    ahead of the slice, so that ``start`` only switches recording on; no
    call stops the threads that launch the kernels."""

    def __init__(self):
        import torch

        act = torch.profiler.ProfilerActivity
        # on a machine without CUDA (the harness's own tests) the slice holds no kernel
        self._prof = torch.profiler.profile(
            activities=[act.CUDA if torch.cuda.is_available() else act.CPU])
        self.t0 = self.t1 = 0.0
        self._wall0 = 0
        self._prepared = False

    def prepare(self) -> None:
        self._prof.prepare_trace()
        self._prepared = True

    def start(self) -> None:
        if not self._prepared:
            self.prepare()
        self._prof.start_trace()
        self.t0 = time.perf_counter()
        self._wall0 = time.time_ns()

    def stop(self) -> None:
        self.t1 = time.perf_counter()
        self._prof.stop_trace()

    def kernels(self) -> Kernels:
        """The slice's kernels on the perf_counter clock: the profiler
        stamps them on the wall clock, read here beside perf_counter when
        the slice started."""
        raw = _events(self._prof)
        ev = [(n, self.t0 + (s - self._wall0) / 1e9, self.t0 + (s - self._wall0 + d) / 1e9)
              for n, s, d in raw]
        ev = [(n, max(s, self.t0), min(e, self.t1)) for n, s, e in ev if e > self.t0 and s < self.t1]
        if raw and not ev:
            raise RuntimeError(f"no kernel of the trace falls in its slice: first at "
                               f"{min(s for _, s, _ in raw)} ns, slice from {self._wall0} ns")
        return Kernels(ev, self.t0, self.t1)


def label_gaps(gaps: list, spans: list, top: int = 10) -> list[list]:
    """The `top` longest gaps as [label, seconds]: the host span open at
    the gap's middle (admission, dispatch, collect, generator), or
    ``engine: no span`` where none was."""
    out = []
    for g0, g1 in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
        mid = 0.5 * (g0 + g1)
        names = [n for n, s, e in spans if s <= mid <= e]
        out.append([names[0] if names else "engine: no span", g1 - g0])
    return out
