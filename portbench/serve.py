"""Drive the program's speculative scheduler with a traffic plan and time
every request on the benchmark's own clock.

The scheduler is ``serving.batching.SpecBatchScheduler`` as
``serving/server.py::serve(..., draft_path=...)`` builds it, with the
settings of the traffic file's ``server`` group; its engine thread runs
``serve_forever``. The HTTP and text layer is left out: requests are token
ids. An open loop submits each request at its due time from one generator
thread; a closed loop runs ``clients`` threads, each sending its next
request when its last one is done. Every committed token is stamped with
``time.perf_counter()`` by the request's stream callback.
"""

from __future__ import annotations

import dataclasses
import threading
import time


@dataclasses.dataclass
class Timed:
    """A request as the benchmark saw it: the plan's entry, its due time on
    the perf_counter clock, and one stamp per token."""

    planned: object
    due: float = 0.0
    stamps: list = dataclasses.field(default_factory=list)
    req: object = None

    @property
    def done(self) -> bool:
        return self.req is not None and self.req.done

    @property
    def error(self):
        return None if self.req is None else self.req.error


def build_scheduler(ctx, ctx_dft, server: dict, eos_id: int = -1):
    """The scheduler `pipeinfer-server --draft` builds, with the cell's
    settings (serving/server.py::main's SpecParams)."""
    from pipeinfer_tpu_torch.serving.batching import SpecBatchScheduler
    from pipeinfer_tpu_torch.spec.params import SpecParams

    sp = SpecParams(**server["spec"])
    return SpecBatchScheduler(ctx, ctx_dft, spec_params=sp, max_slots=server["max_slots"],
                              eos_id=eos_id, device_lanes=server["device_lanes"])


def sampling_params(mix: dict):
    from pipeinfer_tpu_torch.sampling.samplers import SamplingParams

    return SamplingParams(**mix["sampling"])


class Driver:
    """Runs one traffic plan against a scheduler: ``start`` the engine and
    the load, ``stop_load`` at the window's end, ``stop`` the engine (the
    tools ``drain`` what is in flight first)."""

    def __init__(self, sched, mix: dict, planned: list):
        from pipeinfer_tpu_torch.serving.batching import Request

        self.sched, self.mix = sched, mix
        self.samp = sampling_params(mix)
        self._Request = Request
        self.timed = [Timed(p) for p in planned]
        self._next = 0
        self._lock = threading.Lock()
        self._stop_engine = threading.Event()
        self._stop_load = threading.Event()
        self.t_start = 0.0
        self.threads = []
        self.spans = []  # (name, t0, t1) of the load threads (traced runs)
        self.record_spans = False

    def _submit(self, tr: Timed) -> None:
        t0 = time.perf_counter()
        p = tr.planned

        def stamp(_tok, _s=tr.stamps):
            _s.append(time.perf_counter())

        tr.req = self._Request(prompt_ids=p.prompt, n_predict=p.n_predict, sampling=self.samp,
                               stream=stamp, ignore_eos=True)
        self.sched.submit(tr.req)
        if self.record_spans:
            self.spans.append(("generator", t0, time.perf_counter()))

    def _take(self) -> Timed | None:
        with self._lock:
            if self._next >= len(self.timed):
                return None
            tr = self.timed[self._next]
            self._next += 1
            return tr

    def _open_loop(self) -> None:
        for tr in self.timed:
            tr.due = self.t_start + tr.planned.due
            wait = tr.due - time.perf_counter()
            if wait > 0 and self._stop_load.wait(wait):
                return
            if self._stop_load.is_set():
                return
            self._submit(tr)

    def _client(self, offset: float) -> None:
        if self._stop_load.wait(offset):
            return
        while not self._stop_load.is_set():
            tr = self._take()
            if tr is None:
                return
            tr.due = time.perf_counter()
            self._submit(tr)
            while not tr.req.done_event.wait(0.05):
                if self._stop_engine.is_set():
                    return

    def start(self) -> None:
        self.t_start = time.perf_counter()
        eng = threading.Thread(target=self.sched.serve_forever, args=(self._stop_engine,),
                               name="engine", daemon=True)
        eng.start()
        self.threads.append(eng)
        if self.mix["loop"] == "open":
            targets = [(self._open_loop, ())]
        else:
            n = int(self.mix["clients"])
            stagger = float(self.mix["stagger_s"])
            targets = [(self._client, (stagger * i / n,)) for i in range(n)]
        for fn, args in targets:
            t = threading.Thread(target=fn, args=args, daemon=True)
            t.start()
            self.threads.append(t)

    def stop_load(self) -> None:
        self._stop_load.set()

    def drain(self, which: list, deadline: float) -> None:
        """Wait until every request of `which` is done or `deadline` passes."""
        for tr in which:
            while tr.req is not None and not tr.req.done:
                left = deadline - time.perf_counter()
                if left <= 0 or tr.req.done_event.wait(min(left, 0.1)):
                    break

    def stop(self) -> None:
        self._stop_load.set()
        self._stop_engine.set()
        for t in self.threads:
            t.join(timeout=30)
        alive = [t.name for t in self.threads if t.is_alive()]
        if alive:
            raise RuntimeError(f"threads still running after stop: {alive}")
