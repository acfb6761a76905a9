"""Continuous batching across concurrent requests.

Counterpart of the reference's slot-based server loop and the parallel
example (ref: examples/server/server.cpp slot machinery,
examples/parallel/parallel.cpp:238-311): each request owns a sequence id
and sampler state; every engine step packs one decode token per active
request (plus prompt chunks for newly admitted ones) into a single batch,
so new requests hot-join while others are mid-generation.

Torch counterpart of pipeinfer_tpu.serving.batching (which imports no
JAX), over the port's contexts and engines. A request's image segments
enter BatchScheduler's context through its embedding input
(InferenceContext.decode_embd) at admission, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
from typing import Callable, Optional


from ..runtime.context import Batch, InferenceContext, single_device
from ..sampling.samplers import SamplerState, SamplingParams, sample, top_probs

@dataclasses.dataclass
class Request:
    prompt_ids: list[int]
    n_predict: int
    sampling: SamplingParams
    stream: Optional[Callable[[int], None]] = None
    ignore_eos: bool = False
    # multimodal prompts: ordered segments of ("tok", [ids]) and
    # ("img", embd [T, n_embd]) — the reference server's slot_image +
    # prefix_prompt structure (ref: server.cpp:196-206). When set,
    # prompt_ids is ignored and the whole prefill happens at admission.
    segments: list | None = None
    # per-request parity with the reference server (server.cpp:721-760):
    # grammar: a parsed sampling.grammar.GrammarState (the HTTP layer turns
    # GBNF text into one); n_probs: record top-n (id, prob) per generated
    # token into `probs`; cancel: cooperative early stop (stop-sequence
    # matching lives in the text layer, which calls scheduler.cancel)
    grammar: object | None = None
    n_probs: int = 0
    probs: list = dataclasses.field(default_factory=list)
    cancel: bool = False

    # runtime state (slot fields, ref server.cpp slot struct)
    rid: int = -1
    seq: int = -1
    n_prompt_fed: int = 0
    n_past: int = 0
    generated: list[int] = dataclasses.field(default_factory=list)
    sampler: SamplerState | None = None
    pending_logit_idx: int = -1
    done: bool = False
    error: str | None = None  # set when the request failed (e.g. KV overflow)
    done_event: threading.Event = dataclasses.field(default_factory=threading.Event)

    def cells_needed(self) -> int:
        """Worst-case KV cells this request can occupy (prompt + budget)."""
        n_prompt = len(self.prompt_ids)
        if self.segments is not None:
            n_prompt = sum(
                len(payload) if kind == "tok" else payload.shape[0]
                for kind, payload in self.segments
            )
        return n_prompt + self.n_predict

    def fail(self, msg: str):
        self.error = msg
        self.done = True
        self.done_event.set()


class BatchScheduler:
    """Slot-based continuous batching over one InferenceContext."""

    def __init__(
        self,
        ctx: InferenceContext,
        *,
        max_slots: int = 8,
        prompt_chunk: int = 64,
        eos_id: int = 2,
        topk: int | None = 128,
    ):
        self.ctx = ctx
        self.max_slots = max_slots
        self.prompt_chunk = prompt_chunk
        self.eos_id = eos_id
        self.topk = topk
        self.slots: list[Request | None] = [None] * max_slots
        self.queue: list[Request] = []
        self._rid = itertools.count()
        self.lock = threading.Lock()
        # KV admission control: sum of worst-case cells of admitted requests.
        # Never admit beyond capacity — find_cells raising mid-step would
        # kill the engine thread (the reference instead defers the slot,
        # server.cpp has the same batch-doesn't-fit requeue).
        self._reserved = 0

    def submit(self, req: Request) -> Request:
        req.rid = next(self._rid)
        with self.lock:
            self.queue.append(req)
        return req

    @property
    def busy(self) -> bool:
        return any(s is not None for s in self.slots) or bool(self.queue)

    def _admit(self):
        usable = self.ctx.n_cells - 1  # trash cell reserved
        for i in range(self.max_slots):
            if self.slots[i] is None and self.queue:
                need = self.queue[0].cells_needed()
                if need > usable:
                    self.queue.pop(0).fail(
                        f"prompt + n_predict needs {need} KV cells, cache has {usable}"
                    )
                    continue
                if self._reserved + need > usable:
                    break  # wait for running requests to finish
                req = self.queue.pop(0)
                self._reserved += need
                req.seq = i
                req.sampler = SamplerState(params=req.sampling,
                                           grammar=req.grammar)
                self.ctx.seq_rm(i, 0, -1)
                self.slots[i] = req
                if req.segments is not None:
                    self._prefill_segments(req)
                else:
                    for t in req.prompt_ids:
                        req.sampler.accept(t, apply_grammar=False)

    def _prefill_segments(self, req: Request):
        """Multimodal prefill: token segments via decode, image segments
        via the embedding input path, all at admission (the reference
        server likewise evaluates a slot's images before joining the
        batch loop, server.cpp:1316-1360)."""
        if not req.segments or req.segments[-1][0] != "tok":
            raise ValueError("prompt must end with text after the last image")
        pos = 0
        logits = None
        last = len(req.segments) - 1
        for si, (kind, payload) in enumerate(req.segments):
            if kind == "tok":
                b = Batch()
                for j, t in enumerate(payload):
                    req.sampler.accept(t, apply_grammar=False)
                    b.add(t, pos + j, req.seq,
                          want_logits=(si == last and j == len(payload) - 1))
                topk = None if (req.grammar is not None
                                or req.sampling.mirostat != 0) else self.topk
                out = self.ctx.decode(b, topk)
                logits = out[-1]
                pos += len(payload)
            else:  # "img": [T, n_embd] embeddings
                self.ctx.decode_embd(payload, pos, req.seq)
                pos += payload.shape[0]
        req.n_past = pos
        req.n_prompt_fed = len(req.prompt_ids)  # nothing left to feed
        # sample the first token now so step() continues from generated[-1]
        if req.n_probs:
            req.probs.append(top_probs(req.sampler, logits, req.n_probs))
        tok = sample(req.sampler, logits)
        req.sampler.accept(tok)
        req.generated.append(tok)
        if req.stream:
            req.stream(tok)
        hit_eos = (not req.ignore_eos) and tok == self.eos_id
        if hit_eos or len(req.generated) >= req.n_predict:
            self._finish(req)

    def _topk_for_step(self) -> int | None:
        """Sparse top-K rows unless any live request needs the full vocab
        row (grammar masking / mirostat walk every logit)."""
        for req in self.slots:
            if req is not None and (
                req.grammar is not None or req.sampling.mirostat != 0
            ):
                return None
        return self.topk

    def cancel(self, req: Request):
        """Cooperative early stop (the stop-sequence path): the engine
        thread finishes the request at its next step boundary."""
        req.cancel = True

    def step(self) -> int:
        """One engine iteration. Returns number of tokens decoded."""
        with self.lock:
            self._admit()
        batch = Batch()
        sample_list: list[Request] = []
        for req in list(self.slots):
            if req is None:
                continue
            if req.cancel:
                self._finish(req)
                continue
            if req.n_prompt_fed < len(req.prompt_ids):
                # feed (a chunk of) the prompt
                chunk = req.prompt_ids[req.n_prompt_fed : req.n_prompt_fed + self.prompt_chunk]
                last = req.n_prompt_fed + len(chunk) == len(req.prompt_ids)
                for j, t in enumerate(chunk):
                    batch.add(t, req.n_past + j, req.seq, want_logits=(last and j == len(chunk) - 1))
                if last:
                    req.pending_logit_idx = len(batch) - 1
                    sample_list.append(req)
                req.n_prompt_fed += len(chunk)
                req.n_past += len(chunk)
            else:
                tok = req.generated[-1]
                batch.add(tok, req.n_past, req.seq, want_logits=True)
                req.pending_logit_idx = len(batch) - 1
                req.n_past += 1
                sample_list.append(req)
        if len(batch) == 0:
            return 0
        try:
            logits = self.ctx.decode(batch, self._topk_for_step())
        except RuntimeError as e:  # KV full despite admission control
            self._fail_live(f"engine error: {e}")
            return 0
        for req in sample_list:
            row = logits[req.pending_logit_idx]
            if req.n_probs:
                req.probs.append(top_probs(req.sampler, row, req.n_probs))
            tok = sample(req.sampler, row)
            req.sampler.accept(tok)
            req.generated.append(tok)
            if req.stream:
                req.stream(tok)
            hit_eos = (not req.ignore_eos) and tok == self.eos_id
            if hit_eos or len(req.generated) >= req.n_predict:
                self._finish(req)
        return len(batch)

    def _finish(self, req: Request):
        self.slots[req.seq] = None
        self.ctx.seq_rm(req.seq, 0, -1)
        self._reserved -= req.cells_needed()
        req.done = True
        req.done_event.set()

    def _fail_live(self, msg: str):
        """Fail every live request instead of dying silently — waiting HTTP
        handlers see req.error rather than hanging on done_event forever."""
        with self.lock:
            q, self.queue = self.queue, []
        for req in q:
            req.fail(msg)
        for i, req in enumerate(self.slots):
            if req is not None:
                self.slots[i] = None
                self.ctx.seq_rm(i, 0, -1)
                req.fail(msg)
        self._reserved = 0

    def run_until_idle(self):
        while self.busy:
            self.step()

    def serve_forever(self, stop: threading.Event, idle_sleep: float = 0.005):
        import sys
        import time

        while not stop.is_set():
            try:
                n = self.step()
            except Exception as e:  # engine must outlive any one request
                print(f"engine exception: {e!r}", file=sys.stderr, flush=True)
                self._fail_live(f"engine exception: {e}")
                n = 0
            if n == 0:
                time.sleep(idle_sleep)


class SpecBatchScheduler:
    """Continuous batching WITH asynchronous speculation: the BatchScheduler
    surface (submit/step/serve_forever over serving Requests) backed by TWO
    engines sharing the contexts with disjoint sequence-slot namespaces:

    - `DeviceLoopServer` lanes (spec/device_multi.py) for requests whose
      sampler rides the device chain (greedy by default): the batched
      device-resident loop, S lanes per weight pass;
    - `MultiPipeInfer` (spec/multi.py) for everything else — grammar,
      penalties, mirostat, logit bias, seeded stochastic chains — each
      slot a full PipeInfer stream with host verification.

    The reference keeps speculation (examples/speculative) and continuous
    batching (examples/server slot scheduler, server.cpp:377-463;
    examples/parallel) in separate drivers; here `pipeinfer-server
    --draft d.gguf` serves both at once and routes per request."""

    def __init__(
        self,
        ctx: InferenceContext,
        ctx_dft: InferenceContext,
        *,
        spec_params=None,
        max_slots: int | None = None,
        eos_id: int = 2,
        device_lanes: int = 4,
        device_sampling: SamplingParams | None = None,
        device_rounds: int = 4,
    ):
        from ..spec.multi import MAX_SEQS, MultiPipeInfer
        from ..spec.params import SpecParams

        self.ctx = ctx
        sp = spec_params or SpecParams()
        self.devsrv = None
        lane_slots = 0
        # the device lanes need one-device contexts, tested as
        # spec/corrected.py::supported tests them
        if device_lanes > 0 and single_device(ctx, ctx_dft):
            from ..spec.device_multi import DeviceLoopServer

            dsamp = device_sampling or SamplingParams(
                temp=0.0, penalty_repeat=1.0, penalty_last_n=0)
            try:
                self.devsrv = DeviceLoopServer(
                    ctx, ctx_dft, dsamp, sp,
                    n_lanes=device_lanes,
                    seq_base=MAX_SEQS - device_lanes,
                    eos_id=eos_id, rounds=device_rounds,
                )
                lane_slots = device_lanes
            except ValueError:
                # the only refusal left: a device_sampling chain outside
                # device_loop.supported, served on the host path only
                self.devsrv = None
        self.engine = MultiPipeInfer(
            ctx,
            ctx_dft,
            SamplingParams(),
            sp,
            eos_id=eos_id,
            max_streams=max_slots,
            max_seqs=MAX_SEQS - lane_slots,
        )
        self.max_slots = self.engine.max_streams + lane_slots
        self.queue: list[Request] = []
        self._live: dict[int, Request] = {}  # SpecRequest.id -> serving req
        self._sreqs: dict[int, object] = {}  # SpecRequest.id -> SpecRequest
        self._dev_live: list[tuple[object, Request]] = []  # (LaneHandle, req)
        self._rid = itertools.count()
        self.lock = threading.Lock()
        # per-engine served counters (observability + routing tests)
        self.n_device_served = 0
        self.n_host_served = 0

    def submit(self, req: Request) -> Request:
        with self.lock:
            self.queue.append(req)
        return req

    @property
    def busy(self) -> bool:
        return (
            bool(self.queue)
            or bool(self.engine.active)
            or bool(self.engine.pending)
            or bool(self.devsrv and self.devsrv.busy)
        )

    def _route_device(self, req: Request) -> bool:
        """Send this request down the device-lane path? Sampler must ride
        the compiled chain; multimodal prefill, grammar, and n_probs stay
        host-side (device verification never ships per-token rows)."""
        return (
            self.devsrv is not None
            and req.segments is None
            and req.grammar is None
            and req.n_probs == 0
            and len(req.prompt_ids) > 0
            and self.devsrv.compatible(req.sampling)
        )

    def _drain_queue(self):
        # the whole body holds the scheduler lock: cancel() (HTTP handler
        # threads) walks _live/_dev_live, and a cancel landing between the
        # queue swap and the _live insertion would otherwise find the
        # request in neither collection (lost cancel) or hit a dict
        # mutated mid-iteration. Engine submits are cheap enqueues, so
        # holding the lock across them costs nothing.
        with self.lock:
            self._drain_queue_locked()

    def _drain_queue_locked(self):
        q, self.queue = self.queue, []
        for req in q:

            def cb(t, _r=req):
                _r.generated.append(t)
                if _r.stream:
                    _r.stream(t)

            req.rid = next(self._rid)
            if self._route_device(req):
                h = self.devsrv.submit(
                    req.prompt_ids,
                    req.n_predict,
                    on_token=cb,
                    ignore_eos=req.ignore_eos,
                )
                self._dev_live.append((h, req))
                continue
            sreq = self.engine.submit(
                req.prompt_ids,
                req.n_predict,
                sampling=req.sampling,
                stream=cb,
                ignore_eos=req.ignore_eos,
                grammar=req.grammar,
                n_probs=req.n_probs,
            )
            self._live[sreq.id] = req
            self._sreqs[sreq.id] = sreq

        # reap finished streams
        live_ids = {r.id for r in self.engine.active}
        live_ids |= {r.id for r in self.engine.pending}
        for sid in list(self._live):
            if sid not in live_ids:
                req = self._live.pop(sid)
                sreq = self._sreqs.pop(sid)
                req.error = sreq.error
                req.probs = sreq.probs
                req.done = True
                req.done_event.set()
                self.n_host_served += 1
        still = []
        for h, req in self._dev_live:
            if h.done:
                req.error = h.error
                req.done = True
                req.done_event.set()
                self.n_device_served += 1
            else:
                still.append((h, req))
        self._dev_live = still

    def cancel(self, req: Request):
        """Cooperative early stop (stop-sequence path), engine-agnostic:
        scheduler-queued requests finish immediately; routed ones stop at
        their engine's next quantum."""
        with self.lock:
            if req in self.queue:
                self.queue.remove(req)
                req.done = True
                req.done_event.set()
                return
            for h, r in self._dev_live:
                if r is req:
                    h.cancel = True
                    return
            for sid, r in self._live.items():
                if r is req:
                    self.engine.cancel(self._sreqs[sid])
                    return

    def step(self) -> int:
        self._drain_queue()
        progressed = self.engine.step()
        dev_prog = 0
        if self.devsrv is not None and self.devsrv.busy:
            # block on the oldest device pack only when the host engine has
            # nothing to do — otherwise poll, so neither engine starves
            dev_prog = self.devsrv.step(block=not progressed)
        self._drain_queue()
        return 1 if (progressed or dev_prog) else 0

    def run_until_idle(self):
        while self.busy:
            self.step()
        self._drain_queue()

    def serve_forever(self, stop: threading.Event, idle_sleep: float = 0.005):
        import sys
        import time

        while not stop.is_set():
            try:
                n = self.step()
            except Exception as e:
                print(f"engine exception: {e!r}", file=sys.stderr, flush=True)
                try:
                    self.engine.abort_all(f"engine exception: {e}")
                except Exception:
                    pass
                if self.devsrv is not None:
                    try:
                        self.devsrv.abort_all(f"engine exception: {e}")
                    except Exception:
                        pass
                self._drain_queue()
                n = 0
            if n == 0:
                self._drain_queue()
                time.sleep(idle_sleep)
