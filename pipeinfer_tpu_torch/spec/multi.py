"""Speculation × continuous batching: concurrent PipeInfer streams.

Copy of pipeinfer_tpu.spec.multi (which imports no JAX), over the port's
contexts and controller.

The reference serves one request per speculative pipeline (its
continuous-batching example, examples/parallel, runs WITHOUT speculation —
llama.cpp keeps the two features in separate drivers). Here the cell KV
cache's 64 sequence slots are carved into disjoint per-request namespaces
(stream i owns slots [base, base+stride): one committed slot + a branch
offset per in-flight run), so several async speculation controllers share
ONE target context and ONE draft context. The engine cooperatively ticks
each stream — pump speculation everywhere, retire whichever stream's
oldest run has landed — so device work from different requests interleaves
in the dispatch queue exactly like the single-stream pipeline's
microbatches do.

Requests hot-join and leave (the scheduler semantics of
examples/parallel/parallel.cpp:190-260); a finished stream's cells are
reclaimed with one fused seq_rm on each context.
"""

from __future__ import annotations

import itertools
import time
from collections import deque
from dataclasses import dataclass, field

from ..runtime.context import InferenceContext
from ..runtime.kv_cache import SEQ_WORDS
from ..sampling.samplers import SamplingParams
from .controller import PipeInferController
from .params import SpecParams

MAX_SEQS = 32 * SEQ_WORDS


@dataclass
class SpecRequest:
    """A queued/running speculative generation (ref: parallel.cpp client)."""

    id: int
    prompt_ids: list[int]
    n_predict: int
    sampling: SamplingParams | None = None
    stream: object = None  # callable(token) or None
    ignore_eos: bool = False
    grammar: object = None  # parsed GrammarState (server grammar parity)
    n_probs: int = 0  # record top-n (id, prob) per token into `probs`
    t_submit: float = field(default_factory=time.perf_counter)

    # filled by the engine
    ctrl: PipeInferController | None = None
    seq_base: int = -1
    tokens: list[int] = field(default_factory=list)
    probs: list = field(default_factory=list)
    done: bool = False
    error: str | None = None
    t_start: float = -1.0
    t_done: float = -1.0

    def cells_needed(self, sp: SpecParams) -> int:
        """Worst-case KV cells: committed stream + every in-flight run
        (host-chained trees, or R-round corrected runs — whichever the
        controller picks, budget the larger)."""
        scratch = sp.max_inflight * max(
            sp.n_parallel * sp.n_draft,
            max(1, sp.corr_rounds) * (sp.n_draft + 1),
        )
        return (
            len(self.prompt_ids)
            + self.n_predict
            + scratch
            + sp.n_draft  # draft-root redecode slack
        )


class MultiPipeInfer:
    """Cooperative engine multiplexing async PipeInfer streams over shared
    target/draft contexts.

    Each admitted request gets `stride = 1 + n_parallel * max_inflight`
    sequence slots; with the default SpecParams that is 4 slots → up to 16
    concurrent speculative streams per cache. Cells are a shared pool, so
    `n_cells` must budget for the sum of active contexts + trees.
    """

    def __init__(
        self,
        ctx_tgt: InferenceContext,
        ctx_dft: InferenceContext,
        sampling: SamplingParams,
        sp: SpecParams,
        *,
        eos_id: int = 2,
        max_streams: int | None = None,
        max_seqs: int | None = None,
    ):
        self.tgt = ctx_tgt
        self.dft = ctx_dft
        self.sampling = sampling
        self.sp = sp
        self.eos_id = eos_id
        self.stride = 1 + sp.n_parallel * sp.max_inflight
        # max_seqs < MAX_SEQS carves the upper sequence slots out for a
        # co-resident engine (the serving scheduler's device lanes)
        cap = (max_seqs or MAX_SEQS) // self.stride
        self.max_streams = min(max_streams, cap) if max_streams else cap
        self.free_bases: deque[int] = deque(
            i * self.stride for i in range(self.max_streams)
        )
        self.pending: deque[SpecRequest] = deque()
        self.active: list[SpecRequest] = []
        self._ids = itertools.count()
        self._rr = 0  # round-robin blocking pointer
        self._reserved = 0  # KV cells promised to admitted streams

    # -- request lifecycle ---------------------------------------------------

    def submit(
        self,
        prompt_ids: list[int],
        n_predict: int,
        *,
        sampling: SamplingParams | None = None,
        stream=None,
        ignore_eos: bool = False,
        grammar=None,
        n_probs: int = 0,
    ) -> SpecRequest:
        req = SpecRequest(
            id=next(self._ids),
            prompt_ids=list(prompt_ids),
            n_predict=n_predict,
            sampling=sampling,
            stream=stream,
            ignore_eos=ignore_eos,
            grammar=grammar,
            n_probs=n_probs,
        )
        self.pending.append(req)
        return req

    def cancel(self, req: SpecRequest):
        """Cooperative early stop (the server's stop-sequence path): a
        pending request is failed out of the queue; a running one stops at
        its next scheduling quantum and drains normally."""
        if req.done:
            return
        if req in self.pending:
            self.pending.remove(req)
            req.tokens = []
            req.done = True
            req.t_done = time.perf_counter()
            return
        if req.ctrl is not None:
            req.ctrl._stopped_flag = True

    def _admit(self):
        usable = min(self.tgt.n_cells, self.dft.n_cells) - 1
        while self.pending and self.free_bases:
            need = self.pending[0].cells_needed(self.sp)
            if need > usable:
                req = self.pending.popleft()
                req.error = (
                    f"prompt + n_predict + speculation scratch needs {need} "
                    f"KV cells, cache has {usable}"
                )
                req.done = True
                req.t_done = time.perf_counter()
                continue
            if self._reserved + need > usable:
                break  # wait for a running stream to release cells
            req = self.pending.popleft()
            self._reserved += need
            base = self.free_bases.popleft()
            sp_samp = req.sampling or self.sampling
            ctrl = PipeInferController(
                self.tgt,
                self.dft,
                sp_samp,
                self.sp,
                eos_id=self.eos_id,
                seq_base=base,
                offsets=deque(
                    base + 1 + i * self.sp.n_parallel
                    for i in range(self.sp.max_inflight)
                ),
                grammar=req.grammar,
            )
            req.ctrl = ctrl
            req.seq_base = base
            req.t_start = time.perf_counter()
            ctrl.start_generation(
                req.prompt_ids, req.n_predict,
                ignore_eos=req.ignore_eos, stream=req.stream,
                n_probs=req.n_probs,
            )
            self.active.append(req)

    def _maybe_finish(self, req: SpecRequest):
        if req.done or not req.ctrl.done:
            return
        req.tokens = req.ctrl.finish_generation()
        req.probs = req.ctrl.probs
        req.done = True
        req.t_done = time.perf_counter()
        # reclaim every slot in this stream's namespace (committed cells live
        # on seq_base; branch slots should already be clear, but a canceled
        # drain may leave stragglers)
        for s in range(req.seq_base, req.seq_base + self.stride):
            self.tgt.seq_rm(s)
            self.dft.seq_rm(s)
        self.active.remove(req)
        self.free_bases.append(req.seq_base)
        self._reserved -= req.cells_needed(self.sp)

    def abort_all(self, msg: str):
        """Fail every live stream and reset engine state (engine-thread
        exception recovery: waiting callers see .error, not a hang)."""
        for req in list(self.pending) + list(self.active):
            req.error = msg
            req.done = True
            req.t_done = time.perf_counter()
        self.pending.clear()
        for req in list(self.active):
            for s in range(req.seq_base, req.seq_base + self.stride):
                self.tgt.seq_rm(s)
                self.dft.seq_rm(s)
            self.free_bases.append(req.seq_base)
        self.active.clear()
        self._reserved = 0

    # -- scheduling ----------------------------------------------------------

    def step(self) -> bool:
        """One scheduling quantum. Pumps every stream without blocking; if
        nothing progressed (all device-bound), blocks on one stream
        round-robin. Returns True while work remains."""
        self._admit()
        progress = False
        for req in list(self.active):
            if req.ctrl.tick(block=False):
                progress = True
            self._maybe_finish(req)
        if not progress and self.active:
            req = self.active[self._rr % len(self.active)]
            self._rr += 1
            req.ctrl.tick(block=True)
            self._maybe_finish(req)
        self._admit()
        return bool(self.active or self.pending)

    def run_until_idle(self):
        while self.step():
            pass
