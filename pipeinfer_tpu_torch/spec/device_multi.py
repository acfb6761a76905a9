"""Batched device-resident speculation: S concurrent streams, R full
speculative rounds each, per dispatch.

Torch counterpart of pipeinfer_tpu.spec.device_multi. `spec/multi.py`
multiplexes async controllers over shared contexts — the right shape when
requests hot-join and leave and need the full host sampler chain. But
every stream's verification round-trips to the host there, and each
draft/verify step feeds the weights one row at a time. Here the streams
are batched inside the device-resident loop (spec/device_loop.py):

    per round, for all S streams at once:
      1. draft-chain `depth` tokens per stream — each chain step is one
         [S]-row decode (S rows through every weight tile instead of 1);
      2. one target pass over all S*(depth+1) stream-major rows;
      3. verify each stream on the device (greedy match, or Gumbel-max
         target sampling), commit per-stream prefixes + bonus, and roll
         back each stream's rejected cells (_rm_stream_tails: one
         membership test of the whole pool against the S slots);
      4. continue every stream from its own bonus token.

Streams that finish early are masked inactive at the next dispatch:
their rows become padding, which writes only to the trash cell (never
visible), and their device state freezes. (The JAX package gives inactive
lanes scratch cells with no sequence membership; the host mirror's seq_rm
frees every such row, so another engine sharing the pool could take a
cell that the lane's padding rows still write.)

The reference keeps speculation and continuous batching in separate
drivers (examples/speculative vs examples/parallel — see
examples/parallel/parallel.cpp:190-260 for its scheduler); this engine
composes both. `BatchedDeviceLoop.generate_many` serves one fixed batch of
requests; `DeviceLoopServer` lets requests hot-join and leave lanes.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..runtime import kv_cache as kv
from ..runtime.context import Batch, CacheFull, InferenceContext, h2d
from ..utils import trace
from .device_loop import MAX_INFLIGHT, check_engine_args, enqueue, supported
from .params import SpecParams, entropy_seed
from .sync_spec import SpecStats


def _rm_stream_tails(cache: kv.KVCache, bases: torch.Tensor, words: torch.Tensor,
                     bits: torch.Tensor) -> kv.KVCache:
    """Vectorized per-stream tail rollback: free every cell that belongs to
    stream s at pos >= bases[s], for all s at once, by one membership test
    of the pool against the S slots (words: each slot's word index, long
    [S]; bits: its bit as int32 [S], kv._bits_of). Loop-written cells are
    single-membership (each belongs to exactly its stream), so clearing
    the whole seq row of a hit cell is exact; committed prompt cells sit
    at pos < bases[s] and are never hit. (Per-seq counterpart of
    kv.rm_tail — ref: llama_kv_cache_seq_rm per seq, llama.cpp:9245-9268.)"""
    hit = (((cache.seq[:, words] & bits) != 0) & (cache.pos[:, None] >= bases)).any(dim=1)
    cache.seq.masked_fill_(hit[:, None], 0)
    cache.pos.masked_fill_(hit, -1)
    return cache


class _Lanes:
    """The S streams' sequence slots [seq_base, seq_base + S) on the
    device, and the per-round trim that rolls both caches back."""

    def __init__(self, dft: InferenceContext, tgt: InferenceContext, n: int, seq_base: int):
        self.seqs = torch.arange(seq_base, seq_base + n, dtype=torch.int32, device=tgt.device)
        self.words = (self.seqs // 32).long()
        self.bits = kv._bits_of(self.seqs)
        self.dft, self.tgt = dft, tgt

    def trim(self, new_bases: torch.Tensor) -> None:
        for cache in (self.dft.cache, self.tgt.cache):
            _rm_stream_tails(cache, new_bases, self.words, self.bits)


def _lane_cells(ctx: InferenceContext, active: np.ndarray, rounds: int, width: int) -> np.ndarray:
    """A dispatch's cells [R, S, width]: fresh ones for the active lanes,
    the trash cell for the inactive lanes' padding rows. May raise
    CacheFull (nothing is marked yet)."""
    cells = np.full((rounds, len(active), width), ctx.trash_cell, np.int64)
    cells[:, active] = ctx.find_cells(rounds * int(active.sum()) * width).reshape(rounds, -1, width)
    return cells


def _mark(ctx: InferenceContext, cells: np.ndarray, hint: int, seq_row) -> None:
    """Host-mirror hints for one lane's cells of a dispatch: monotone
    positions past its frontier (exact values reconciled at collect)."""
    flat = cells.reshape(-1)
    ctx.h_pos[flat] = hint + np.arange(len(flat))
    ctx.h_seq[flat] = seq_row


def _root_token(sampling, row, lane: int) -> int:
    """A stream's first token from its prefill row: the host sampler over
    the device chain (seeded runs fold the lane into the seed, so
    identical prompts in different lanes do not all start alike), or the
    sparse pack's top id."""
    if sampling.temp > 0:
        from ..sampling.samplers import SamplerState, sample

        if sampling.seed >= 0:
            sampling = dataclasses.replace(sampling, seed=sampling.seed + 1000003 * lane)
        return int(sample(SamplerState(params=sampling), row))
    return int(row.ids[0])


@dataclasses.dataclass
class _Stream:
    prompt_len: int
    n_predict: int
    tokens: list = dataclasses.field(default_factory=list)
    host_base: int = 0  # true committed frontier (host view)
    done: bool = False
    stats: SpecStats = dataclasses.field(default_factory=SpecStats)


class BatchedDeviceLoop:
    """S-stream device-resident speculative serving engine.

    Same support envelope as DeviceLoopEngine (single-device contexts;
    greedy or a pure (temp, top_k, top_p, min_p) chain shared by all
    streams); greedy outputs are bit-identical to decoding each request
    alone. Serve with a fixed stream count (pad the request list to S;
    extra slots finish instantly). Stream s uses sequence slot s."""

    def __init__(
        self,
        ctx_tgt: InferenceContext,
        ctx_dft: InferenceContext,
        sampling,
        sp: SpecParams,
        *,
        n_streams: int,
        eos_id: int = 2,
        rounds: int = 4,
    ):
        check_engine_args("BatchedDeviceLoop", ctx_tgt, ctx_dft, sampling, "spec.multi")
        if n_streams < 1 or n_streams > 32 * kv.SEQ_WORDS:
            raise ValueError(f"n_streams must be in [1, {32 * kv.SEQ_WORDS}]")
        self.tgt = ctx_tgt
        self.dft = ctx_dft
        self.sampling = sampling
        self.sp = sp
        self.S = n_streams
        self.eos_id = eos_id
        self.rounds = rounds
        self._seed_base = entropy_seed(sampling.seed if sampling.seed >= 0 else None)
        self.t_prefill = 0.0
        self.t_decode = 0.0

    def generate_many(self, prompts, n_predicts, *, ignore_eos=False):
        """Decode all S requests to completion; returns S token lists.
        prompts: S token lists; n_predicts: int or S ints."""
        S, R, depth = self.S, self.rounds, self.sp.n_draft
        if len(prompts) != S:
            raise ValueError(f"need exactly {S} prompts (pad the batch)")
        for s, p in enumerate(prompts):
            # an empty prompt would silently read the PREVIOUS stream's
            # last prefill row (ends = cumsum(lens)-1)
            if len(p) == 0:
                raise ValueError(f"stream {s}: empty prompt")
        if isinstance(n_predicts, int):
            n_predicts = [n_predicts] * S

        t0 = time.perf_counter()
        # prefill ALL streams in one batch per model (each into its own
        # sequence slot): one draft dispatch (KV only) + one target
        # dispatch + one fetch
        bt, bd = Batch(), Batch()
        for s, prompt in enumerate(prompts):
            for i, t in enumerate(prompt):
                last = i == len(prompt) - 1
                bt.add(t, i, s, want_logits=last)
                bd.add(t, i, s, want_logits=last)
        self.dft.decode_async(bd, topk=min(128, self.dft.cfg.n_vocab))
        rows = self.tgt.decode(bt, topk=min(128, self.tgt.cfg.n_vocab))
        ends = np.cumsum([len(p) for p in prompts]) - 1
        streams: list[_Stream] = []
        roots = np.zeros(S, np.int32)
        bases = np.zeros(S, np.int32)
        for s, prompt in enumerate(prompts):
            root = _root_token(self.sampling, rows[ends[s]], s)
            st = _Stream(prompt_len=len(prompt), n_predict=n_predicts[s],
                         host_base=len(prompt))
            st.tokens.append(root)
            st.stats.n_predict = 1
            if n_predicts[s] <= 1 or (not ignore_eos and root == self.eos_id):
                st.done = True
            streams.append(st)
            roots[s], bases[s] = root, len(prompt)
        self.t_prefill = time.perf_counter() - t0

        lanes = _Lanes(self.dft, self.tgt, S, 0)
        dev = self.tgt.device
        roots_dev, bases_dev = h2d(roots, dev), h2d(bases, dev)
        key_i = 0
        t_dec0 = time.perf_counter()
        inflight = []  # (handle, active [S], dcells, tcells)

        def dispatch() -> bool:
            nonlocal roots_dev, bases_dev, key_i
            active = np.array([not st.done for st in streams])
            if not active.any():
                return False
            # skip dispatch when in-flight packs' upper bound already covers
            # every live stream (tail-waste guard, see device_loop)
            bound = len(inflight) * R * (depth + 1)
            if inflight and all(st.done or len(st.tokens) + bound >= st.n_predict
                                for st in streams):
                return False
            try:
                dcells = _lane_cells(self.dft, active, R, depth)
                tcells = _lane_cells(self.tgt, active, R, depth + 1)
            except CacheFull:
                return False
            for s in np.nonzero(active)[0]:
                hint = streams[s].host_base + len(inflight) * R * (depth + 1)
                _mark(self.dft, dcells[:, s], hint, kv.host_only(s))
                _mark(self.tgt, tcells[:, s], hint, kv.host_only(s))
            handle, roots_dev, bases_dev = enqueue(
                self.dft, self.tgt, roots_dev, bases_dev, lanes.seqs, dcells, tcells,
                sampling=self.sampling, seed=self._seed_base * 9176 + key_i,
                active=h2d(active, dev), trim=lanes.trim)
            key_i += 1
            inflight.append((handle, active, dcells, tcells))
            return True

        while any(not st.done for st in streams) or inflight:
            while len(inflight) < MAX_INFLIGHT and dispatch():
                pass
            if not inflight:
                if any(not st.done for st in streams):
                    raise RuntimeError(
                        "batched device loop could not dispatch (KV cache too small)")
                break
            handle, active, dcells, tcells = inflight.pop(0)
            host_pack = handle.fetch()  # [R, S, depth+2]
            for s, st in enumerate(streams):
                if not active[s]:
                    continue  # padding rows on the trash cell
                st.stats.n_rounds += R
                for r in range(R):
                    m = int(host_pack[r, s, depth + 1])
                    st.stats.n_drafted += depth
                    # reconcile mirrors with device truth for EVERY active
                    # stream — the device committed these rounds whether or
                    # not the host has already retired the stream
                    kv.reclaim_cells(self.dft, dcells[r, s], min(m + 1, depth),
                                     st.host_base, s)
                    kv.reclaim_cells(self.tgt, tcells[r, s], m + 1, st.host_base, s)
                    st.host_base += m + 1
                    if st.done:
                        # rounds after the stream retired are tail waste, not
                        # accepts (accept_rate_decided stays <= 1)
                        st.stats.n_drafted_unverified += depth
                        continue
                    st.stats.n_accept += m
                    for t in host_pack[r, s, : m + 1].tolist():
                        st.tokens.append(t)
                        if len(st.tokens) >= st.n_predict or (
                                not ignore_eos and t == self.eos_id):
                            st.done = True
                            break

        # trim device + host state back to each stream's final frontier
        for s, st in enumerate(streams):
            st.tokens = st.tokens[: st.n_predict]
            st.stats.n_predict = len(st.tokens)
            final = st.prompt_len + len(st.tokens)
            self.tgt.seq_rm(s, final, -1)
            self.dft.seq_rm(s, final, -1)
        self.t_decode = time.perf_counter() - t_dec0
        self.streams = streams
        return [st.tokens for st in streams]


@dataclasses.dataclass
class LaneHandle:
    """Serving-side handle for one DeviceLoopServer request."""

    prompt_ids: list
    n_predict: int
    on_token: object = None  # callable(tok) per committed token
    ignore_eos: bool = False
    tokens: list = dataclasses.field(default_factory=list)
    done: bool = False
    error: str | None = None
    cancel: bool = False  # cooperative early stop (server stop sequences)
    stats: SpecStats = dataclasses.field(default_factory=SpecStats)
    rid: int = -1  # the serving request's id, under which the tracer stamps it
    # internal lane binding
    _lane: int = -1
    _host_base: int = 0
    _retiring: bool = False  # done, waiting for in-flight packs to drain


class DeviceLoopServer:
    """Continuous-batching server over the S-lane batched device loop.

    BatchedDeviceLoop decodes one fixed batch to completion; serving needs
    requests to hot-join and leave. This wrapper drives the same loop
    incrementally from a scheduler `step()`: a finished lane's sequence
    slot is reclaimed and reseeded with the next queued request WITHOUT
    stopping the other lanes — lanes retire and join by flipping the
    dispatch-time `active` mask, and the chained (roots, bases) device
    vectors get lane-wise updates (a masked `where`, no host round trip).
    The counterpart of the reference server's slot scheduler (ref:
    examples/server/server.cpp:377-463 slot reuse;
    examples/parallel/parallel.cpp:238-274 hot-join).

    Sampler envelope = device_loop.supported with ONE chain for all lanes
    (greedy by default); the serving scheduler routes anything else to the
    host-verified MultiPipeInfer engine. Lanes own sequence slots
    [seq_base, seq_base + n_lanes), so both engines can share the same
    contexts with disjoint slot namespaces.

    Admission reserves one pool's worth of dispatch scratch,
    MAX_INFLIGHT * rounds * S * (2 * n_draft + 1) cells (what the in-flight
    dispatches can hold), on top of each running lane's remaining budget —
    where the JAX package reserves a per-lane share, which can overcommit
    a tightly sized pool.
    """

    MAX_INFLIGHT = MAX_INFLIGHT

    def __init__(
        self,
        ctx_tgt: InferenceContext,
        ctx_dft: InferenceContext,
        sampling,
        sp: SpecParams,
        *,
        n_lanes: int,
        seq_base: int = 0,
        eos_id: int = 2,
        rounds: int = 4,
    ):
        check_engine_args("DeviceLoopServer", ctx_tgt, ctx_dft, sampling, "spec.multi")
        if n_lanes < 1 or seq_base + n_lanes > 32 * kv.SEQ_WORDS:
            raise ValueError(
                f"lanes [{seq_base}, {seq_base + n_lanes}) exceed "
                f"{32 * kv.SEQ_WORDS} sequence slots"
            )
        self.tgt = ctx_tgt
        self.dft = ctx_dft
        self.sampling = sampling
        self.sp = sp
        self.S = n_lanes
        self.seq_base = seq_base
        self.eos_id = eos_id
        self.rounds = rounds
        self._seed_base = entropy_seed(sampling.seed if sampling.seed >= 0 else None)
        self._key_i = 0
        self.lanes: list[LaneHandle | None] = [None] * n_lanes
        self.queue: list[LaneHandle] = []
        self.inflight: list = []  # (handle, active [S], dcells, tcells)
        # per-lane count of in-flight packs that carry the lane as active:
        # a lane may only be reseeded (or its seq trimmed) once quiescent
        self._lane_inflight = np.zeros(n_lanes, np.int64)
        self._slots = _Lanes(ctx_dft, ctx_tgt, n_lanes, seq_base)
        self.roots_dev = torch.zeros(n_lanes, dtype=torch.int32, device=ctx_tgt.device)
        self.bases_dev = torch.zeros(n_lanes, dtype=torch.int32, device=ctx_tgt.device)

    @property
    def scratch(self) -> int:
        """Cells the in-flight dispatches can hold at once."""
        return self.MAX_INFLIGHT * self.rounds * self.S * (2 * self.sp.n_draft + 1)

    # -- routing ------------------------------------------------------------

    def compatible(self, sampling) -> bool:
        """Can this request ride the server's device chain? Greedy requests
        match a greedy server; stochastic requests must match the chain
        tuple exactly and be unseeded (per-request seeds are only exactly
        reproducible on the host path)."""
        if not supported(sampling):
            return False
        if self.sampling.temp <= 0:
            return sampling.temp <= 0
        if sampling.temp <= 0 or sampling.seed >= 0:
            return False
        from .fused import draft_samp

        return draft_samp(sampling) == draft_samp(self.sampling)

    # -- request lifecycle ---------------------------------------------------

    def submit(self, prompt_ids, n_predict, *, on_token=None,
               ignore_eos=False, rid: int = -1) -> LaneHandle:
        if not prompt_ids:
            raise ValueError("empty prompt")
        h = LaneHandle(prompt_ids=list(prompt_ids), n_predict=n_predict,
                       on_token=on_token, ignore_eos=ignore_eos, rid=rid)
        self.queue.append(h)
        return h

    @property
    def busy(self) -> bool:
        return bool(self.queue) or bool(self.inflight) or any(
            h is not None for h in self.lanes
        )

    # -- engine step ---------------------------------------------------------

    def step(self, block: bool = False) -> int:
        """One scheduler iteration: collect ready packs, retire quiescent
        lanes, admit queued requests, dispatch. Non-blocking by default
        (returns 0 when only waiting on an in-flight fetch); block=True
        waits for the oldest pack instead of spinning."""
        progress = 0
        for h in self.lanes:  # canceled lanes retire at the step boundary
            if h is not None and h.cancel:
                h._retiring = True
        for h in list(self.queue):
            if h.cancel:
                self.queue.remove(h)
                h.done = True
        progress += self._collect(block=block)
        with trace.span("lanes.retire") if trace.on else trace.OFF:
            self._retire_quiescent()
        if self.queue:
            progress += self._admit()
        while len(self.inflight) < self.MAX_INFLIGHT and self._dispatch():
            progress += 1
        return progress

    def run_until_idle(self):
        while self.busy:
            made = self.step(block=True)
            if made == 0 and not self.inflight and self.queue and all(
                h is None for h in self.lanes
            ):
                raise RuntimeError(
                    "device loop server could not admit (KV cache too small)"
                )

    # -- internals -----------------------------------------------------------

    def _admit(self) -> int:
        """Seed queued requests into free quiescent lanes: one batched
        prefill per model for ALL admissions this step (the
        BatchedDeviceLoop prefill shape), then lane-wise (roots, bases)
        device updates."""
        with trace.span("lanes.admit") if trace.on else trace.OFF as sp:
            with trace.span("lanes.admit.plan") if trace.on else trace.OFF:
                take, free = self._plan_admission()
            if not take:
                return 0
            if trace.on:
                sp.note(rid=take[0].rid if len(take) == 1 else -1,
                        args=(("rids", tuple(h.rid for h in take)),
                              ("prompt_lens", tuple(len(h.prompt_ids) for h in take))))
                for h in take:
                    trace.stamp(h.rid, "admit", getattr(sp, "t0", None))

            with trace.span("lanes.admit.enqueue") if trace.on else trace.OFF:
                bt, bd = Batch(), Batch()
                for h, lane in zip(take, free):
                    seq = self.seq_base + lane
                    self.tgt.seq_rm(seq, 0, -1)
                    self.dft.seq_rm(seq, 0, -1)
                    for i, t in enumerate(h.prompt_ids):
                        last = i == len(h.prompt_ids) - 1
                        bt.add(t, i, seq, want_logits=last)
                        bd.add(t, i, seq, want_logits=last)
                try:
                    self.dft.decode_async(bd, topk=min(128, self.dft.cfg.n_vocab))
                    pending = self.tgt.decode_async(bt, topk=min(128, self.tgt.cfg.n_vocab))
                except CacheFull:
                    # admission raced another engine on the shared pool: requeue
                    for h, lane in zip(take, free):
                        self.tgt.seq_rm(self.seq_base + lane, 0, -1)
                        self.dft.seq_rm(self.seq_base + lane, 0, -1)
                    self.queue = take + self.queue
                    return 0
            with trace.span("lanes.admit.wait") if trace.on else trace.OFF:
                rows = pending.fetch()
            ends = np.cumsum([len(h.prompt_ids) for h in take]) - 1

            mask = np.zeros(self.S, bool)
            roots = np.zeros(self.S, np.int32)
            bases = np.zeros(self.S, np.int32)
            for j, (h, lane) in enumerate(zip(take, free)):
                root = _root_token(self.sampling, rows[ends[j]], lane)
                h.tokens.append(root)
                h.stats.n_predict = 1
                if h.on_token:
                    h.on_token(root)
                h._lane = lane
                h._host_base = len(h.prompt_ids)
                if h.n_predict <= 1 or (not h.ignore_eos and root == self.eos_id):
                    h._retiring = True
                self.lanes[lane] = h
                mask[lane], roots[lane], bases[lane] = True, root, len(h.prompt_ids)

            # lane-wise update of the chained device vectors (no fetch: a
            # masked where keeps the dispatch pipeline asynchronous)
            dev = self.tgt.device
            mask_d = h2d(mask, dev)
            self.roots_dev = torch.where(mask_d, h2d(roots, dev), self.roots_dev)
            self.bases_dev = torch.where(mask_d, h2d(bases, dev), self.bases_dev)
            self._retire_quiescent()
            return len(take)

    def _plan_admission(self) -> tuple[list, list]:
        """(queued requests to admit, free quiescent lanes for them) within
        the cell budget; fails the requests no pool could hold."""
        free = [
            i for i, h in enumerate(self.lanes)
            if h is None and self._lane_inflight[i] == 0
        ]
        take = []
        if not free:
            return take, free
        usable = min(self.tgt.n_cells, self.dft.n_cells) - 1
        # free cells minus the running lanes' OUTSTANDING growth (every
        # running lane will still commit its remaining n_predict) and one
        # pool's worth of dispatch scratch: admitting against the
        # instantaneous count overcommits the pool and livelocks _dispatch
        # (CacheFull forever, no lane can retire to free cells)
        scratch = self.scratch
        outstanding = scratch + sum(
            max(0, h.n_predict - len(h.tokens)) for h in self.lanes if h is not None)
        free_cells = int((self.tgt.h_pos < 0).sum()) - 1 - outstanding
        for h in list(self.queue):
            if len(take) >= len(free):
                break
            need = len(h.prompt_ids) + h.n_predict
            if need + scratch > usable:
                self.queue.remove(h)
                h.error = (f"prompt + n_predict needs {need} KV cells beside {scratch} "
                           f"of dispatch scratch, cache has {usable}")
                h.done = True
                continue
            if need > free_cells:
                break  # wait for running lanes to release cells
            free_cells -= need
            self.queue.remove(h)
            take.append(h)
        return take, free

    def _dispatch(self) -> bool:
        live = [
            h is not None and not h._retiring and len(h.tokens) < h.n_predict
            for h in self.lanes
        ]
        if not any(live):
            return False
        R, depth = self.rounds, self.sp.n_draft
        bound = len(self.inflight) * R * (depth + 1)
        if self.inflight and all(
            (not lv) or len(h.tokens) + bound >= h.n_predict
            for lv, h in zip(live, self.lanes)
        ):
            return False
        with trace.span("lanes.dispatch") if trace.on else trace.OFF as sp:
            active = np.array(live)
            with trace.span("lanes.dispatch.cells") if trace.on else trace.OFF:
                try:
                    dcells = _lane_cells(self.dft, active, R, depth)
                    tcells = _lane_cells(self.tgt, active, R, depth + 1)
                except CacheFull:
                    return False
                for lane in np.nonzero(active)[0]:
                    hint = self.lanes[lane]._host_base + len(self.inflight) * R * (depth + 1)
                    seq_row = kv.host_only(self.seq_base + lane)
                    _mark(self.dft, dcells[:, lane], hint, seq_row)
                    _mark(self.tgt, tcells[:, lane], hint, seq_row)
            with trace.span("lanes.dispatch.enqueue") if trace.on else trace.OFF:
                handle, self.roots_dev, self.bases_dev = enqueue(
                    self.dft, self.tgt, self.roots_dev, self.bases_dev, self._slots.seqs,
                    dcells, tcells, sampling=self.sampling,
                    seed=self._seed_base * 9176 + self._key_i,
                    active=h2d(active, self.tgt.device), trim=self._slots.trim)
            self._key_i += 1
            self.inflight.append((handle, active, dcells, tcells))
            self._lane_inflight[active] += 1
            if trace.on:
                sp.note(args=(("bases", tuple(h._host_base for h, lv in zip(self.lanes, live)
                                              if lv)),
                              ("lane_rounds", self.S * R),
                              ("live_lane_rounds", int(active.sum()) * R)))
        return True

    def _collect(self, block: bool = False) -> int:
        n_committed = 0
        R, depth = self.rounds, self.sp.n_draft
        with trace.span("lanes.collect") if trace.on else trace.OFF:
            while self.inflight and (block or self.inflight[0][0].ready()):
                block = False  # only block for the oldest pack
                handle, active, dcells, tcells = self.inflight.pop(0)
                with trace.span("lanes.collect.wait") if trace.on else trace.OFF:
                    host_pack = handle.fetch()  # [R, S, depth+2]
                if trace.on:  # this pack's dev.dispatch has completed with it
                    trace.resolve_ready()
                with trace.span("lanes.commit") if trace.on else trace.OFF as sp:
                    discarded = 0
                    for lane in np.nonzero(active)[0]:
                        h = self.lanes[lane]
                        self._lane_inflight[lane] -= 1
                        seq = self.seq_base + lane
                        h.stats.n_rounds += R
                        for r in range(R):
                            m = int(host_pack[r, lane, depth + 1])
                            h.stats.n_drafted += depth
                            kv.reclaim_cells(self.dft, dcells[r, lane], min(m + 1, depth),
                                             h._host_base, seq)
                            kv.reclaim_cells(self.tgt, tcells[r, lane], m + 1, h._host_base,
                                             seq)
                            h._host_base += m + 1
                            if h._retiring:
                                h.stats.n_drafted_unverified += depth
                                discarded += 1
                                continue
                            h.stats.n_accept += m
                            for t in host_pack[r, lane, : m + 1].tolist():
                                h.tokens.append(t)
                                n_committed += 1
                                if h.on_token:
                                    h.on_token(t)
                                if len(h.tokens) >= h.n_predict or (
                                        not h.ignore_eos and t == self.eos_id):
                                    h._retiring = True
                                    break
                    if trace.on:
                        sp.note(args=(("retiring_lane_rounds", discarded),))
        return n_committed

    def abort_all(self, msg: str):
        """Fail every queued and in-flight request (engine-fault path):
        waiting callers see .error instead of hanging forever."""
        for h in self.queue + [h for h in self.lanes if h is not None]:
            h.error = msg
            h.done = True
        self.queue = []
        for lane in range(self.S):
            if self.lanes[lane] is not None:
                self.tgt.seq_rm(self.seq_base + lane, 0, -1)
                self.dft.seq_rm(self.seq_base + lane, 0, -1)
                self.lanes[lane] = None
        self.inflight = []
        self._lane_inflight[:] = 0

    def _retire_quiescent(self):
        """Free lanes whose stream finished AND whose in-flight packs have
        all been collected — only then is the seq-slot trim safe (an
        in-flight pack dispatched while the lane was live will still
        commit cells to its sequence)."""
        for lane, h in enumerate(self.lanes):
            if h is None or not h._retiring or self._lane_inflight[lane]:
                continue
            h.tokens = h.tokens[: h.n_predict]
            h.stats.n_predict = len(h.tokens)
            seq = self.seq_base + lane
            # full clear (not a frontier trim): the request is done, and
            # its cells go back to the pool shared with the host-verified
            # engine (BatchScheduler._finish does the same)
            self.tgt.seq_rm(seq, 0, -1)
            self.dft.seq_rm(seq, 0, -1)
            self.lanes[lane] = None
            h.done = True
