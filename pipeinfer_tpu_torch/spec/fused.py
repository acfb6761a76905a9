"""Fused speculative run: draft chain + target verify with no host round
trip between them.

Torch counterpart of pipeinfer_tpu.spec.fused. The host-side reference pays
`depth` draft decodes plus a target dispatch plus a logits fetch per
speculative run (ref: start_async_spec_run speculative.cpp:881-1180, :1163
begin_async_run). Here a run is enqueued on the device in one go
(runtime.context.fused_spec): the draft chain's tokens feed the target's
batch decode on the device, and one non-blocking copy brings back a
combined row pack (target sparse logits ++ chain token). The next run
chains from the previous run's last token as a DEVICE scalar, so
back-to-back runs keep the device busy with no host synchronization on the
critical path.

Constraints (the controller falls back to the host drafting path
otherwise): single-branch trees (n_parallel == 1), no grammar, no
repetition penalties, single-device contexts, and no early stop-drafting
gate — a fused chain is fixed-depth, and misprediction cost is carried by
cancellation and the dead-work meter instead of the reference's p_accept
trimming (README.md:199-201 tuning guidance)."""

from __future__ import annotations

import numpy as np
import torch

from ..runtime import kv_cache as kv
from ..runtime.context import (AsyncHandle, InferenceContext, device_generator, fused_spec, h2d,
                               single_device, to_host_async, unpack_sparse)


def supported(ctrl) -> bool:
    """Can this controller use fused runs? Greedy and stochastic samplers
    qualify (temp>0 drafts on the device via the Gumbel chain; verification
    samples the target on the host either way, so output correctness never
    depends on the draft sampler)."""
    s = ctrl.sampling
    no_penalties = (
        s.penalty_last_n == 0
        or (s.penalty_repeat == 1.0 and s.penalty_freq == 0.0 and s.penalty_present == 0.0)
    )
    return (
        ctrl.sp.n_parallel == 1
        and ctrl.topk is not None
        and ctrl.sampler.grammar is None
        and no_penalties
        and single_device(ctrl.tgt, ctrl.dft)
    )


def draft_samp(sampling) -> tuple | None:
    """The device draft-sampler config for a SamplingParams, or None for
    greedy (temp<=0)."""
    if sampling.temp <= 0:
        return None
    return (float(sampling.temp), int(sampling.top_k),
            float(sampling.top_p), float(sampling.min_p))


def launch(
    dft: InferenceContext,
    tgt: InferenceContext,
    *,
    root,  # int or device int32 scalar (previous run's last chain token)
    spec_base: int,
    offset: int,
    depth: int,
    topk: int,
    src_seq: int = 0,  # seq whose prefix cells the run's branch seq shares
    samp: tuple | None = None,  # (temp, top_k, top_p, min_p) or None=greedy
    seed: int = 0,  # per-run generator seed (stochastic drafting only)
):
    """Enqueue one fused speculative run. Returns (handle, next_root_dev).

    handle.fetch() -> (target SparseLogits list, chain tokens list).
    next_root_dev is the last chain token as a device scalar for chaining
    the next run without a host sync."""
    seq_row = kv.host_only(offset)

    dcells = dft.find_cells(depth)
    dft.h_pos[dcells] = (spec_base - 1) + np.arange(depth)
    dft.h_seq[dcells] = seq_row

    tcells = tgt.find_cells(depth)
    tpos = (spec_base + np.arange(depth)).astype(np.int32)
    tgt.h_pos[tcells] = tpos
    tgt.h_seq[tcells] = seq_row
    dft._refresh_hot()
    tgt._refresh_hot()
    seq_bits = np.broadcast_to(seq_row, (depth, kv.SEQ_WORDS)).copy().view(np.int32)

    out = fused_spec(
        dft, tgt, root, dpos0=spec_base - 1, seq_id=offset,
        dcells=h2d(dcells.astype(np.int32), dft.device),
        tpos=h2d(tpos, tgt.device), tcells=h2d(tcells.astype(np.int32), tgt.device),
        tseq_bits=h2d(seq_bits, tgt.device), src_seq=src_seq, topk=topk, samp=samp,
        gen=device_generator(dft.device, seed) if samp is not None else None,
    )
    col = 2 * topk + 1
    next_root = out[depth - 1, col].to(torch.int32)  # device scalar, no fetch
    host, event = to_host_async(out)

    def decode(_topk=topk, _d=depth, _col=col):
        arr = host.numpy()
        logits = [unpack_sparse(arr[i], _topk) for i in range(_d)]
        return logits, arr[:, _col].astype(np.int32).tolist()

    handle = AsyncHandle(logits=out, decode=decode, cells=tcells, event=event)
    return handle, next_root


class ChainBuf:
    """Assumed-continuation tokens [chain_base, spec_base). Fused runs
    contribute PENDING segments whose token values are still in flight;
    values resolve through the owning run's eager fetch."""

    def __init__(self):
        self.segs: list = []  # list[int] | AsyncRun-like (owner of a segment)
        self.lens: list[int] = []
        self.skip = 0  # consumed tokens in the first segment

    def __len__(self):
        return sum(self.lens) - self.skip

    def clear(self):
        self.segs, self.lens, self.skip = [], [], 0

    def extend_host(self, toks: list[int]):
        if toks:
            self.segs.append(list(toks))
            self.lens.append(len(toks))

    def extend_run(self, run, n: int):
        if n:
            self.segs.append(run)
            self.lens.append(n)

    @staticmethod
    def _seg_tokens(seg):
        if isinstance(seg, list):
            return seg
        return run_tokens(seg)  # materializes (blocks only if still in flight)

    @staticmethod
    def _seg_resolved(seg):
        if isinstance(seg, list):
            return True
        return seg.branches[0].tokens is not None or seg.handle.ready()

    def head_if_resolved(self):
        """First unconsumed token, or None if its value is still in flight."""
        if not self.segs:
            return None
        if not self._seg_resolved(self.segs[0]):
            return None
        return self._seg_tokens(self.segs[0])[self.skip]

    def pop_front(self):
        self.skip += 1
        if self.skip >= self.lens[0]:
            self.segs.pop(0)
            self.lens.pop(0)
            self.skip = 0

    def view(self) -> "ChainView":
        return ChainView(list(self.segs), list(self.lens), self.skip)

    def __iter__(self):
        """Materializing iteration (host paths only — penalties/grammar)."""
        for i, seg in enumerate(self.segs):
            toks = self._seg_tokens(seg)
            start = self.skip if i == 0 else 0
            yield from toks[start:]


class ChainView:
    """Immutable snapshot of a ChainBuf — a run's assumed prefix. Values
    materialize lazily; indexing a position whose owner run is still in
    flight blocks until its fetch lands (callers only index positions
    already committed, whose owners have retired)."""

    def __init__(self, segs, lens, skip):
        self.segs, self.lens, self.skip = segs, lens, skip
        self._total = sum(lens) - skip

    def __len__(self):
        return self._total

    def __getitem__(self, i):
        if i < 0 or i >= self._total:
            raise IndexError(i)
        i += self.skip
        for seg, n in zip(self.segs, self.lens):
            if i < n:
                return ChainBuf._seg_tokens(seg)[i]
            i -= n
        raise IndexError(i)

    def maybe(self, i):
        """Non-blocking __getitem__: None if the owning run's tokens are
        still in flight. Cancellation checks use this so comparing an
        assumed prefix never stalls the pipeline on a pending segment —
        the decision defers to a later check (every retire re-checks, and
        verification never commits unvetted tokens)."""
        if i < 0 or i >= self._total:
            raise IndexError(i)
        i += self.skip
        for seg, n in zip(self.segs, self.lens):
            if i < n:
                if not ChainBuf._seg_resolved(seg):
                    return None
                return ChainBuf._seg_tokens(seg)[i]
            i -= n
        raise IndexError(i)

    def __iter__(self):
        for i in range(self._total):
            yield self[i]


def run_tokens(run) -> list[int]:
    """Materialize a fused run's chain tokens (idempotent; the eager fetch
    caches its result in the handle's future)."""
    br = run.branches[0]
    if br.tokens is None:
        _, toks = run.handle.fetch()
        br.tokens = list(toks)
        br.i_batch_tgt = list(range(len(toks)))
    return br.tokens
