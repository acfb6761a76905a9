"""Device-resident speculative decode: R full speculative rounds per
dispatch, with verification and the continuation decision on the device.

Torch counterpart of pipeinfer_tpu.spec.device_loop. The async controller
(spec/controller.py) mirrors the reference's host-driven state machine:
the host drafts and launches runs, fetches logits, verifies, and cancels
stale work (ref: examples/speculative/speculative.cpp main loop
:316-679). On one device the whole speculative loop can stay on the
device instead:

    per round (R rounds enqueued back to back, no host sync inside):
      1. draft-chain `depth` tokens from the current root (draft model);
      2. batch-decode [root ++ drafted] on the target — one weight pass;
      3. verify on the device: greedy mode compares drafted tokens with
         the target argmax; stochastic mode samples the target row-wise
         through the user's (temp, top_k, top_p, min_p) chain by Gumbel-max
         (every committed token is a true target sample, so the output
         distribution equals sequential sampling);
      4. commit the matched prefix + the bonus token, free the rejected
         rows' cells by index, and continue the next round from the bonus
         token.

The round body is spec/corrected.py's (spec_round). A dispatch returns a
[R, depth+2] pack (committed tokens + accept count per round) plus the
chained (root, base) device scalars, so back-to-back dispatches never wait
on a host fetch. No round drafts from a diverged assumption, and the host
touches the loop once per R rounds. The caches are updated in place (the
JAX package donated them through jit).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..runtime import kv_cache as kv
from ..runtime.context import (AsyncHandle, Batch, CacheFull, InferenceContext, dev_scalar,
                               device_generator, h2d, single_device, to_host_async)
from . import corrected
from .params import SpecParams, entropy_seed
from .sync_spec import SpecStats

MAX_INFLIGHT = 2  # dispatches in flight per engine


def supported(sampling, grammar=None) -> bool:
    """Single-sequence, stateless-sampler generations only: greedy, or a
    pure (temp, top_k, top_p, min_p) chain — penalties/mirostat/grammar
    keep the async controller's host verification. Stochastic mode samples
    the TARGET on the device through the same chain, so top_k must be a
    real bound (the device sampler works within the top-64 candidates) and
    tfs/typical must be off."""
    no_pen = sampling.penalty_last_n == 0 or (
        sampling.penalty_repeat == 1.0
        and sampling.penalty_freq == 0.0
        and sampling.penalty_present == 0.0
    )
    base_ok = (
        no_pen
        and sampling.mirostat == 0
        and not sampling.logit_bias
        and grammar is None
    )
    if not base_ok:
        return False
    if sampling.temp <= 0:
        return True
    return (
        0 < sampling.top_k <= 64
        and sampling.tfs_z >= 1.0
        and sampling.typical_p >= 1.0
    )


def check_engine_args(name: str, ctx_tgt, ctx_dft, sampling, fallback: str) -> None:
    """The device engines' shared refusal: one-device InferenceContexts
    (as spec/corrected.py::supported tests them) and a sampler chain the
    device verifier expresses."""
    if not single_device(ctx_tgt, ctx_dft):
        raise ValueError(f"{name} needs single-device contexts")
    if not supported(sampling):
        raise ValueError(f"sampler chain needs host verification; use {fallback}")


def device_rounds(dft: InferenceContext, tgt: InferenceContext, roots, bases, seqs,
                  dcells: torch.Tensor, tcells: torch.Tensor, *, active=None,
                  samp: tuple | None = None, tsample: bool = False, gen=None, trim=None):
    """R speculative rounds for S streams, enqueued back to back:
    dcells [R, S, depth], tcells [R, S, depth+1]; roots / bases / seqs
    int32 [S]; active bool [S] or None (see corrected.spec_round).
    trim(new_bases) rolls back the rejected rows after each round (default:
    corrected.drop_rejected, by index).

    Returns (pack int32 [R, S, depth+2], roots, bases): per round and
    stream, m accepted tokens ++ the bonus at column m ++ zeros, then m;
    the last round's (bonus, base) device vectors chain the next dispatch."""
    rows = []
    for r in range(dcells.shape[0]):
        toks, _, m, bonus, new_bases = corrected.spec_round(
            dft, tgt, roots, bases, seqs, dcells[r], tcells[r], active=active, samp=samp,
            tsample=tsample, gen=gen)
        if trim is None:
            corrected.drop_rejected(dft, tgt, dcells[r], tcells[r], m)
        else:
            trim(new_bases)
        rows.append(torch.cat([corrected.commit_rows(toks, m, bonus),
                               m[:, None].to(torch.int32)], dim=1))
        roots, bases = bonus, new_bases
    return torch.stack(rows), roots, bases


def enqueue(dft: InferenceContext, tgt: InferenceContext, roots, bases, seqs, dcells: np.ndarray,
            tcells: np.ndarray, *, sampling, seed: int, active=None, trim=None):
    """Enqueue one dispatch of device_rounds over host-allocated cells
    (whose mirrors the caller has marked) and start its non-blocking fetch.
    Returns (handle, roots, bases): handle.fetch() -> pack [R, S, depth+2].
    The cache's hot window is refreshed from the mirrors first, so it
    covers every cell the dispatch writes."""
    from .fused import draft_samp

    dft._refresh_hot()
    tgt._refresh_hot()
    samp = draft_samp(sampling)
    pack, roots, bases = device_rounds(
        dft, tgt, roots, bases, seqs, h2d(dcells.astype(np.int32), dft.device),
        h2d(tcells.astype(np.int32), tgt.device), active=active, samp=samp,
        tsample=sampling.temp > 0, trim=trim,
        gen=device_generator(tgt.device, seed) if samp is not None else None)
    host, event = to_host_async(pack)
    return AsyncHandle(logits=pack, decode=host.numpy, cells=tcells, event=event), roots, bases


class DeviceLoopEngine:
    """Single-device speculative decode engine with the verify loop on the
    device.

    Same model pair and golden-token semantics as the controller (greedy
    output is bit-identical to plain decoding); stochastic mode samples the
    target on the device, which IS sequential target sampling — seeded
    runs are reproducible (torch.Generator draws, so the streams differ
    from the JAX package's PRNG)."""

    def __init__(
        self,
        ctx_tgt: InferenceContext,
        ctx_dft: InferenceContext,
        sampling,
        sp: SpecParams,
        *,
        eos_id: int = 2,
        rounds: int = 8,
    ):
        check_engine_args("DeviceLoopEngine", ctx_tgt, ctx_dft, sampling, "the controller")
        self.tgt = ctx_tgt
        self.dft = ctx_dft
        self.sampling = sampling
        self.sp = sp
        self.eos_id = eos_id
        self.rounds = rounds
        self.stats = SpecStats()
        self._seed_base = entropy_seed(sampling.seed if sampling.seed >= 0 else None)
        self.t_prefill = 0.0
        self.t_decode = 0.0

    def generate(self, prompt_ids, n_predict, *, ignore_eos=False, stream=None):
        t0 = time.perf_counter()
        depth, R = self.sp.n_draft, self.rounds

        # prefill both models (one batch each); the target's last-row
        # sparse pack gives the first root token; the draft's rows are
        # discarded (cells only) and never fetched
        topk = min(128, self.tgt.cfg.n_vocab)
        b = Batch()
        for i, t in enumerate(prompt_ids):
            b.add(t, i, 0, want_logits=(i == len(prompt_ids) - 1))
        self.dft.decode_async(b, topk=min(128, self.dft.cfg.n_vocab))
        tlog = self.tgt.decode(b, topk=topk)
        if self.sampling.temp > 0:
            # first token: host sampler over the same chain
            from ..sampling.samplers import SamplerState, sample

            root = int(sample(SamplerState(params=self.sampling), tlog[-1]))
        else:
            root = int(tlog[-1].ids[0])  # sparse pack, ids sorted by value
        self.t_prefill = time.perf_counter() - t0

        generated = [root]
        if stream:
            stream(root)
        if n_predict <= 1 or (not ignore_eos and root == self.eos_id):
            self.t_decode = time.perf_counter() - t0
            self.stats.n_predict = len(generated[:n_predict])
            return generated[:n_predict]
        dev = self.tgt.device
        roots = dev_scalar(root, dev).reshape(1)
        bases = dev_scalar(len(prompt_ids), dev).reshape(1)
        seqs = self.tgt._seq_ids(0, 1)
        key_i = 0
        t_dec0 = time.perf_counter()

        inflight = []  # (handle, dcells [R, d], tcells [R, d+1])
        host_base = len(prompt_ids)  # true committed frontier (reconciled per fetch)

        def dispatch() -> bool:
            nonlocal roots, bases, key_i
            try:
                dcells = self.dft.find_cells(R * depth).reshape(R, depth)
                tcells = self.tgt.find_cells(R * (depth + 1)).reshape(R, depth + 1)
            except CacheFull:
                return False
            hint = host_base + len(inflight) * R * (depth + 1)
            self.dft.h_pos[dcells.reshape(-1)] = hint + np.arange(R * depth)
            self.dft.h_seq[dcells.reshape(-1)] = kv.host_only(0)
            self.tgt.h_pos[tcells.reshape(-1)] = hint + np.arange(R * (depth + 1))
            self.tgt.h_seq[tcells.reshape(-1)] = kv.host_only(0)
            handle, roots, bases = enqueue(
                self.dft, self.tgt, roots, bases, seqs, dcells[:, None], tcells[:, None],
                sampling=self.sampling, seed=self._seed_base * 9176 + key_i)
            key_i += 1
            inflight.append((handle, dcells, tcells))
            return True

        def reconcile(host_pack, dcells, tcells, r) -> int:
            """Host mirrors := device truth for round r of a fetched pack:
            the draft kept rows 0..min(m, depth-1) (root..t_m), the target
            rows 0..m (root + accepted), at positions host_base + i.
            Returns m."""
            nonlocal host_base
            m = int(host_pack[r, depth + 1])
            kv.reclaim_cells(self.dft, dcells[r], min(m + 1, depth), host_base)
            kv.reclaim_cells(self.tgt, tcells[r], m + 1, host_base)
            host_base += m + 1
            return m

        stop = False
        while not stop:
            while len(inflight) < MAX_INFLIGHT and (
                # don't over-dispatch: if the in-flight packs' UPPER BOUND
                # already covers the remaining tokens, wait for evidence
                # (an extra pack is pure tail waste)
                len(generated) + len(inflight) * R * (depth + 1) < n_predict
                or not inflight
            ):
                if not dispatch():
                    break
            if not inflight:
                raise RuntimeError("device loop could not dispatch (KV cache too small)")
            handle, dcells, tcells = inflight.pop(0)
            host_pack = handle.fetch()[:, 0]  # [R, depth+2]
            self.stats.n_rounds += R
            for r in range(R):
                if stop:
                    # rounds after the stop point were never consumed:
                    # their drafts are unverified tail waste
                    reconcile(host_pack, dcells, tcells, r)
                    self.stats.n_drafted += depth
                    self.stats.n_drafted_unverified += depth
                    continue
                m = reconcile(host_pack, dcells, tcells, r)
                self.stats.n_drafted += depth
                self.stats.n_accept += m
                for t in host_pack[r, : m + 1].tolist():
                    generated.append(t)
                    if stream:
                        stream(t)
                    if len(generated) >= n_predict or (not ignore_eos and t == self.eos_id):
                        stop = True
                        break
        self.t_decode = time.perf_counter() - t_dec0

        # drain: the device commits every in-flight pack's rounds (tail
        # waste); reconcile the mirrors with them, so that after the final
        # trim the host mirrors and the device metadata agree cell for cell
        for handle, dcells, tcells in inflight:
            host_pack = handle.fetch()[:, 0]
            for r in range(R):
                reconcile(host_pack, dcells, tcells, r)
            self.stats.n_drafted += R * depth
            self.stats.n_drafted_unverified += R * depth
        # roll back everything past the committed frontier (device + host)
        out = generated[:n_predict]
        final = len(prompt_ids) + len(out)
        self.tgt.rm_tail(final)
        self.dft.rm_tail(final)
        self.stats.n_predict = len(out)
        return out
