"""Device-corrected chaining: fused speculative runs that verify ON THE
DEVICE and chain from the *corrected* frontier.

Torch counterpart of pipeinfer_tpu.spec.corrected. Each corrected run
enqueues, with no host round trip inside it, R rounds of:

  1. draft-chain `depth` tokens from the chain root (root decoded at
     `base` — both device scalars produced by the previous round or run);
  2. batch-decode [root ++ drafted] on the target (one weight pass);
  3. verify on the device — greedy argmax match, or row-wise Gumbel-max
     target sampling through the user's (temp, top_k, top_p, min_p) chain;
  4. commit the matched prefix + the bonus token, drop the rejected rows'
     cells BY INDEX (other sequences' cells are never touched), and emit
     (bonus, base+m+1) as device scalars.

The next run chains from those scalars, so chained runs are never
launched on a diverged assumption and cross-run dead work is zero. The
host retires runs (non-blocking copy -> commit tokens -> sampler/metrics
bookkeeping) and keeps the acceptance-adaptive depth ladder. The caches
are updated in place (the JAX package donated them through jit).

ref: examples/speculative/speculative.cpp:881-1180 (speculative run),
:1277-1359 (the cancellation this path makes unnecessary in-regime),
llama.cpp:5850-5872 (async decode split).
"""

from __future__ import annotations

import numpy as np
import torch

from ..runtime import kv_cache as kv
from ..runtime.context import (AsyncHandle, InferenceContext, _device_draft_sample,
                               device_generator, dev_scalar, h2d, single_device, sparse_pack,
                               to_host_async, unpack_sparse)


def supported(ctrl) -> bool:
    """Can this controller chain through device-corrected runs? Needs what
    the device verify can express: single-branch trees, a sparse logits
    head, no grammar, a sampler chain the device target-sampler covers
    (device_loop.supported) and single-device contexts."""
    from . import device_loop

    return (
        ctrl.sp.device_verify
        and ctrl.sp.n_parallel == 1
        and ctrl.topk is not None
        and ctrl.sampler.grammar is None
        and device_loop.supported(ctrl.sampling)
        and single_device(ctrl.tgt, ctrl.dft)
    )


def _drop_rows(cache: kv.KVCache, cells: torch.Tensor, keep: torch.Tensor) -> None:
    """Free cache rows `cells[i]` where keep[i] is False, in place —
    index-based rollback (never touches cells outside this run, unlike
    kv.rm_tail)."""
    idx = cells.long()
    cache.pos[idx] = torch.where(keep, cache.pos[idx], -1)
    cache.seq[idx] = torch.where(keep[:, None], cache.seq[idx], 0)


def spec_round(dft: InferenceContext, tgt: InferenceContext, roots: torch.Tensor,
               bases: torch.Tensor, seqs: torch.Tensor, dcells: torch.Tensor,
               tcells: torch.Tensor, *, active: torch.Tensor | None = None,
               samp: tuple | None = None, tsample: bool = False, gen=None):
    """Steps 1-3 of one speculative round for S streams at once, enqueued
    with no host round trip: the round body of the corrected run (S = 1),
    the device-loop engine (S = 1) and the batched device loop.

    roots / bases / seqs int32 [S] (root token, its position, the stream's
    sequence slot); dcells [S, depth], tcells [S, depth+1]; active bool [S]
    or None (all live). An inactive stream's rows decode as padding (no
    cache writes a live row can see), its m is 0 and its (root, base)
    stay as they were. Each draft step is one [S]-row decode; the target
    takes one pass over the S*(depth+1) stream-major rows.

    Returns (toks int32 [S, depth], tlogits [S*(depth+1), V], m int64 [S],
    bonus int32 [S], new_bases int32 [S]); rolling back the rejected rows
    is the caller's (drop_rejected, or a per-stream tail trim)."""
    n, depth = dcells.shape
    valid = active if active is not None else dft._ones(n)
    tok, toks = roots, []
    for i in range(depth):  # 1) draft chains: one [S]-row decode per step
        logits, _ = dft._forward(dft.params, dft.cfg, dft.cache, tok, bases + i, seqs,
                                 dcells[:, i], valid, None)
        if samp is not None:
            tok = _device_draft_sample(logits, samp, gen)
        else:
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
        toks.append(tok)
    toks = torch.stack(toks, dim=1)

    # 2) one target pass over [root ++ drafted] per stream
    idx = torch.arange(depth + 1, device=tgt.device, dtype=torch.int32)
    ttoks = torch.cat([roots[:, None], toks], dim=1).reshape(-1)
    tpos = (bases[:, None] + idx).reshape(-1)
    tvalid = tgt._ones(n * (depth + 1)) if active is None else valid.repeat_interleave(depth + 1)
    tlogits, _ = tgt._forward(tgt.params, tgt.cfg, tgt.cache, ttoks, tpos,
                              seqs.repeat_interleave(depth + 1), tcells.reshape(-1), tvalid, None)

    # 3) device verification (g[s, i] decides position bases[s]+i+1)
    if tsample:
        g = _device_draft_sample(tlogits, samp, gen)
    else:
        g = torch.argmax(tlogits, dim=-1).to(torch.int32)
    g = g.reshape(n, depth + 1)
    m = torch.cumprod((toks == g[:, :depth]).to(torch.int32), dim=1).sum(dim=1)  # int64
    if active is not None:  # an inactive stream commits nothing
        m = torch.where(active, m, 0)
    bonus = g.gather(1, m[:, None]).squeeze(1)
    advance = m + 1
    if active is not None:  # ... and keeps its (root, base)
        bonus = torch.where(active, bonus, roots)
        advance = torch.where(active, advance, 0)
    new_bases = (bases + advance).to(torch.int32)
    return toks, tlogits, m, bonus, new_bases


def drop_rejected(dft: InferenceContext, tgt: InferenceContext, dcells: torch.Tensor,
                  tcells: torch.Tensor, m: torch.Tensor) -> None:
    """Index-based rollback of one round's rejected rows, for S streams:
    draft row i holds pos base+i (root..toks[depth-2]), kept for i <= m
    (capped); target row i holds pos base+i (root ++ drafted), kept for
    i <= m. Kept as the reference keeps it: on a FULL accept (m == depth)
    the draft never decoded toks[depth-1], so the draft KV lacks position
    base+depth (README "Known gaps"); output correctness is unaffected."""
    depth = dcells.shape[1]
    idx = torch.arange(depth + 1, device=m.device)
    _drop_rows(dft.cache, dcells.reshape(-1),
               (idx[None, :depth] < torch.clamp(m + 1, max=depth)[:, None]).reshape(-1))
    _drop_rows(tgt.cache, tcells.reshape(-1), (idx[None, :] < (m + 1)[:, None]).reshape(-1))


def commit_rows(toks: torch.Tensor, m: torch.Tensor, bonus: torch.Tensor) -> torch.Tensor:
    """Per stream, the committed tokens [S, depth+1]: m accepted draft
    tokens, the bonus at column m, zeros after it."""
    idx = torch.arange(toks.shape[1] + 1, device=toks.device)[None, :]
    rows = torch.where(idx < m[:, None], torch.cat([toks, toks[:, -1:]], dim=1), 0)
    return torch.where(idx == m[:, None], bonus[:, None], rows)


def corrected_rounds(dft: InferenceContext, tgt: InferenceContext, root, base, seq_id: int,
                     dcells: torch.Tensor, tcells: torch.Tensor, *, topk: int,
                     samp: tuple | None = None, tsample: bool = False, gen=None):
    """R corrected speculative rounds (R = dcells.shape[0]), enqueued back
    to back. dcells [R, depth], tcells [R, depth+1].

    Returns (out [R, depth+1, 2*topk+3], bonus, new_base): per round, the
    rows pack the target's sparse logits (top-k vals ++ ids ++ lse), a
    committed-token column, and the accept count m in row 0 of the last
    column. Each round chains from the previous round's (bonus, base) on
    the device; bonus / new_base chain the next run."""
    dev = tgt.device
    rounds, depth = dcells.shape
    root = dev_scalar(root, dev).reshape(1)
    base = dev_scalar(base, dev).reshape(1)
    seqs = tgt._seq_ids(seq_id, 1)
    first = torch.arange(depth + 1, device=dev) == 0
    outs = []
    for r in range(rounds):
        toks, tlogits, m, bonus, new_base = spec_round(
            dft, tgt, root, base, seqs, dcells[r: r + 1], tcells[r: r + 1],
            samp=samp, tsample=tsample, gen=gen)
        drop_rejected(dft, tgt, dcells[r: r + 1], tcells[r: r + 1], m)
        # output pack: sparse target rows ++ committed tokens ++ m
        committed = commit_rows(toks, m, bonus)[0]
        mcol = torch.where(first, m, 0)
        outs.append(torch.cat([sparse_pack(tlogits, topk), committed.float()[:, None],
                               mcol.float()[:, None]], dim=1))
        root, base = bonus, new_base
    return torch.stack(outs), root.reshape(()), base.reshape(())


def launch(
    dft: InferenceContext,
    tgt: InferenceContext,
    *,
    root,  # int or device i32 scalar (previous run's bonus token)
    base,  # int or device i32 scalar (root's position)
    seq_id: int,  # the stream's committed sequence slot
    depth: int,
    topk: int,
    hint: int,  # host-side UPPER BOUND for this run's base (mirror hints)
    samp: tuple | None = None,
    tsample: bool = False,
    seed: int = 0,
    rounds: int = 1,
):
    """Enqueue one corrected run of R rounds. Returns
    (handle, bonus_dev, new_base_dev, dcells [R, depth], tcells [R, depth+1]).

    handle.fetch() -> list of R per-round tuples
    (m, committed tokens list [m+1], SparseLogits rows [depth+1]).
    May raise CacheFull (backpressure, cells untouched). Host mirrors get
    hint-based positions (upper bounds — the actual base stays on the
    device until the fetch); the caller reconciles at retire."""
    dcells = dft.find_cells(rounds * depth).reshape(rounds, depth)
    tcells = tgt.find_cells(rounds * (depth + 1)).reshape(rounds, depth + 1)
    seq_row = kv.host_only(seq_id)
    dft.h_pos[dcells.reshape(-1)] = hint + np.arange(rounds * depth)
    dft.h_seq[dcells.reshape(-1)] = seq_row
    tgt.h_pos[tcells.reshape(-1)] = hint + np.arange(rounds * (depth + 1))
    tgt.h_seq[tcells.reshape(-1)] = seq_row
    dft._refresh_hot()
    tgt._refresh_hot()

    out, bonus, new_base = corrected_rounds(
        dft, tgt, root, base, seq_id,
        h2d(dcells.astype(np.int32), dft.device), h2d(tcells.astype(np.int32), tgt.device),
        topk=topk, samp=samp, tsample=tsample,
        gen=device_generator(tgt.device, seed) if samp is not None else None,
    )
    host, event = to_host_async(out)

    def decode(_topk=topk, _d=depth, _r=rounds):
        arr = host.numpy()  # [R, depth+1, 2*topk+3]
        packs = []
        for r in range(_r):
            m = int(arr[r, 0, 2 * _topk + 2])
            toks = arr[r, : m + 1, 2 * _topk + 1].astype(np.int32).tolist()
            rows = [unpack_sparse(arr[r, i], _topk) for i in range(_d + 1)]
            packs.append((m, toks, rows))
        return packs

    handle = AsyncHandle(logits=out, decode=decode, cells=tcells, event=event)
    return handle, bonus, new_base, dcells, tcells


def reclaim(ctx: InferenceContext, cells, keep: int, base: int, seq_id: int):
    """Reconcile the host mirrors with the device truth for one retired
    run's cells: rows [0, keep) live at positions base+row on seq_id; the
    run freed the rest (the shared kv.reclaim_cells contract)."""
    kv.reclaim_cells(ctx, cells, keep, base, seq_id)
