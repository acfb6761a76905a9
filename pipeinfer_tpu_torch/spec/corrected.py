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
                               device_generator, dev_scalar, draft_loop, h2d, sparse_pack,
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
        and isinstance(ctrl.tgt, InferenceContext)
        and isinstance(ctrl.dft, InferenceContext)
    )


def _drop_rows(cache: kv.KVCache, cells: torch.Tensor, keep: torch.Tensor) -> None:
    """Free cache rows `cells[i]` where keep[i] is False, in place —
    index-based rollback (never touches cells outside this run, unlike
    kv.rm_tail)."""
    idx = cells.long()
    cache.pos[idx] = torch.where(keep, cache.pos[idx], -1)
    cache.seq[idx] = torch.where(keep[:, None], cache.seq[idx], 0)


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
    root = dev_scalar(root, dev)
    base = dev_scalar(base, dev)
    idx = torch.arange(depth + 1, device=dev)
    outs = []
    for r in range(rounds):
        # 1) draft chain from root (root decoded at base)
        toks, _ = draft_loop(dft, root, base, seq_id, dcells[r], depth, samp, gen)

        # 2) one target pass over [root ++ drafted]
        ttoks = torch.cat([root.reshape(1), toks])
        tpos = base + idx.to(torch.int32)
        tlogits, _ = tgt._forward(tgt.params, tgt.cfg, tgt.cache, ttoks, tpos,
                                  tgt._seq_ids(seq_id, depth + 1), tcells[r],
                                  tgt._ones(depth + 1), None)

        # 3) device verification (g[i] decides position base+i+1)
        if tsample:
            g = _device_draft_sample(tlogits, samp, gen)
        else:
            g = torch.argmax(tlogits, dim=-1).to(torch.int32)
        matches = (toks == g[:depth]).to(torch.int32)
        m = torch.cumprod(matches, dim=0).sum()  # int64 0-dim
        bonus = g.gather(0, m.reshape(1)).reshape(())
        new_base = (base + m + 1).to(torch.int32)

        # 4) drop rejected rows by index: draft row i holds pos base+i
        # (root..toks[depth-2]), keep i <= m (capped); target row i holds
        # pos base+i (root ++ drafted), keep i <= m. Kept as the reference
        # keeps it: on a FULL accept (m == depth) the draft never decoded
        # toks[depth-1], so the draft KV lacks position base+depth (README
        # "Known gaps"); output correctness is unaffected.
        _drop_rows(dft.cache, dcells[r], idx[:depth] < torch.clamp(m + 1, max=depth))
        _drop_rows(tgt.cache, tcells[r], idx < m + 1)

        # output pack: sparse target rows ++ committed tokens ++ m
        committed = torch.where(idx < m, torch.cat([toks, toks[-1:]]), 0)
        committed = torch.where(idx == m, bonus, committed)
        mcol = torch.where(idx == 0, m, 0)
        outs.append(torch.cat([sparse_pack(tlogits, topk), committed.float()[:, None],
                               mcol.float()[:, None]], dim=1))
        root, base = bonus, new_base
    return torch.stack(outs), root, base


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
