"""Inference context: the decode engine + host-side cell bookkeeping.

Torch counterpart of pipeinfer_tpu.runtime.context (ref: llama.cpp:1445-1520
context state, :5461-5848 decode engine):

- a step pads its batch to a bucket size, as the reference does for its
  compiled variants; padding tokens write to a reserved trash cell, which
  is never visible (so which duplicate write lands there does not matter);
- the KV cache is updated IN PLACE by every step (the JAX package donated
  it through jit);
- cell allocation runs on a host numpy mirror of (pos, seq), the same
  find-slot bookkeeping as the reference (llama.cpp:1593 find_slot), while
  the device tensors remain the source of truth for attention masking;
- dispatch is asynchronous: PyTorch enqueues the step on the current CUDA
  stream and returns; the result is copied into pinned host memory by a
  non-blocking copy enqueued right behind it, and a CUDA event marks its
  arrival. ``AsyncHandle.ready()`` queries that event, ``fetch()`` waits
  for it. Small host arrays go to the device the same way (pinned,
  non-blocking), so enqueueing a step never waits for the steps before it.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

from ..device import resolve
from ..models.config import ModelConfig
from ..ops.qmatmul import QuantTensor
from ..sampling.samplers import SparseLogits
from . import kv_cache as kv


class CacheFull(RuntimeError):
    """No free KV cells for an allocation. Speculation treats this as a
    backpressure signal (stop launching, recycle the run's cells) instead
    of a crash (ref: the reference asserts on find_slot failure,
    llama.cpp:1593)."""


def _bucket(n: int) -> int:
    """Pad batch sizes to the sparse bucket set {1, 8, 32, 128, 512, ...}
    of the JAX package, so the flash-vs-dense dispatch (which reads the
    padded T) takes the same branches as the reference."""
    if n <= 1:
        return 1
    if n <= 8:
        return 8
    b = 32
    while b < n:
        b *= 4
    return b


_UNSET = object()


@dataclasses.dataclass
class AsyncHandle:
    """A dispatched device program whose result is not yet on the host.

    ``event`` (CUDA only) is recorded right after the non-blocking copy of
    the result into pinned host memory: ``ready()`` queries it without
    blocking (the counterpart of the head's MPI_Iprobe on SYNC_LOGITS,
    ref: llama.cpp:5457-5459) and ``fetch()`` waits for it, then decodes
    the host copy once (later calls return the same value)."""

    logits: torch.Tensor  # the device result, kept alive until fetched
    decode: Callable[[], Any]  # host copy -> result (runs after the event)
    cells: np.ndarray
    event: Any = None  # torch.cuda.Event | None
    _result: Any = dataclasses.field(default=_UNSET, repr=False)

    def ready(self) -> bool:
        return self.event is None or self.event.query()

    def fetch(self):
        if self._result is _UNSET:
            if self.event is not None:
                self.event.synchronize()
            self._result = self.decode()
        return self._result


def to_host_async(t: torch.Tensor) -> tuple[torch.Tensor, Any]:
    """Start copying `t` to the host: (host tensor, CUDA event or None).
    On CUDA the copy goes into pinned memory, non-blocking, and the event
    marks its completion; on the CPU it is a plain copy."""
    if t.device.type != "cuda":
        return t.detach().clone(), None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record()
    return host, ev


def h2d(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A small host array on `device` without waiting for queued device
    work (pinned + non-blocking on CUDA; PyTorch keeps the pinned block
    alive until the copy has run)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type != "cuda":
        return t.clone()
    return t.pin_memory().to(device, non_blocking=True)


def dev_scalar(v, device: torch.device) -> torch.Tensor:
    """An int32 0-dim device tensor from a host int (a fill kernel, no
    copy) or an existing device scalar."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.int32).reshape(())
    return torch.full((), int(v), dtype=torch.int32, device=device)


@dataclasses.dataclass
class Batch:
    """Mirror of llama_batch (tokens to decode in one step). Each token may
    belong to several sequences (tree batches); the first is primary."""

    tokens: list[int] = dataclasses.field(default_factory=list)
    pos: list[int] = dataclasses.field(default_factory=list)
    seqs: list[list[int]] = dataclasses.field(default_factory=list)
    want_logits: list[bool] = dataclasses.field(default_factory=list)

    def add(self, token: int, pos: int, seq: int | list[int], want_logits: bool = True):
        """ref: llama_batch_add (common/common.cpp:991-1011)."""
        self.tokens.append(int(token))
        self.pos.append(int(pos))
        self.seqs.append([int(seq)] if isinstance(seq, int) else [int(s) for s in seq])
        self.want_logits.append(want_logits)

    def add_seq_to(self, idx: int, seq: int):
        """Add another sequence to an already-queued token (branch split
        sharing its prefix, ref: speculative.cpp:1027-1037)."""
        if seq not in self.seqs[idx]:
            self.seqs[idx].append(int(seq))

    def clear(self):
        self.tokens.clear()
        self.pos.clear()
        self.seqs.clear()
        self.want_logits.clear()

    def copy(self) -> "Batch":
        return Batch(
            list(self.tokens), list(self.pos), [list(s) for s in self.seqs], list(self.want_logits)
        )

    def __len__(self):
        return len(self.tokens)


def pack_batch(batch: Batch, t_pad: int, trash_cell: int, cells: np.ndarray):
    """Pad a Batch to the bucket size as the step's input arrays. Padding
    rows write to the trash cell. Returns (tokens, pos, seq, seq_bits,
    cell_idx, valid, seq_rows): seq_bits are int32 words holding the
    uint32 membership bits bit for bit, seq_rows the uint32 rows for the
    host mirrors."""
    n = len(batch)
    tokens = np.zeros(t_pad, np.int32)
    pos = np.zeros(t_pad, np.int32)
    seq = np.zeros(t_pad, np.int32)
    seq_bits = np.zeros((t_pad, kv.SEQ_WORDS), np.uint32)
    cell_idx = np.full(t_pad, trash_cell, np.int32)
    valid = np.zeros(t_pad, bool)
    tokens[:n] = batch.tokens
    pos[:n] = batch.pos
    seq[:n] = [s[0] for s in batch.seqs]
    seq_rows = kv.host_rows(batch.seqs)
    seq_bits[:n] = seq_rows
    cell_idx[:n] = cells
    valid[:n] = True
    return tokens, pos, seq, seq_bits.view(np.int32), cell_idx, valid, seq_rows


def _params_to(params, device: torch.device):
    """Params with every tensor on `device` (no copy when already there)."""
    if isinstance(params, QuantTensor):
        return dataclasses.replace(params, **{
            f: getattr(params, f).to(device)
            for f in ("qs", "qh", "scales", "bias") if getattr(params, f) is not None})
    if isinstance(params, torch.Tensor):
        return params.to(device)
    if isinstance(params, dict):
        return {k: _params_to(v, device) for k, v in params.items()}
    if isinstance(params, list):
        return [_params_to(v, device) for v in params]
    return params


def sparse_pack(logits: torch.Tensor, topk: int) -> torch.Tensor:
    """The packed sparse logits head [T, 2*topk+1]: top-k values ++ their
    ids (as f32, exact below 2^24) ++ the full-vocab logsumexp — one host
    transfer instead of three."""
    lse = torch.logsumexp(logits, dim=-1)
    vals, ids = torch.topk(logits, topk, dim=-1)
    return torch.cat([vals, ids.float(), lse[:, None]], dim=1)


def unpack_sparse(row: np.ndarray, topk: int) -> SparseLogits:
    return SparseLogits(row[topk: 2 * topk].astype(np.int32), row[:topk], float(row[2 * topk]))


class InferenceContext:
    """Single-model decode engine over one device."""

    def __init__(
        self,
        params,
        cfg: ModelConfig,
        *,
        n_cells: int = 1024,
        forward_fn: Callable | None = None,
        cache_dtype=torch.bfloat16,
        device=None,
    ):
        """device: where params and cache live (default ``cuda``; raises
        without CUDA unless ``device="cpu"``). Params already there are
        not copied."""
        from ..models.loader import forward_for_arch

        self.device = resolve(device)
        self.cfg = cfg
        n_cells = kv.round_pool(n_cells)
        self.n_cells = n_cells
        self._forward = forward_fn or forward_for_arch(cfg.arch)
        self.params = _params_to(params, self.device)
        self.cache = kv.create(cfg.n_layers, n_cells, cfg.n_kv_heads, cfg.head_dim,
                               cache_dtype, device=self.device)
        # host mirrors for allocation (last cell reserved as padding trash)
        self.h_pos = np.full(n_cells, -1, np.int64)
        self.h_seq = kv.host_seq_zeros(n_cells)
        self.trash_cell = n_cells - 1
        # timings (ref: llama_print_timings): dispatch -> fetch wall time
        self.t_eval = 0.0
        self.n_eval = 0
        self.t_prefill = 0.0
        self.n_prefill = 0

    # -- device inputs --------------------------------------------------------

    def _ones(self, n: int) -> torch.Tensor:
        return torch.ones(n, dtype=torch.bool, device=self.device)

    def _seq_ids(self, seq_id: int, n: int) -> torch.Tensor:
        return torch.full((n,), int(seq_id), dtype=torch.int32, device=self.device)

    def _step(self, tokens, pos, seq, cell_idx, valid, seq_bits, topk):
        logits, _ = self._forward(self.params, self.cfg, self.cache, tokens, pos, seq,
                                  cell_idx, valid, seq_bits)
        return logits if topk is None else sparse_pack(logits, topk)

    # -- on-device draft chain ---------------------------------------------

    def draft_chain(self, root_token, pos0: int, seq_id: int, depth: int,
                    n_cand: int = 8, fetch: bool = True,
                    samp: tuple | None = None, seed: int = 0):
        """Draft a chain of `depth` tokens rooted at `root_token` (decoded
        at pos0) on the device: greedy, or sampled when samp=(temp, top_k,
        top_p, min_p) (a torch.Generator seeded with `seed` draws the
        Gumbel noise). Returns (tokens [depth], per-step SparseLogits
        candidates). n_cand=0 skips the candidate pack (bare greedy
        decode) and returns (tokens, []).

        root_token may be a host int or a device i32 scalar, such as the
        `root_next` of a previous fetch=False call: with fetch=False this
        returns (out_device, root_next_device) with no host transfer, so
        chains enqueue back to back; out_device is then the packed
        [depth, 1 + 2*n_cand + 1] rows (token ++ top-k vals ++ ids ++ lse)
        or [depth, 1] for n_cand=0."""
        cells = self.find_cells(depth)
        self.h_pos[cells] = pos0 + np.arange(depth)
        self.h_seq[cells] = kv.host_only(seq_id)
        self._refresh_hot()
        gen = device_generator(self.device, seed) if samp is not None else None
        toks, packs = draft_loop(self, root_token, pos0, seq_id, h2d(cells.astype(np.int32),
                                 self.device), depth, samp, gen, n_cand)
        cols = [toks.float()[:, None]] + ([packs] if n_cand else [])
        out = torch.cat(cols, dim=1)
        root_next = toks[-1]
        if not fetch:
            return out, root_next
        both = out.cpu().numpy()
        tokens = both[:, 0].astype(np.int32).tolist()
        if n_cand == 0:
            return tokens, []
        return tokens, [unpack_sparse(both[i, 1:], n_cand) for i in range(depth)]

    # -- startup ------------------------------------------------------------

    def precompile(self, *, buckets=(1, 8, 32), topk: int | None = None,
                   chain_depths=(), n_cand: int = 8, log=None) -> dict[str, float]:
        """Warm-up: run each step shape once (the JAX package compiles its
        program variants here; the port has nothing to compile, but this
        builds and loads the CUDA kernels and PyTorch's lazy state). Steps
        run with every row invalid, so they write only to the trash cell,
        which is never visible; chains run on the trash cell and restore
        its metadata. Returns seconds per warmed job."""
        took = {}
        d = self.device
        for b in buckets:
            t0 = time.perf_counter()
            z = h2d(np.zeros(b, np.int32), d)
            self._step(z, z, z, h2d(np.full(b, self.trash_cell, np.int32), d),
                       torch.zeros(b, dtype=torch.bool, device=d),
                       h2d(np.zeros((b, kv.SEQ_WORDS), np.int32), d), topk)
            self._sync()
            took[f"step[{b},topk={topk}]"] = time.perf_counter() - t0
        for depth in chain_depths:
            t0 = time.perf_counter()
            draft_loop(self, 0, 0, 1, h2d(np.full(depth, self.trash_cell, np.int32), d),
                       depth, None, None, n_cand)
            self.cache.pos[self.trash_cell] = -1
            self.cache.seq[self.trash_cell] = 0
            self._sync()
            took[f"chain[{depth}]"] = time.perf_counter() - t0
        if log is not None:
            for k, v in took.items():
                log(f"warm {k}: {v:.2f}s")
        return took

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- cell allocation (host) --------------------------------------------

    def find_cells(self, n: int) -> np.ndarray:
        """First n free cells (the trash cell is never handed out)."""
        free = np.nonzero(self.h_pos[: self.trash_cell] < 0)[0]
        if len(free) < n:
            raise CacheFull(f"KV cache full: need {n} cells, {len(free)} free")
        return free[:n]

    def _refresh_hot(self):
        """Stamp the cache's high-water mark from the host mirror so
        attention streams only the occupied prefix of the pool (the
        first-fit allocator keeps occupancy prefix-dense)."""
        self.cache.hot = kv.hot_bucket(self.h_pos, self.trash_cell)

    @property
    def n_free_cells(self) -> int:
        return int((self.h_pos[: self.trash_cell] < 0).sum())

    # -- decode -------------------------------------------------------------

    def decode(self, batch: Batch, topk: int | None = None):
        """Run one step; returns logits [len(batch), n_vocab] (host numpy)
        or a list of SparseLogits when topk is set."""
        return self.decode_async(batch, topk).fetch()

    def decode_async(self, batch: Batch, topk: int | None = None) -> AsyncHandle:
        """Enqueue one step without waiting. Returns an AsyncHandle whose
        .ready() mirrors the head's MPI_Iprobe on SYNC_LOGITS and whose
        .fetch() is phase 1 (ref: llama.h:285-290 async decode split)."""
        t0 = time.perf_counter()
        n = len(batch)
        if n == 0:
            raise ValueError("empty batch")
        t_pad = _bucket(n)
        cells = self.find_cells(n)
        tokens, pos, seq, seq_bits, cell_idx, valid, seq_rows = pack_batch(
            batch, t_pad, self.trash_cell, cells
        )
        self.h_pos[cells] = batch.pos
        self.h_seq[cells] = seq_rows
        self._refresh_hot()

        d = self.device
        out = self._step(h2d(tokens, d), h2d(pos, d), h2d(seq, d), h2d(cell_idx, d),
                         h2d(valid, d), h2d(seq_bits, d), topk)[:n]
        host, event = to_host_async(out)

        def decode(_n=n, _t0=t0, _isdecode=(n <= 2), _topk=topk):
            arr = host.numpy()
            if _topk is not None:
                arr = [unpack_sparse(arr[i], _topk) for i in range(_n)]
            dt = time.perf_counter() - _t0
            if _isdecode:
                self.t_eval += dt
                self.n_eval += _n
            else:
                self.t_prefill += dt
                self.n_prefill += _n
            return arr

        return AsyncHandle(logits=out, decode=decode, cells=cells, event=event)

    # -- seq ops (device + host mirror) ------------------------------------
    # Each is the counterpart of a pipelined KV transaction in the reference
    # (llama.cpp:9238-9359); the device side updates the cache in place.

    def seq_rm(self, seq_id: int, p0: int = 0, p1: int = -1):
        kv.seq_rm(self.cache, seq_id, p0, p1)
        hp1 = np.iinfo(np.int64).max if p1 < 0 else p1
        hit = kv.host_member(self.h_seq, seq_id)
        hit &= (self.h_pos >= p0) & (self.h_pos < hp1)
        kv.host_clear(self.h_seq, seq_id, hit)
        self.h_pos[kv.host_empty(self.h_seq)] = -1

    def seq_cp(self, src: int, dst: int, p0: int = 0, p1: int = -1):
        kv.seq_cp(self.cache, src, dst, p0, p1)
        hp1 = np.iinfo(np.int64).max if p1 < 0 else p1
        hit = kv.host_member(self.h_seq, src)
        hit &= (self.h_pos >= p0) & (self.h_pos < hp1)
        kv.host_set(self.h_seq, dst, hit)

    def rm_tail(self, p0: int):
        """Free every cell at pos >= p0 on ALL sequences (the reference's
        seq_rm(-1, p0, -1))."""
        kv.rm_tail(self.cache, p0)
        hit = self.h_pos >= p0
        self.h_seq[hit] = 0
        self.h_pos[hit] = -1

    def seq_keep(self, seq_id: int):
        kv.seq_keep(self.cache, seq_id)
        keep = kv.host_member(self.h_seq, seq_id)
        self.h_seq[:] = 0
        self.h_seq[keep] = kv.host_only(seq_id)
        self.h_pos[~keep] = -1

    def seq_shift(self, seq_id: int, p0: int, p1: int, delta: int):
        """Shift positions and re-rotate K for [p0, p1) of a sequence. The
        host mirror names the affected cells, so the device op gathers,
        re-ropes and scatters only those (ref: the lazy per-range K_shift,
        llama.cpp:3495-3544)."""
        hp1 = np.iinfo(np.int64).max if p1 < 0 else p1
        hit = kv.host_member(self.h_seq, seq_id)
        hit &= (self.h_pos >= p0) & (self.h_pos < hp1)
        cells = np.nonzero(hit)[0]
        if len(cells):
            padded = np.full(_bucket(len(cells)), self.trash_cell, np.int32)
            padded[: len(cells)] = cells
            kv.shift_cells(self.cache, h2d(padded, self.device), int(delta), self.trash_cell,
                           rope_dims=self.cfg.rope_dims, rope_mode=self.cfg.rope_mode,
                           freq_base=self.cfg.rope_base, freq_scale=self.cfg.rope_scale)
        self.h_pos[hit] += delta
        dropped = hit & (self.h_pos < 0)
        self.h_seq[dropped] = 0
        self.h_pos[dropped] = -1

    def prepare_branch_seqs(self, seqs: list[int], src: int, p1: int, device: bool = True):
        """Clear each branch seq entirely and share src's cells [0, p1) into
        it. device=False updates only the host mirrors (the fused run
        applies the device side itself)."""
        if device:
            for sq in seqs:
                kv.seq_rm(self.cache, sq, 0, -1)
                kv.seq_cp(self.cache, src, sq, 0, p1)
        for sq in seqs:
            kv.host_clear(self.h_seq, sq)
        self.h_pos[kv.host_empty(self.h_seq)] = -1
        hit = kv.host_member(self.h_seq, src) & (self.h_pos >= 0) & (self.h_pos < p1)
        for sq in seqs:
            kv.host_set(self.h_seq, sq, hit)

    def consolidate(self, win_seq: int, branch_seqs: list[int], p0: int, p1: int, dst: int = 0):
        """Share win_seq's cells [p0, p1) with the committed sequence `dst`,
        then drop all branch seqs (verification retirement)."""
        kv.seq_cp(self.cache, win_seq, dst, p0, p1)
        for sq in branch_seqs:
            kv.seq_rm(self.cache, sq, 0, -1)
        hit = kv.host_member(self.h_seq, win_seq) & (self.h_pos >= p0) & (self.h_pos < p1)
        kv.host_set(self.h_seq, dst, hit)
        for sq in branch_seqs:
            kv.host_clear(self.h_seq, sq)
        self.h_pos[kv.host_empty(self.h_seq)] = -1

    def clear_cache(self):
        kv.clear(self.cache)
        self.h_pos[:] = -1
        self.h_seq[:] = 0

    def print_timings(self, log=print):
        """ref: llama_print_timings."""
        if self.n_prefill:
            log(f"prefill: {self.n_prefill} tokens in {self.t_prefill:.2f}s "
                f"({self.n_prefill / max(self.t_prefill, 1e-9):.1f} tok/s)")
        if self.n_eval:
            log(f"decode:  {self.n_eval} tokens in {self.t_eval:.2f}s "
                f"({self.n_eval / max(self.t_eval, 1e-9):.1f} tok/s)")


def device_generator(device: torch.device, seed: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


def _device_draft_sample(rows: torch.Tensor, samp: tuple, gen: torch.Generator) -> torch.Tensor:
    """Sample one token per logits row on the device under the (temp,
    top_k, top_p, min_p) chain by the Gumbel-max trick (ref:
    common/sampling.cpp:140-200). top_k <= 0 is capped to the top 64
    candidates, and top_p / min_p renormalize over that window, as in the
    JAX package. The noise comes from `gen`, so streams differ from the
    JAX package's PRNG under temperature; greedy never comes here.
    rows [..., V] -> int32 [...]."""
    temp, top_k, top_p, min_p = samp
    n = rows.shape[-1]
    k = min(max(int(top_k), 1), n) if top_k > 0 else min(64, n)
    vals, ids = torch.topk(rows, k, dim=-1)
    logp = torch.log_softmax(vals / max(temp, 1e-6), dim=-1)
    probs = torch.softmax(vals, dim=-1)  # pre-temp probs for the p-gates
    allow = (torch.cumsum(probs, dim=-1) - probs) < top_p
    if min_p > 0:
        allow &= probs >= min_p * probs[..., :1]
    allow[..., 0] = True  # the top token always survives
    u = torch.rand(vals.shape, generator=gen, device=rows.device) * (1.0 - 1e-9) + 1e-9
    g = -torch.log(-torch.log(u))
    pick = torch.argmax(torch.where(allow, logp + g, float("-inf")), dim=-1, keepdim=True)
    return ids.gather(-1, pick).squeeze(-1).to(torch.int32)


def draft_loop(ctx: InferenceContext, root, pos0, seq_id: int, cells: torch.Tensor,
               depth: int, samp: tuple | None, gen, n_cand: int | None = None):
    """Decode `depth` draft steps on `ctx`, each from the previous step's
    token, with no host round trip: the counterpart of the JAX package's
    lax.scan chains (_shared_chain, the draft half of the fused and
    corrected runs). root / pos0 are host ints or device i32 scalars; step
    i decodes at pos0 + i into cells[i].

    Returns (tokens int32 [depth], packs): packs is None when n_cand is
    None (draft halves of fused runs), else the per-step candidate pack
    [depth, 2*n_cand+1] (empty for n_cand == 0, the bare greedy chain)."""
    dev = ctx.device
    tok = dev_scalar(root, dev).reshape(1)
    pos = dev_scalar(pos0, dev).reshape(1)
    seq = ctx._seq_ids(seq_id, 1)
    one = ctx._ones(1)
    toks, packs = [], []
    for i in range(depth):
        logits, _ = ctx._forward(ctx.params, ctx.cfg, ctx.cache, tok, pos + i, seq,
                                 cells[i: i + 1], one, None)
        if n_cand:
            pack = sparse_pack(logits, n_cand)
            packs.append(pack)
        if samp is not None:
            nxt = _device_draft_sample(logits, samp, gen)
        elif n_cand:
            nxt = pack[:, n_cand].to(torch.int32)  # the top candidate's id
        else:
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        toks.append(nxt)
        tok = nxt
    toks = torch.cat(toks)
    if n_cand is None:
        return toks, None
    return toks, (torch.cat(packs) if n_cand else None)


def fused_spec(dft: InferenceContext, tgt: InferenceContext, root, *, dpos0: int,
               seq_id: int, dcells: torch.Tensor, tpos: torch.Tensor, tcells: torch.Tensor,
               tseq_bits: torch.Tensor, src_seq: int, topk: int, samp: tuple | None,
               gen) -> torch.Tensor:
    """One speculative run enqueued as one stretch of device work: clear
    the run's seq slot and share src_seq's prefix into it on both caches,
    draft-chain depth = len(dcells) tokens from `root` (decoded at dpos0),
    then batch-decode them on the target without the tokens visiting the
    host (ref: start_async_spec_run speculative.cpp:881-1180; the JAX
    package's _shared_fused_spec). Returns [depth, 2*topk+2]: the target's
    sparse logits rows ++ the chain token."""
    depth = dcells.shape[0]
    tpos0 = int(dpos0) + 1
    kv.seq_rm(dft.cache, seq_id, 0, -1)
    kv.seq_cp(dft.cache, src_seq, seq_id, 0, dpos0)
    kv.seq_rm(tgt.cache, seq_id, 0, -1)
    kv.seq_cp(tgt.cache, src_seq, seq_id, 0, tpos0)
    toks, _ = draft_loop(dft, root, dpos0, seq_id, dcells, depth, samp, gen)
    tlogits, _ = tgt._forward(tgt.params, tgt.cfg, tgt.cache, toks, tpos,
                              tgt._seq_ids(seq_id, depth), tcells, tgt._ones(depth), tseq_bits)
    return torch.cat([sparse_pack(tlogits, topk), toks.float()[:, None]], dim=1)
