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
from ..ops.qmatmul import PLANES, QuantTensor
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
    """Params (dicts, lists and tuples of tensors, numpy arrays and
    QuantTensors, every plane) with every tensor on `device` (no copy when
    already there)."""
    if isinstance(params, QuantTensor):
        return dataclasses.replace(params, **{
            f: getattr(params, f).to(device) for f in PLANES if getattr(params, f) is not None})
    if isinstance(params, np.ndarray):
        return torch.from_numpy(params).to(device)
    if isinstance(params, torch.Tensor):
        return params.to(device)
    if isinstance(params, dict):
        return {k: _params_to(v, device) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(_params_to(v, device) for v in params)
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


def apply_seq_op(cache: kv.KVCache, cfg: ModelConfig, op: str, a: dict) -> None:
    """The device half of seq op `op` on one cache slab, in place, enqueued
    without waiting. `a` holds the op's arguments by name, as
    CellContext's seq ops pass them (and parallel.dcn sends them to the
    stages in other processes)."""
    if op == "seq_rm":
        kv.seq_rm(cache, int(a["seq_id"]), int(a["p0"]), int(a["p1"]))
    elif op == "seq_cp":
        kv.seq_cp(cache, int(a["src"]), int(a["dst"]), int(a["p0"]), int(a["p1"]))
    elif op == "prepare":
        for sq in a["seqs"]:
            kv.seq_rm(cache, int(sq), 0, -1)
            kv.seq_cp(cache, int(a["src"]), int(sq), 0, int(a["p1"]))
    elif op == "consolidate":
        kv.seq_cp(cache, int(a["win"]), int(a["dst"]), int(a["p0"]), int(a["p1"]))
        for sq in a["branch_seqs"]:
            kv.seq_rm(cache, int(sq), 0, -1)
    elif op == "seq_keep":
        kv.seq_keep(cache, int(a["seq_id"]))
    elif op == "rm_tail":
        kv.rm_tail(cache, int(a["p0"]))
    elif op == "shift":
        cells = h2d(np.asarray(a["cells"], np.int32), cache.pos.device)
        kv.shift_cells(cache, cells, int(a["delta"]), int(a["trash"]), rope_dims=cfg.rope_dims,
                       rope_mode=cfg.rope_mode, freq_base=cfg.rope_base,
                       freq_scale=cfg.rope_scale)
    elif op == "clear":
        kv.clear(cache)
    elif op == "hot":
        cache.hot = int(a["hot"])
    else:
        raise ValueError(f"unknown seq op {op!r}")


class CellContext:
    """The host half of a decode engine over one or more KV-cache slabs:
    cell allocation on a host numpy mirror of (pos, seq), the seq ops
    applied to every slab in ``caches`` and to the mirror, asynchronous
    dispatch and the timings. A subclass sets ``caches`` and ``_dispatch``
    (InferenceContext: one slab holding every layer;
    parallel.stages.StagedInferenceContext: one slab per pipeline stage)."""

    caches: tuple | list  # the KV-cache slabs, each on its own device
    mesh = None  # the tensor-parallel mesh of an InferenceContext; None on one device
    # complete every handle before decode_async returns: a step that ends in
    # a collective across processes (each process runs its own controller,
    # whose decisions must not depend on timing)
    _blocking = False

    def _init_cells(self, n_cells: int):
        """The host mirrors for n_cells (the last cell is the padding trash
        cell) and the timings (ref: llama_print_timings: dispatch -> fetch
        wall time)."""
        self.h_pos = np.full(n_cells, -1, np.int64)
        self.h_seq = kv.host_seq_zeros(n_cells)
        self.trash_cell = n_cells - 1
        self.t_eval = 0.0
        self.n_eval = 0
        self.t_prefill = 0.0
        self.n_prefill = 0

    def _dispatch(self, arrays: tuple, topk: int | None) -> torch.Tensor:
        """Enqueue one step on the padded host input arrays (tokens, pos,
        seq, cell_idx, valid, seq_bits); returns its device output."""
        raise NotImplementedError

    def _sync(self):
        for dev in {c.pos.device for c in self.caches}:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    # -- startup ------------------------------------------------------------

    def precompile(self, *, buckets=(1, 8, 32), topk: int | None = None, log=None,
                   **_ignored) -> dict[str, float]:
        """Warm-up: run each step shape once (the JAX package compiles its
        program variants here; the port has nothing to compile, but this
        builds and loads the CUDA kernels and PyTorch's lazy state). Steps
        run with every row invalid, so they write only to the trash cell,
        which is never visible. Returns seconds per warmed job."""
        took = {}
        for b in buckets:
            t0 = time.perf_counter()
            z = np.zeros(b, np.int32)
            self._dispatch((z, z, z, np.full(b, self.trash_cell, np.int32), np.zeros(b, bool),
                            np.zeros((b, kv.SEQ_WORDS), np.int32)), topk)
            self._sync()
            took[f"step[{b},topk={topk}]"] = time.perf_counter() - t0
        if log is not None:
            for k, v in took.items():
                log(f"warm {k}: {v:.2f}s")
        return took

    # -- cell allocation (host) --------------------------------------------

    def find_cells(self, n: int) -> np.ndarray:
        """First n free cells (the trash cell is never handed out)."""
        free = np.nonzero(self.h_pos[: self.trash_cell] < 0)[0]
        if len(free) < n:
            raise CacheFull(f"KV cache full: need {n} cells, {len(free)} free")
        return free[:n]

    def _refresh_hot(self):
        """Stamp every slab's high-water mark from the host mirror so
        attention streams only the occupied prefix of the pool (the
        first-fit allocator keeps occupancy prefix-dense)."""
        hot = kv.hot_bucket(self.h_pos, self.trash_cell)
        for c in self.caches:
            c.hot = hot

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
        cells = self.find_cells(n)
        tokens, pos, seq, seq_bits, cell_idx, valid, seq_rows = pack_batch(
            batch, _bucket(n), self.trash_cell, cells
        )
        self.h_pos[cells] = batch.pos
        self.h_seq[cells] = seq_rows
        self._refresh_hot()

        out = self._dispatch((tokens, pos, seq, cell_idx, valid, seq_bits), topk)[:n]
        host, event = (out.cpu(), None) if self._blocking else to_host_async(out)

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

    # -- seq ops (every slab + host mirror) --------------------------------
    # Each is the counterpart of a pipelined KV transaction in the reference
    # (llama.cpp:9238-9359), which a pipelined target fans out to every
    # stage; the device side updates each slab in place, without waiting.
    # The device half is one named op (apply_seq_op), so a target whose
    # stages live in other processes (parallel.dcn) sends the same op to them.

    def _seq_op(self, op: str, **args):
        """Apply seq op `op` to every slab's device side."""
        for c in self.caches:
            apply_seq_op(c, self.cfg, op, args)

    def seq_rm(self, seq_id: int, p0: int = 0, p1: int = -1):
        self._seq_op("seq_rm", seq_id=seq_id, p0=p0, p1=p1)
        hp1 = np.iinfo(np.int64).max if p1 < 0 else p1
        hit = kv.host_member(self.h_seq, seq_id)
        hit &= (self.h_pos >= p0) & (self.h_pos < hp1)
        kv.host_clear(self.h_seq, seq_id, hit)
        self.h_pos[kv.host_empty(self.h_seq)] = -1

    def seq_cp(self, src: int, dst: int, p0: int = 0, p1: int = -1):
        self._seq_op("seq_cp", src=src, dst=dst, p0=p0, p1=p1)
        hp1 = np.iinfo(np.int64).max if p1 < 0 else p1
        hit = kv.host_member(self.h_seq, src)
        hit &= (self.h_pos >= p0) & (self.h_pos < hp1)
        kv.host_set(self.h_seq, dst, hit)

    def rm_tail(self, p0: int):
        """Free every cell at pos >= p0 on ALL sequences (the reference's
        seq_rm(-1, p0, -1), llama.cpp:9245-9265)."""
        self._seq_op("rm_tail", p0=p0)
        hit = self.h_pos >= p0
        self.h_seq[hit] = 0
        self.h_pos[hit] = -1

    def seq_keep(self, seq_id: int):
        self._seq_op("seq_keep", seq_id=seq_id)
        keep = kv.host_member(self.h_seq, seq_id)
        self.h_seq[:] = 0
        self.h_seq[keep] = kv.host_only(seq_id)
        self.h_pos[~keep] = -1

    def seq_shift(self, seq_id: int, p0: int, p1: int, delta: int):
        """Shift positions and re-rotate K for [p0, p1) of a sequence. The
        host mirror names the affected cells, so the device op gathers,
        re-ropes (all by the model's rope_dims) and scatters only those, on
        every slab (ref: the lazy per-range K_shift, llama.cpp:3495-3544;
        a pipelined target broadcasts it through the ring, :9348-9359)."""
        hp1 = np.iinfo(np.int64).max if p1 < 0 else p1
        hit = kv.host_member(self.h_seq, seq_id)
        hit &= (self.h_pos >= p0) & (self.h_pos < hp1)
        cells = np.nonzero(hit)[0]
        if len(cells):
            padded = np.full(_bucket(len(cells)), self.trash_cell, np.int32)
            padded[: len(cells)] = cells
            self._seq_op("shift", cells=padded, delta=delta, trash=self.trash_cell)
        self.h_pos[hit] += delta
        dropped = hit & (self.h_pos < 0)
        self.h_seq[dropped] = 0
        self.h_pos[dropped] = -1

    def prepare_branch_seqs(self, seqs: list[int], src: int, p1: int, device: bool = True):
        """Clear each branch seq entirely and share src's cells [0, p1) into
        it. device=False updates only the host mirrors (the fused run
        applies the device side itself)."""
        if device:
            self._seq_op("prepare", seqs=seqs, src=src, p1=p1)
        for sq in seqs:
            kv.host_clear(self.h_seq, sq)
        self.h_pos[kv.host_empty(self.h_seq)] = -1
        hit = kv.host_member(self.h_seq, src) & (self.h_pos >= 0) & (self.h_pos < p1)
        for sq in seqs:
            kv.host_set(self.h_seq, sq, hit)

    def consolidate(self, win_seq: int, branch_seqs: list[int], p0: int, p1: int, dst: int = 0):
        """Share win_seq's cells [p0, p1) with the committed sequence `dst`,
        then drop all branch seqs (verification retirement)."""
        self._seq_op("consolidate", win=win_seq, branch_seqs=branch_seqs, p0=p0, p1=p1, dst=dst)
        hit = kv.host_member(self.h_seq, win_seq) & (self.h_pos >= p0) & (self.h_pos < p1)
        kv.host_set(self.h_seq, dst, hit)
        for sq in branch_seqs:
            kv.host_clear(self.h_seq, sq)
        self.h_pos[kv.host_empty(self.h_seq)] = -1

    def clear_cache(self):
        self._seq_op("clear")
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


class InferenceContext(CellContext):
    """Single-model decode engine over one device, or tensor-parallel over
    a mesh's 'model' axis."""

    def __init__(
        self,
        params,
        cfg: ModelConfig,
        *,
        n_cells: int = 1024,
        forward_fn: Callable | None = None,
        cache_dtype=torch.bfloat16,
        device=None,
        mesh=None,
    ):
        """device: where params and cache live (default ``cuda``; raises
        without CUDA unless ``device="cpu"``). Params already there are
        not copied.

        mesh: a 1-axis 'model' mesh (parallel.tp.tp_mesh); weights and KV
        are then tensor-sharded across it (parallel/tp.py), ``params`` is
        the list of local shards' trees, ``caches`` their cache slabs, and
        ``device`` the first local shard's, where results land. A mesh
        whose axis crosses processes runs one such context per process
        (multi-controller SPMD): its steps end in collectives, so a
        handle is complete when decode_async returns and every process's
        controller sees the same readiness."""
        from ..models.loader import forward_for_arch

        self.cfg = cfg
        self.mesh = mesh
        n_cells = kv.round_pool(n_cells)
        self.n_cells = n_cells
        self._forward = forward_fn or forward_for_arch(cfg.arch)
        if mesh is None:
            self.device = resolve(device)
            self.params = _params_to(params, self.device)
            self._caches = (kv.create(cfg.n_layers, n_cells, cfg.n_kv_heads, cfg.head_dim,
                                      cache_dtype, device=self.device),)
        else:
            from ..models.staged import local_cfg
            from ..parallel import tp

            local_cfg(cfg, mesh.shape["model"])  # raises for heads that do not split
            self.device = mesh.local_devices[0]
            self.params, _ = tp.shard_params(params, cfg, mesh)
            self._caches = tuple(tp.shard_cache(kv.create(
                cfg.n_layers, n_cells, cfg.n_kv_heads, cfg.head_dim, cache_dtype,
                device=self.device), mesh))
            self._blocking = mesh.spans_processes("model")
        self._init_cells(n_cells)

    @property
    def caches(self) -> tuple:
        return self._caches

    @property
    def cache(self) -> kv.KVCache:
        """The one cache slab of a one-device context."""
        if self.mesh is not None:
            raise AttributeError("a tensor-parallel context keeps one cache slab per shard "
                                 "(.caches)")
        return self._caches[0]

    # -- device inputs --------------------------------------------------------

    def _ones(self, n: int) -> torch.Tensor:
        return torch.ones(n, dtype=torch.bool, device=self.device)

    def _seq_ids(self, seq_id: int, n: int) -> torch.Tensor:
        return torch.full((n,), int(seq_id), dtype=torch.int32, device=self.device)

    def _step(self, tokens, pos, seq, cell_idx, valid, seq_bits, topk):
        if self.mesh is not None:
            from ..parallel import tp

            return tp.build_tp_step(self.cfg, topk, self.mesh)(
                self.params, self.caches, tokens, pos, seq, cell_idx, valid, seq_bits)
        logits, _ = self._forward(self.params, self.cfg, self.cache, tokens, pos, seq,
                                  cell_idx, valid, seq_bits)
        return logits if topk is None else sparse_pack(logits, topk)

    def _dispatch(self, arrays: tuple, topk: int | None) -> torch.Tensor:
        return self._step(*(h2d(a, self.device) for a in arrays), topk)

    # -- embedding input (the llama_batch.embd path: multimodal tokens) ----

    def decode_embd(self, embd, pos0: int, seq_id: int = 0) -> np.ndarray:
        """Feed pre-computed embeddings [T, E] (numpy or a tensor on any
        device) at positions pos0..pos0+T-1 (ref: llava_eval_image_embed
        llava.cpp:70-90: image patches enter the pipeline as embeddings, no
        token ids). Pads to the step's bucket as the JAX package does, fills
        KV cells and returns the final row's logits (np [n_vocab])."""
        if self.mesh is not None:
            raise NotImplementedError("decode_embd runs on one device (the JAX package's "
                                      "embedding path has no mesh branch either)")
        t = embd.shape[0]
        t_pad = _bucket(t)
        cells = self.find_cells(t)
        x = torch.zeros((t_pad, embd.shape[1]), dtype=torch.float32, device=self.device)
        x[:t] = torch.as_tensor(embd, dtype=torch.float32).to(self.device)
        pos = np.zeros(t_pad, np.int32)
        pos[:t] = pos0 + np.arange(t)
        seq = np.full(t_pad, seq_id, np.int32)
        cell_idx = np.full(t_pad, self.trash_cell, np.int32)
        cell_idx[:t] = cells
        valid = np.zeros(t_pad, bool)
        valid[:t] = True
        self.h_pos[cells] = pos[:t]
        self.h_seq[cells] = kv.host_only(seq_id)
        self._refresh_hot()
        tokens, pos, seq, cell_idx, valid = (h2d(a, self.device) for a in (
            np.zeros(t_pad, np.int32), pos, seq, cell_idx, valid))
        logits, _ = self._forward(self.params, self.cfg, self.cache, tokens, pos, seq, cell_idx,
                                  valid, embd=x)
        return logits[t - 1].cpu().numpy()

    # -- on-device draft chain ---------------------------------------------
    def _chain(self, root, pos0, seq_id: int, cells: np.ndarray, samp, gen, n_cand: int):
        """The chain's device steps into `cells` (draft_loop, or the TP
        chain over the mesh): (tokens [depth], packs)."""
        dcells = h2d(cells.astype(np.int32), self.device)
        if self.mesh is None:
            return draft_loop(self, root, pos0, seq_id, dcells, len(cells), samp, gen, n_cand)
        from ..parallel import tp

        return tp.build_tp_chain(self.cfg, len(cells), n_cand, self.mesh, samp)(
            self.params, self.caches, root, pos0, seq_id, dcells, gen)

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
        toks, packs = self._chain(root_token, pos0, seq_id, cells, samp, gen, n_cand)
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
        """CellContext.precompile's steps, then each draft-chain depth once,
        on the trash cell (its metadata restored after)."""
        took = super().precompile(buckets=buckets, topk=topk)
        for depth in chain_depths:
            t0 = time.perf_counter()
            self._chain(0, 0, 1, np.full(depth, self.trash_cell, np.int32), None, None, n_cand)
            for c in self.caches:  # every shard's slab
                c.pos[self.trash_cell] = -1
                c.seq[self.trash_cell] = 0
            self._sync()
            took[f"chain[{depth}]"] = time.perf_counter() - t0
        if log is not None:
            for k, v in took.items():
                log(f"warm {k}: {v:.2f}s")
        return took


def single_device(*ctxs) -> bool:
    """Whether every context is a one-device InferenceContext: what the
    device-verified engines need (the JAX package's `mesh is None` gates).
    A tensor-parallel target is verified on the host instead."""
    return all(isinstance(c, InferenceContext) and c.mesh is None for c in ctxs)


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
    """Decode `depth` draft steps on the one-device context `ctx`, each
    from the previous step's token, with no host round trip: the
    counterpart of the JAX package's lax.scan chains (_shared_chain, the
    draft half of the fused and corrected runs). See chain_loop."""
    def logits(tok, pos, seq, cell, one):
        return ctx._forward(ctx.params, ctx.cfg, ctx.cache, tok, pos, seq, cell, one, None)[0]

    return chain_loop(logits, ctx.device, root, pos0, seq_id, cells, depth, samp, gen, n_cand)


def chain_loop(logits_fn: Callable, dev: torch.device, root, pos0, seq_id: int,
               cells: torch.Tensor, depth: int, samp: tuple | None, gen,
               n_cand: int | None = None):
    """`depth` single-token decode steps, each from the previous step's
    token: logits_fn(tok, pos, seq, cell, valid) -> logits [1, V] decodes
    one token (on `dev`, or replicated from there by a TP step). root /
    pos0 are host ints or device i32 scalars; step i decodes at pos0 + i
    into cells[i].

    Returns (tokens int32 [depth], packs): packs is None when n_cand is
    None (draft halves of fused runs), else the per-step candidate pack
    [depth, 2*n_cand+1] (empty for n_cand == 0, the bare greedy chain)."""
    tok = dev_scalar(root, dev).reshape(1)
    pos = dev_scalar(pos0, dev).reshape(1)
    seq = torch.full((1,), int(seq_id), dtype=torch.int32, device=dev)
    one = torch.ones(1, dtype=torch.bool, device=dev)
    toks, packs = [], []
    for i in range(depth):
        logits = logits_fn(tok, pos + i, seq, cells[i: i + 1], one)
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
