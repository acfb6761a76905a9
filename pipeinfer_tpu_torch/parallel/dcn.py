"""Cross-process pipeline stages with a socket control plane: the
counterpart of the reference's MPI deployment.

Torch counterpart of pipeinfer_tpu.parallel.dcn, with its names and its
wire protocol. The reference pipelines a model across *nodes*: rank 0
drives, every other rank sits in a tag-dispatch worker loop (ref:
llama.cpp:9941-9977 `llama_process_mpi_worker`), metadata rides a
head->tail ring (ggml-mpi.c:188-210), activations hop stage->stage
(ggml-mpi.c:710-721), logits return tail->head (llama.cpp:5798-5804) and
cancellations travel a backwards ring (ggml-mpi.c:212-234). Here:

- every stage worker is an OS process owning its layer slab and KV slab on
  its device (``--device``, default ``cuda``: several workers may share
  one card, or each take its own); it runs an ordered command loop over a
  TCP control connection from the head (the MPI tags become typed frames);
- activations hop worker->worker over their own TCP data stream, copied
  to the host behind the stage's compute and sent by a sender thread per
  stage, so several microbatches are in flight across the stage depth;
- cancellation is a separate head->worker channel drained into a set by a
  reader thread, so it can OVERTAKE queued decodes (the backwards-ring
  counterpart): a canceled run's compute is skipped and a small "dead"
  frame keeps the data stream in sync;
- KV sequence ops are sent in-band on the control stream, so every stage
  applies them in exactly the head's order (the reference's transaction
  ids, llama.cpp:9263-9333, become FIFO ordering); each is the named op of
  ``runtime.context.apply_seq_op`` that the head applies to its own slab.

The head process (RemoteStagedContext) owns stage 0, the sequence-slot
allocator and the PipeInfer controller; it exposes the decode and seq-op
surface of StagedInferenceContext, so the async controller runs over a
cross-process target unchanged (host-verified: the corrected and fused
modes need a single-device InferenceContext).

Streams: each process enqueues its stage, then the non-blocking copy of
the stage's output into pinned host memory and a CUDA event behind it, on
its main thread's current stream (``runtime.context.to_host_async``). The
sending thread (the head's ship pool, the worker's ``_sender``) only waits
on that event and reads the pinned copy; it never touches a device tensor.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import queue
import socket
import struct
import subprocess
import sys
import threading
import time
from typing import Sequence

import numpy as np
import torch

from ..device import resolve
from ..models import staged
from ..runtime import kv_cache as kv
from ..runtime.context import (AsyncHandle, Batch, CellContext, _bucket, _params_to, apply_seq_op,
                               h2d, pack_batch, to_host_async, unpack_sparse)
from .stages import StagedInferenceContext, split_ranges

LOOPBACK = ("localhost", "127.0.0.1", "::1")

# ---------------------------------------------------------------------------
# framing: 8-byte header (json_len, payload_len) + json + raw payload
# ---------------------------------------------------------------------------

_HDR = struct.Struct("<II")


def _json_default(o):
    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"{type(o).__name__} is not JSON serializable")


def send_msg(sock: socket.socket, meta: dict, payload: bytes = b"") -> None:
    js = json.dumps(meta, default=_json_default).encode()
    sock.sendall(_HDR.pack(len(js), len(payload)) + js + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf.extend(chunk)
    return bytes(buf)


def recv_msg(sock: socket.socket) -> tuple[dict, bytes]:
    jl, pl = _HDR.unpack(_recv_exact(sock, _HDR.size))
    meta = json.loads(_recv_exact(sock, jl)) if jl else {}
    payload = _recv_exact(sock, pl) if pl else b""
    return meta, payload


def _pack_arrays(arrays: dict) -> tuple[dict, bytes]:
    """Numpy arrays or CPU tensors -> (frame meta, payload). A bf16 tensor
    travels as its raw 16-bit words, tagged "bfloat16" (numpy has no bf16
    dtype of its own)."""
    meta, blob = {}, bytearray()
    for name, a in arrays.items():
        if isinstance(a, torch.Tensor):
            if a.dtype == torch.bfloat16:
                words = a.contiguous().view(torch.int16).numpy()
                meta[name] = ["bfloat16", list(words.shape), len(blob), words.nbytes]
                blob.extend(words.tobytes())
                continue
            a = a.numpy()
        a = np.ascontiguousarray(a)
        meta[name] = [str(a.dtype), list(a.shape), len(blob), a.nbytes]
        blob.extend(a.tobytes())
    return meta, bytes(blob)


def _unpack_arrays(meta: dict, blob: bytes) -> dict[str, np.ndarray]:
    """The arrays of a frame; "bfloat16" words come back widened to f32
    (exactly: a bf16 is the top half of an f32)."""
    out = {}
    for name, (dt, shape, off, nb) in meta.items():
        if dt == "bfloat16":
            words = np.frombuffer(blob, dtype=np.uint16, count=nb // 2, offset=off)
            out[name] = (words.astype(np.uint32) << 16).view(np.float32).reshape(shape)
            continue
        out[name] = np.frombuffer(blob, dtype=np.dtype(dt), count=nb // np.dtype(dt).itemsize,
                                  offset=off).reshape(shape)
    return out


def _wire_token() -> str:
    """Shared secret for the hello handshake (PIPEINFER_DCN_TOKEN). Every
    peer role is validated against it before being accepted: without it,
    any network peer could connect as 'ctrl' and drive arbitrary
    compute/KV ops, or inject activations as 'data'."""
    return os.environ.get("PIPEINFER_DCN_TOKEN", "")


def _check_hello(hello: dict, *, bind_host: str) -> bool:
    import hmac

    want = _wire_token()
    if not want and bind_host not in LOOPBACK:
        return False  # a non-loopback bind REQUIRES a token
    return hmac.compare_digest(str(hello.get("token", "")), want)


# Inter-stage activations travel bf16 by default (half the bytes on the
# latency-tolerance axis the pipeline exists for; the reference's F32-only
# MPI transfer is a limitation, ggml-mpi.c:451-487). The final logits hop
# stays f32: the packed sparse rows carry token IDS as floats, and bf16's
# 8 mantissa bits corrupt ids > 256. PIPEINFER_DCN_WIRE=f32 forces f32.
# The head's setting rules the pipeline: a worker sends bf16 on only when
# its input came as bf16 (and its own PIPEINFER_DCN_WIRE is not f32), so
# one cluster serves a head that changes its wire between runs.
def _wire_cast(t: torch.Tensor) -> torch.Tensor:
    """The tensor as it goes on an inter-stage hop, cast on its device
    (round to nearest even, as the JAX package's ml_dtypes cast)."""
    if os.environ.get("PIPEINFER_DCN_WIRE", "bf16") == "f32" or t.dtype != torch.float32:
        return t
    return t.to(torch.bfloat16)


def _connect_retry(addr: tuple[str, int], role: str,
                   timeout: float = 900.0) -> socket.socket:
    """Retry until the peer binds its listen socket. The deadline must
    cover the peer's FULL startup (model load, device upload, kernel
    builds), hence the generous default; override via the callers'
    connect_timeout."""
    deadline = time.monotonic() + timeout
    while True:
        try:
            s = socket.create_connection(addr, timeout=5.0)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            s.settimeout(None)
            send_msg(s, {"role": role, "token": _wire_token()})
            return s
        except OSError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.1)


def launch_counts() -> dict[str, int]:
    """This process's kernel launches so far, per kernel wrapper (the
    counters ``ops.cuda_build.launch`` bumps)."""
    from ..ops import cell_attention as ca
    from ..ops import qmatmul as q

    return {"i4g_matmul": q.i4g_matmul.launches, "i8g_matmul": q.i8g_matmul.launches,
            "kmajor_matmul": q.kmajor_matmul.launches, "i8_matmul": q.i8_matmul.launches,
            "k4_matmul": q.k4_matmul.launches, "cell_attention": ca.cell_attention.launches}


def _device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev)


# ---------------------------------------------------------------------------
# stage worker (ranks 1..S-1): the tag-dispatch loop, re-designed
# ---------------------------------------------------------------------------


class StageWorker:
    """One pipeline stage in its own process (ref: the non-head rank's
    llama_process_mpi_worker loop, llama.cpp:9941-9977)."""

    # bound on queued outbound activations: a stalled downstream worker
    # backpressures this stage's command loop instead of growing host
    # memory without limit (the head's ship pool is bounded the same way)
    SEND_HIGH_WATER = 8

    def __init__(self, model_path: str, stage: int, n_stages: int,
                 split: Sequence[float] | None, listen_port: int,
                 next_addr: tuple[str, int], *, n_cells: int = 1024,
                 cache_dtype=torch.bfloat16, bind_host: str = "localhost", device="cuda"):
        """device: where this stage's layers and cache live (default
        ``cuda``, which raises without CUDA; ``cuda:1`` puts the stage on
        another card)."""
        from ..models import load_model

        self.device = resolve(device)
        if self.device.type == "cpu":
            # several torch processes on one machine starve each other
            # through OpenMP spin-waits; one thread each keeps them fair
            torch.set_num_threads(1)
        self.stage = stage
        self.n_stages = n_stages
        self.last = stage == n_stages - 1
        n_cells = kv.round_pool(n_cells)  # must match the head's rounding
        params, cfg = load_model(model_path, device=self.device)
        self.cfg = cfg
        split = list(split) if split else [1.0 / n_stages] * n_stages
        lo, hi = split_ranges(cfg.n_layers, split)[stage]
        self.layer_range = (lo, hi)
        sp = {"layers": params["layers"][lo:hi]}
        if self.last:
            sp.update({k: params[k] for k in StagedInferenceContext.LAST_STAGE_GLOBALS
                       if k in params})
        del params  # the other stages' layers are freed here
        self.params = sp
        self.cache = kv.create(hi - lo, n_cells, cfg.n_kv_heads, cfg.head_dim, cache_dtype,
                               device=self.device)
        self.n_cells = n_cells

        self.listen_port = listen_port
        self.bind_host = bind_host
        self.next_addr = next_addr
        self.canceled: set[int] = set()
        self._cancel_lock = threading.Lock()
        self._act_q: "queue.Queue[tuple[dict, bytes] | None]" = queue.Queue()
        self._send_q: "queue.Queue[tuple | None]" = queue.Queue(maxsize=self.SEND_HIGH_WATER)

    # -- wiring -------------------------------------------------------------

    def _accept_loop(self, lsock: socket.socket, conns: dict, ev: threading.Event):
        """Take the ctrl, data and cancel peers, then keep closing every
        later one until the listen socket closes at shutdown."""
        while True:
            try:
                c, _peer = lsock.accept()
            except OSError:
                return
            c.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            c.settimeout(30.0)  # a peer that never says hello cannot stall the wiring
            try:
                hello, _ = recv_msg(c)
            except (ConnectionError, OSError, ValueError):  # ValueError: not a JSON frame
                c.close()
                continue
            c.settimeout(None)
            # authenticate BEFORE honoring the claimed role: an
            # unauthenticated 'ctrl' peer could drive arbitrary compute/KV
            # ops, a 'data' peer could inject activations
            role = hello.get("role") if isinstance(hello, dict) else None
            if ev.is_set() or role not in ("ctrl", "data", "cancel") or role in conns or \
                    not _check_hello(hello, bind_host=self.bind_host):
                c.close()
                continue
            conns[role] = c
            if len(conns) == 3:
                ev.set()

    def _data_reader(self, dsock: socket.socket):
        try:
            while True:
                meta, payload = recv_msg(dsock)
                self._act_q.put((meta, payload))
        except (ConnectionError, OSError):
            self._act_q.put(None)

    def _cancel_reader(self, csock: socket.socket):
        try:
            while True:
                meta, _ = recv_msg(csock)
                with self._cancel_lock:
                    self.canceled.update(meta["runs"])
        except (ConnectionError, OSError):
            pass

    def _sender(self, out_sock: socket.socket):
        """Ordered send: waits for each run's host copy (the event recorded
        behind it on the command loop's stream), which is the stage->next
        activation latency that the compute of the NEXT queued run
        overlaps with."""
        while True:
            item = self._send_q.get()
            if item is None:
                break
            meta, host, event = item
            if host is None:
                send_msg(out_sock, meta)
                continue
            if event is not None:
                event.synchronize()
            ameta, blob = _pack_arrays({"x": host})
            meta["arrays"] = ameta
            send_msg(out_sock, meta, blob)

    # -- command handlers ----------------------------------------------------

    def _handle_decode(self, meta: dict, payload: bytes):
        arrs = _unpack_arrays(meta["arrays"], payload)
        rid = meta["run"]
        topk = meta.get("topk")
        item = self._act_q.get()
        if item is None:
            raise ConnectionError("data stream closed")
        ameta, ablob = item
        if ameta["run"] != rid:
            raise RuntimeError(f"stage {self.stage}: activation of run {ameta['run']} "
                               f"arrived for run {rid}")
        with self._cancel_lock:
            # run ids are monotonic and never reused: prune every mark at
            # or below the run being processed (incl. late-arriving cancels
            # for already-computed runs) so the set stays bounded
            dead = ameta.get("dead", False) or rid in self.canceled
            self.canceled = {c for c in self.canceled if c > rid}
        if dead:
            # stay in protocol sync without computing (the reference's
            # canceled-batch skip, llama.cpp:5627-5628)
            self._send_q.put(({"t": "act", "run": rid, "dead": True}, None, None))
            return
        x = _unpack_arrays(ameta["arrays"], ablob)["x"]
        dbg = os.environ.get("PIPEINFER_DCN_DEBUG_DIR")
        if dbg:  # per-stage run dumps (the counterpart of per-rank LOG files)
            np.savez(os.path.join(dbg, f"worker{self.stage}_run{rid}.npz"),
                     x=x, backend=_device_name(self.device), **dict(arrs))
        d = self.device
        out = staged.stage_forward(
            self.params, self.cfg, self.cache, h2d(x, d), h2d(arrs["pos"], d),
            h2d(arrs["seq"], d), h2d(arrs["cell_idx"], d), h2d(arrs["valid"], d),
            h2d(arrs["seq_bits"], d), first=False, last=self.last,
            topk=topk if self.last else None)
        if self.last:  # the final logits hop stays f32
            out = out[: int(arrs["valid"].sum())]  # the batch's rows: pack_batch puts them first
        elif ameta["arrays"]["x"][0] == "bfloat16":
            out = _wire_cast(out)  # the wire follows the head's (see _wire_cast)
        host, event = to_host_async(out)
        self._send_q.put(({"t": "act", "run": rid, "dead": False}, host, event))

    # -- main loop -----------------------------------------------------------

    def serve(self) -> None:
        if self.bind_host not in LOOPBACK and not _wire_token():
            raise RuntimeError(
                "refusing a non-loopback --bind without PIPEINFER_DCN_TOKEN "
                "set: any network peer could otherwise drive this worker"
            )
        lsock = socket.socket()
        lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        lsock.bind((self.bind_host, self.listen_port))
        lsock.listen(4)
        conns: dict[str, socket.socket] = {}
        ready = threading.Event()
        acceptor = threading.Thread(target=self._accept_loop, args=(lsock, conns, ready),
                                    daemon=True)
        acceptor.start()
        out_role = "logits" if self.last else "data"
        out_sock = _connect_retry(self.next_addr, out_role)
        if not ready.wait(timeout=900):
            raise TimeoutError("worker: missing inbound connections")
        ctrl, data, cancel = conns["ctrl"], conns["data"], conns["cancel"]
        readers = [acceptor,
                   threading.Thread(target=self._data_reader, args=(data,), daemon=True),
                   threading.Thread(target=self._cancel_reader, args=(cancel,), daemon=True)]
        for t in readers[1:]:
            t.start()
        sender = threading.Thread(target=self._sender, args=(out_sock,), daemon=True)
        sender.start()
        # config fingerprint: the head validates that cell indexing and
        # layer ranges agree before any decode (a silent mismatch would
        # corrupt shared cell indices across stages)
        send_msg(ctrl, {
            "t": "ready", "stage": self.stage, "n_stages": self.n_stages,
            "n_cells": self.n_cells, "layers": list(self.layer_range),
            "n_embd": self.cfg.n_embd, "n_layers_total": self.cfg.n_layers,
        })
        try:
            while True:
                meta, payload = recv_msg(ctrl)
                t = meta["t"]
                if t == "decode":
                    self._handle_decode(meta, payload)
                elif t == "kv":
                    apply_seq_op(self.cache, self.cfg, meta["op"], meta.get("args", {}))
                elif t == "ping":
                    send_msg(ctrl, {"t": "pong", "launches": launch_counts()})
                elif t == "shutdown":
                    break
                else:
                    raise ValueError(f"unknown command {t}")
        finally:
            self._send_q.put(None)
            sender.join(timeout=10)
            for s in (ctrl, data, cancel, out_sock, lsock):
                try:  # shutdown wakes a reader blocked in recv; close alone does not
                    s.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                s.close()
            for t in readers:  # none may still run when the interpreter exits
                t.join(timeout=10)
        # the counterpart of the reference's per-rank LOG files: one line
        # on exit, which launch_local_cluster's callers may read
        print(f"dcn worker: stage {self.stage} device {_device_name(self.device)} launches "
              f"{json.dumps(launch_counts(), sort_keys=True)}", file=sys.stderr, flush=True)


def worker_main(argv: list[str] | None = None) -> None:
    """CLI entry: python -m pipeinfer_tpu_torch.parallel.dcn --stage i ..."""
    import argparse

    ap = argparse.ArgumentParser(description="PipeInfer DCN stage worker")
    ap.add_argument("--model", required=True)
    ap.add_argument("--stage", type=int, required=True)
    ap.add_argument("--n-stages", type=int, required=True)
    ap.add_argument("--split", default=None,
                    help="comma-separated stage weights (--mpi-layer-split counterpart)")
    ap.add_argument("--listen-port", type=int, required=True)
    ap.add_argument("--next", required=True, help="host:port of next stage (or head)")
    ap.add_argument("--n-cells", type=int, default=1024)
    ap.add_argument("--cache-dtype", default="bf16", choices=["bf16", "f32"])
    ap.add_argument("--device", default="cuda",
                    help="torch device of this stage (default cuda; cuda:N for another card)")
    ap.add_argument("--bind", default="localhost",
                    help="listen address (default localhost; a non-loopback "
                         "bind for real multi-host runs REQUIRES "
                         "PIPEINFER_DCN_TOKEN on every peer)")
    args = ap.parse_args(argv)
    split = [float(x) for x in args.split.split(",")] if args.split else None
    host, port = args.next.rsplit(":", 1)
    StageWorker(
        args.model, args.stage, args.n_stages, split,
        args.listen_port, (host, int(port)), n_cells=args.n_cells,
        cache_dtype=torch.bfloat16 if args.cache_dtype == "bf16" else torch.float32,
        bind_host=args.bind, device=args.device,
    ).serve()


# ---------------------------------------------------------------------------
# head-side context (rank 0): stage 0 local + remote stage fan-out
# ---------------------------------------------------------------------------


class _RemoteResult:
    """The event of a remote run's AsyncHandle: set by the head's logits
    reader when the run's frame lands (its logits, its dead frame, or the
    error of a closed stream). ``query()`` is the controller's iprobe and
    never blocks; ``synchronize()`` waits for the frame."""

    def __init__(self):
        self._ev = threading.Event()
        self.value = None

    def put(self, value) -> None:
        self.value = value
        self._ev.set()

    def query(self) -> bool:
        return self._ev.is_set()

    def synchronize(self) -> None:
        self._ev.wait()


class RemoteStagedContext(StagedInferenceContext):
    """InferenceContext-compatible engine whose stages 1..S-1 live in OTHER
    PROCESSES (the reference's multi-node deployment). The head keeps stage
    0 local (rank 0 also owns the first layer slab in the reference's
    --mpi-layer-split recipes) and the PipeInfer controller runs on top
    unchanged.

    workers: list of (host, ctrl_port) for stages 1..S-1, already serving.
    The head connects ctrl+cancel to each worker, streams stage-0 output
    activations to worker 1, and receives final logits from the last
    worker on its own listen socket."""

    def __init__(self, params, cfg, *, workers: Sequence[tuple[str, int]],
                 split: Sequence[float] | None = None, n_cells: int = 1024,
                 cache_dtype=torch.bfloat16, head_port: int = 0,
                 connect_timeout: float = 900.0, head_bind: str = "localhost", device=None):
        """device: where stage 0 runs (default ``cuda``; raises without
        CUDA unless ``device="cpu"``)."""
        if not workers:
            raise ValueError(
                "RemoteStagedContext needs >= 1 stage worker; for a "
                "single-process pipeline use StagedInferenceContext"
            )
        n_stages = len(workers) + 1
        split = list(split) if split else [1.0 / n_stages] * n_stages
        if len(split) != n_stages:
            raise ValueError(f"{len(split)} stage weights for {n_stages} stages")
        self.cfg = cfg
        self.tp = 1
        n_cells = kv.round_pool(n_cells)
        self.n_cells = n_cells
        dev = resolve(device)
        self.devices = [dev]  # the local stage's; the others are the workers'
        self.ranges = split_ranges(cfg.n_layers, split)
        lo, hi = self.ranges[0]
        sp = {"layers": params["layers"][lo:hi]}
        sp.update({k: params[k] for k in self.FIRST_STAGE_GLOBALS if k in params})
        self.stage_params = [_params_to(sp, dev)]
        self.caches = [kv.create(hi - lo, n_cells, cfg.n_kv_heads, cfg.head_dim, cache_dtype,
                                 device=dev)]
        self._init_cells(n_cells)

        # listen for the last worker's logits stream (loopback by default;
        # real multi-host heads pass head_bind + PIPEINFER_DCN_TOKEN)
        self._lsock = socket.socket()
        self._lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._lsock.bind((head_bind, head_port))
        self._lsock.listen(2)
        self.head_addr = ("localhost", self._lsock.getsockname()[1])

        self._ctrl: list[socket.socket] = []
        self._cancel: list[socket.socket] = []
        for host, port in workers:
            self._ctrl.append(_connect_retry((host, port), "ctrl", connect_timeout))
            self._cancel.append(_connect_retry((host, port), "cancel", connect_timeout))
        # data stream to worker 1 (stage-0 activations out)
        self._data_out = _connect_retry(tuple(workers[0]), "data", connect_timeout)
        # accept the logits connection from the LAST worker (authenticated:
        # an unauthenticated peer could inject logits into generation)
        self._lsock.settimeout(connect_timeout)
        deadline = time.monotonic() + connect_timeout
        while True:
            self._logits_sock, _ = self._lsock.accept()
            self._logits_sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            hello, _ = recv_msg(self._logits_sock)
            if hello.get("role") == "logits" and _check_hello(hello, bind_host=head_bind):
                break
            self._logits_sock.close()
            if time.monotonic() > deadline:
                raise TimeoutError("no authenticated logits connection")
        self._lsock.settimeout(None)
        for wi, c in enumerate(self._ctrl):
            meta, _ = recv_msg(c)
            if meta.get("t") != "ready":
                raise RuntimeError(f"stage worker {wi + 1} sent {meta} before 'ready'")
            # validate the shared-indexing config fingerprint: silently
            # mismatched pools/splits would corrupt cell indices
            want = {
                "stage": wi + 1, "n_stages": n_stages, "n_cells": n_cells,
                "layers": list(self.ranges[wi + 1]),
                "n_embd": cfg.n_embd, "n_layers_total": cfg.n_layers,
            }
            got = {k: meta.get(k) for k in want}
            if got != want:
                raise RuntimeError(
                    f"stage worker {wi + 1} config mismatch: head expects "
                    f"{want}, worker reports {got}; start workers with the "
                    "same --model/--split/--n-cells/--n-stages"
                )

        self._next_run = 0
        self._pending: dict[int, _RemoteResult] = {}
        self._pending_lock = threading.Lock()
        self._hot = 0
        # single-thread sender: send order == dispatch order on the wire.
        # The high-water semaphore bounds queued ships (each pins a host
        # copy): a stalled worker backpressures decode_async instead of
        # growing host memory without limit
        self._send_pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        self._ship_slots = threading.BoundedSemaphore(StageWorker.SEND_HIGH_WATER)
        self._logits_thread = threading.Thread(target=self._logits_reader, daemon=True)
        self._logits_thread.start()

    @property
    def n_stages(self) -> int:
        return len(self.ranges)

    # warms what _dispatch runs here: stage 0 (the stages' own precompile
    # warms every stage of a pipeline held in this process)
    precompile = CellContext.precompile

    # -- plumbing ------------------------------------------------------------

    def _dispatch(self, arrays: tuple, topk: int | None) -> torch.Tensor:
        """Stage 0 only (first, not last, no topk: the logits come back from
        the LAST worker), so the inherited precompile warms what
        decode_async runs here."""
        dev = self.devices[0]
        tokens, pos, seq, cell_idx, valid, seq_bits = (h2d(a, dev) for a in arrays)
        return staged.stage_forward(self.stage_params[0], self.cfg, self.caches[0], tokens, pos,
                                    seq, cell_idx, valid, seq_bits, first=True, last=False,
                                    topk=None)

    def _logits_reader(self):
        try:
            while True:
                meta, payload = recv_msg(self._logits_sock)
                with self._pending_lock:
                    slot = self._pending.pop(meta["run"], None)
                if slot is not None:
                    slot.put(None if meta.get("dead")
                             else _unpack_arrays(meta["arrays"], payload)["x"])
        except (ConnectionError, OSError):
            with self._pending_lock:
                for slot in self._pending.values():
                    slot.put(ConnectionError("logits stream closed"))
                self._pending.clear()

    def _broadcast(self, meta: dict, payload: bytes = b""):
        for c in self._ctrl:
            send_msg(c, meta, payload)

    def _seq_op(self, op: str, **args):
        """Every worker applies the op in the head's order, then the head
        applies it to its own slab."""
        self._broadcast({"t": "kv", "op": op, "args": args})
        super()._seq_op(op, **args)

    def _refresh_hot(self):
        hot = kv.hot_bucket(self.h_pos, self.trash_cell)
        if hot != self._hot:
            self._hot = hot
            self._seq_op("hot", hot=hot)

    # -- decode --------------------------------------------------------------

    def decode_async(self, batch: Batch, topk: int | None = None) -> AsyncHandle:
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

        rid = self._next_run
        self._next_run += 1
        slot = _RemoteResult()
        with self._pending_lock:
            self._pending[rid] = slot

        # stage 0 here, then its output's host copy behind it on this
        # thread's stream (the ship thread only waits on the event)
        x = self._dispatch((tokens, pos, seq, cell_idx, valid, seq_bits), None)
        host, event = to_host_async(_wire_cast(x))

        # the microbatch metadata to every worker (the pipelined metadata
        # bcast, ggml-mpi.c:236-347), then the activation to worker 1
        ameta, blob = _pack_arrays({"pos": pos, "seq": seq, "seq_bits": seq_bits,
                                    "cell_idx": cell_idx, "valid": valid})
        self._broadcast({"t": "decode", "run": rid, "topk": topk, "arrays": ameta}, blob)

        def ship(_host=host, _event=event, _rid=rid):
            try:
                if _event is not None:
                    _event.synchronize()
                am, bl = _pack_arrays({"x": _host})
                send_msg(self._data_out, {"t": "act", "run": _rid, "arrays": am}, bl)
            finally:
                self._ship_slots.release()

        self._ship_slots.acquire()  # backpressure: bounded in-flight ships
        self._send_pool.submit(ship)

        def decode(_n=n, _t0=t0, _topk=topk, _isdecode=(n <= 2)):
            out = slot.value
            if isinstance(out, Exception):
                raise out
            if out is None:
                return None  # dead (canceled) run
            out = out[:_n]
            res = out if _topk is None else [unpack_sparse(out[i], _topk) for i in range(_n)]
            dt = time.perf_counter() - _t0
            if _isdecode:
                self.t_eval += dt
                self.n_eval += _n
            else:
                self.t_prefill += dt
                self.n_prefill += _n
            return res

        h = AsyncHandle(logits=x, decode=decode, cells=cells, event=slot)
        h.run_id = rid
        return h

    def cancel_run(self, handle: AsyncHandle):
        """Backwards-ring cancellation (ref: llama_cancel_run
        llama.cpp:9981-9993): overtakes queued decodes on the dedicated
        cancel channel; already-computed stages are sunk cost (the dead
        frame keeps the streams in sync)."""
        rid = getattr(handle, "run_id", None)
        if rid is None:
            return
        for c in self._cancel:
            send_msg(c, {"runs": [rid]})

    # -- lifecycle -----------------------------------------------------------

    def ping(self, timeout: float = 30.0) -> list[dict]:
        """Round-trip a control frame through every worker (startup/liveness
        barrier); raises socket.timeout if a worker wedges. Returns each
        worker's kernel launch counts (launch_counts) as of the ping, every
        command before it enqueued."""
        counts = []
        for c in self._ctrl:
            send_msg(c, {"t": "ping"})
            c.settimeout(timeout)
            try:
                meta, _ = recv_msg(c)
            finally:
                c.settimeout(None)
            if meta.get("t") != "pong":
                raise RuntimeError(f"ping answered with {meta}")
            counts.append(meta.get("launches", {}))
        return counts

    def shutdown(self):
        """ref: the GGML_MPI_SHUTDOWN broadcast (ggml-mpi.c:100-114)."""
        self._send_pool.shutdown(wait=True)
        try:
            self._broadcast({"t": "shutdown"})
        except OSError:
            pass
        for s in self._ctrl + self._cancel + [self._data_out, self._logits_sock, self._lsock]:
            try:
                s.close()
            except OSError:
                pass


# ---------------------------------------------------------------------------
# local cluster launcher (tests / single-machine multi-process runs)
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def worker_log(log_dir: str | os.PathLike, stage: int) -> str:
    """The file launch_local_cluster(log_dir=...) sends stage `stage`'s
    stderr to."""
    return os.path.join(log_dir, f"dcn_worker{stage}.log")


def launch_local_cluster(model_path: str, n_stages: int, *,
                         split: Sequence[float] | None = None,
                         n_cells: int = 1024, cache_dtype: str = "bf16",
                         device: str = "cuda", env_extra: dict | None = None,
                         log_dir: str | os.PathLike | None = None):
    """Spawn stages 1..S-1 as subprocesses of this machine and return
    (worker_addrs, head_port, procs). Worker i listens on its port and
    forwards to worker i+1; the last forwards to the head's logits port,
    which the head binds (RemoteStagedContext(head_port=...)).

    device is passed to every worker as --device: ``cuda`` puts them all
    on the current card (several processes share one GPU), and a worker
    without CUDA then raises rather than falling back to the CPU. CPU
    workers run one torch thread each (OMP_NUM_THREADS=1). stderr: where
    the workers' stderr goes (subprocess.PIPE to read their exit lines).

    A per-cluster shared secret is generated (unless PIPEINFER_DCN_TOKEN
    is already set) and exported to every worker AND this process, so the
    hello handshake authenticates even on loopback."""
    import secrets

    token = os.environ.get("PIPEINFER_DCN_TOKEN") or secrets.token_hex(16)
    os.environ["PIPEINFER_DCN_TOKEN"] = token
    ports = [_free_port() for _ in range(n_stages - 1)]
    head_port = _free_port()
    env = dict(os.environ)
    env["PIPEINFER_DCN_TOKEN"] = token
    env["PYTHONPATH"] = os.pathsep.join(
        [str(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else [])
    )
    if torch.device(device).type == "cpu":
        env["OMP_NUM_THREADS"] = "1"
    if env_extra:
        env.update(env_extra)
    procs = []
    for i in range(1, n_stages):
        nxt = f"localhost:{ports[i]}" if i < n_stages - 1 else f"localhost:{head_port}"
        args = [
            sys.executable, "-m", "pipeinfer_tpu_torch.parallel.dcn",
            "--model", str(model_path), "--stage", str(i),
            "--n-stages", str(n_stages), "--listen-port", str(ports[i - 1]),
            "--next", nxt, "--n-cells", str(n_cells),
            "--cache-dtype", cache_dtype, "--device", str(device),
        ]
        if split:
            args += ["--split", ",".join(str(x) for x in split)]
        if log_dir is None:
            procs.append(subprocess.Popen(args, env=env))
            continue
        with open(worker_log(log_dir, i), "w") as err:  # the child keeps its own handle
            procs.append(subprocess.Popen(args, env=env, stderr=err))
    workers = [("localhost", p) for p in ports]
    return workers, head_port, procs


if __name__ == "__main__":
    worker_main()
