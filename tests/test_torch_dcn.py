"""The port's cross-process pipeline (parallel/dcn.py) on the CPU, mirroring
the JAX package's tests/test_dcn.py: stage workers in their own OS
processes (``--device cpu``), the head's RemoteStagedContext holding stage
0, each case held to the JAX package's single-process InferenceContext on
the same GGUF. Also: the frames are the JAX package's byte for byte (the
bf16 wire's words equal ml_dtypes' cast), a remote handle is not ready
before its logits frame lands, every worker exits 0 with its launch line,
and a worker asked for CUDA without it fails instead of falling back."""

import os
import socket
import subprocess
import sys
import threading
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pipeinfer_tpu.models import load_model as j_load
from pipeinfer_tpu.parallel import dcn as j_dcn
from pipeinfer_tpu.runtime.context import Batch as JBatch
from pipeinfer_tpu.runtime.context import InferenceContext as JContext
from pipeinfer_tpu_torch.models import load_model
from pipeinfer_tpu_torch.parallel import dcn
from pipeinfer_tpu_torch.parallel.dcn import (RemoteStagedContext, StageWorker,
                                              launch_local_cluster, recv_msg, send_msg)
from pipeinfer_tpu_torch.runtime.context import Batch
from pipeinfer_tpu_torch.runtime.context import InferenceContext
from pipeinfer_tpu_torch.sampling.samplers import SamplingParams
from pipeinfer_tpu_torch.spec.controller import PipeInferController
from pipeinfer_tpu_torch.spec.params import SpecParams
from pipeinfer_tpu_torch.tools import testmodel

from .test_sync_spec import CFG, N_PREDICT, PROMPT, _plain_greedy

torch.set_num_threads(1)  # several test processes share the machine

subproc = pytest.mark.skipif(os.environ.get("CI_NO_SUBPROC"), reason="subprocess test")

TOL = dict(rtol=2e-4, atol=2e-4)  # test_dcn.py's bar: f32 steps, summation order
BF16_TOL = dict(rtol=3e-2, atol=3e-2)  # test_dcn.py's bar for the bf16 wire
N_CELLS = 256


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    p = tmp_path_factory.mktemp("torch_dcn") / "m4.gguf"
    testmodel.build_tiny_llama(p, seed=7, **dict(CFG, n_layers=4))
    return p


@pytest.fixture(scope="module")
def model(path):
    return load_model(path, device="cpu")


@pytest.fixture(scope="module")
def jmodel(path):
    return j_load(path)


def _jsingle(jmodel):
    return JContext(*jmodel, n_cells=N_CELLS, cache_dtype=jnp.float32)


def _prompt(batch=Batch):
    b = batch()
    for i, t in enumerate(PROMPT):
        b.add(t, i, 0, want_logits=True)
    return b


def _one(token, pos, batch=Batch):
    b = batch()
    b.add(token, pos, 0)
    return b


class _Cluster:
    """A head over n_stages - 1 CPU stage workers, whose stderr goes to a
    log file each (dcn.worker_log)."""

    def __init__(self, path, model, n_stages, tmp_path, monkeypatch, wire="f32", n_cells=N_CELLS):
        # token-exact cases pin the f32 wire; the default bf16 wire has its
        # own tolerance-adjusted case, as in test_dcn.py
        monkeypatch.setenv("PIPEINFER_DCN_WIRE", wire)
        self.logs = [Path(dcn.worker_log(tmp_path, i)) for i in range(1, n_stages)]
        workers, head_port, self.procs = launch_local_cluster(
            str(path), n_stages, n_cells=n_cells, cache_dtype="f32", device="cpu",
            log_dir=tmp_path)
        try:
            self.ctx = RemoteStagedContext(*model, workers=workers, n_cells=n_cells,
                                           cache_dtype=torch.float32, head_port=head_port,
                                           device="cpu", connect_timeout=180)
        except BaseException:
            for p in self.procs:
                p.kill()
            raise

    def close(self) -> list[int]:
        """Shut the cluster down; the workers' exit codes."""
        self.ctx.shutdown()
        rcs = []
        for p in self.procs:
            try:
                rcs.append(p.wait(timeout=60))
            except subprocess.TimeoutExpired:
                p.kill()
                rcs.append(None)
        return rcs


@pytest.fixture
def cluster(path, model, tmp_path, monkeypatch):
    made = []

    def make(n_stages, wire="f32"):
        c = _Cluster(path, model, n_stages, tmp_path, monkeypatch, wire)
        made.append(c)
        return c.ctx

    yield make
    for c in made:
        assert c.close() == [0] * len(c.procs), "a stage worker did not exit 0"


@subproc
@pytest.mark.parametrize("n_stages", [2, 3])
def test_remote_decode_matches_jax_single(jmodel, cluster, n_stages):
    """One layer range per PROCESS: the port's cross-process decode equals
    the JAX package's single-process logits: the prompt, three async steps
    in flight at once, then a rollback fanned out to every stage."""
    single = _jsingle(jmodel)
    ctx = cluster(n_stages)
    ctx.ping()
    assert ctx.n_stages == n_stages
    np.testing.assert_allclose(ctx.decode(_prompt()), np.asarray(single.decode(_prompt(JBatch))),
                               **TOL)
    handles = [ctx.decode_async(_one(40 + j, len(PROMPT) + j)) for j in range(3)]
    for j, h in enumerate(handles):
        want = np.asarray(single.decode(_one(40 + j, len(PROMPT) + j, JBatch)))
        np.testing.assert_allclose(h.fetch(), want, **TOL)
    ctx.rm_tail(len(PROMPT))
    single.rm_tail(len(PROMPT))
    np.testing.assert_allclose(ctx.decode(_one(7, len(PROMPT))),
                               np.asarray(single.decode(_one(7, len(PROMPT), JBatch))), **TOL)
    # the sparse head comes back from the last worker too
    (got,) = ctx.decode(_one(9, len(PROMPT) + 1), topk=8)
    (want,) = single.decode(_one(9, len(PROMPT) + 1, JBatch), topk=8)
    assert got.ids.tolist() == want.ids.tolist()
    np.testing.assert_allclose(got.vals, want.vals, **TOL)


@subproc
def test_pipeinfer_controller_over_processes(jmodel, model, cluster):
    """PipeInferController drives a 3-stage cross-process target (2 worker
    processes) and a local draft; its greedy stream equals the JAX
    package's plain greedy decoding, host-verified (neither fused nor
    corrected over a remote target)."""
    want = _plain_greedy(*jmodel)
    ctx = cluster(3)
    dft = InferenceContext(*model, n_cells=N_CELLS, cache_dtype=torch.float32, device="cpu")
    c = PipeInferController(
        ctx, dft, SamplingParams(temp=0.0),
        SpecParams(n_draft=4, n_parallel=1, p_accept=0.0, max_inflight=3), eos_id=-1)
    assert not c.use_fused and not c.use_corrected
    got = c.generate(list(PROMPT), N_PREDICT)
    assert got == want, f"cross-process pipeline diverges: {got} vs {want}"
    assert c.stats.n_accept > 0
    # cancellations (if any) crossed without desync: the engine still works
    for s in range(1, 8):
        ctx.seq_rm(s)
        dft.seq_rm(s)
    ctx.rm_tail(len(PROMPT))
    ctx.ping()


@subproc
def test_cancellations_cross_processes(tmp_path, monkeypatch):
    """On the nano bench pair (eps = 0.5: half the drafts rejected) the
    controller over 3 processes cancels runs in flight, their dead frames
    keep every stage in step, and the stream equals plain greedy decoding
    on one context; both workers exit 0."""
    t_path, d_path = tmp_path / "t.gguf", tmp_path / "d.gguf"
    testmodel.build_bench_pair(t_path, d_path, scale="nano", eps=0.5)
    tm, dm = load_model(t_path, device="cpu"), load_model(d_path, device="cpu")
    prompt, n = [1, 5, 9, 33, 70], 64
    greedy = SamplingParams(temp=0.0, penalty_repeat=1.0, penalty_last_n=0)
    single = InferenceContext(*tm, n_cells=512, cache_dtype=torch.float32, device="cpu")
    b = Batch()
    for i, t in enumerate(prompt):
        b.add(t, i, 0, want_logits=i == len(prompt) - 1)
    want = [int(np.argmax(single.decode(b)[-1]))]
    for i in range(n - 1):
        want.append(int(np.argmax(single.decode(_one(want[-1], len(prompt) + i))[0])))
    c = _Cluster(t_path, tm, 3, tmp_path, monkeypatch, n_cells=512)
    try:
        ctrl = PipeInferController(
            c.ctx, InferenceContext(*dm, n_cells=512, cache_dtype=torch.float32, device="cpu"),
            greedy, SpecParams(n_draft=8, n_parallel=1, p_accept=0.1, p_split=0.9,
                               max_inflight=4), eos_id=-1)
        got = ctrl.generate(list(prompt), n, ignore_eos=True)
    finally:
        rcs = c.close()
    assert got == want
    assert ctrl.metrics.n_canceled_runs > 0 and ctrl.stats.n_accept > 0
    assert rcs == [0, 0]


@subproc
def test_remote_seq_shift(jmodel, cluster):
    """Context sliding crosses the process boundary: shift on every stage,
    then a decode at the shifted positions equals the JAX package's single
    context doing the same."""
    single = _jsingle(jmodel)
    ctx = cluster(2)
    for c, batch in ((single, JBatch), (ctx, Batch)):
        c.decode(_prompt(batch))
        c.seq_rm(0, 0, 1)
        c.seq_shift(0, 1, len(PROMPT), -1)
    np.testing.assert_allclose(
        ctx.decode(_one(42, len(PROMPT) - 1)),
        np.asarray(single.decode(_one(42, len(PROMPT) - 1, JBatch))), **TOL)


@subproc
def test_bf16_wire_decode_and_controller(jmodel, model, cluster):
    """The DEFAULT inter-stage wire ships activations as bf16 words: logits
    within the bf16 tolerance of the JAX package's single context, not bit
    equal, and the async controller still speculates over it; the head
    switching to f32 takes the workers with it."""
    single = _jsingle(jmodel)
    ctx = cluster(2, wire="bf16")
    ctx.ping()
    want = np.asarray(single.decode(_prompt(JBatch)))
    got = ctx.decode(_prompt())
    np.testing.assert_allclose(got, want, **BF16_TOL)
    assert np.abs(got - want).max() > 0, "wire suspiciously exact"
    ctx.rm_tail(0)
    dft = InferenceContext(*model, n_cells=N_CELLS, cache_dtype=torch.float32, device="cpu")
    c = PipeInferController(
        ctx, dft, SamplingParams(temp=0.0),
        SpecParams(n_draft=3, n_parallel=1, p_accept=0.0, max_inflight=2), eos_id=-1)
    assert len(c.generate(list(PROMPT), 12)) == 12
    assert c.stats.n_accept > 0
    # the head's wire rules the pipeline: the same workers relay f32 once
    # the head sends f32
    os.environ["PIPEINFER_DCN_WIRE"] = "f32"
    ctx.rm_tail(0)
    np.testing.assert_allclose(ctx.decode(_prompt()), want, **TOL)


@subproc
def test_unauthenticated_peer_rejected(cluster):
    """A peer without the cluster token is closed on in every role, and so
    is a peer with it once the worker's three roles are taken."""
    ctx = cluster(2)
    ctx.ping()
    wport = ctx._ctrl[0].getpeername()[1]
    token = os.environ["PIPEINFER_DCN_TOKEN"]
    for role, tok in (("ctrl", "wrong-token"), ("data", "wrong-token"),
                      ("cancel", "wrong-token"), ("ctrl", token)):
        s = socket.create_connection(("localhost", wport), timeout=5)
        send_msg(s, {"role": role, "token": tok})
        s.settimeout(10)
        with pytest.raises(ConnectionError):
            recv_msg(s)  # the worker closes on us
        s.close()
    # a peer that sends no JSON is closed on too
    s = socket.create_connection(("localhost", wport), timeout=5)
    s.sendall(b"\x04\x00\x00\x00\x00\x00\x00\x00junk")
    s.settimeout(10)
    with pytest.raises(ConnectionError):
        recv_msg(s)
    s.close()
    ctx.ping()  # the real cluster is unaffected


def _gate_head_data(ctx, monkeypatch) -> threading.Event:
    """Hold every activation the head sends to worker 1 until the returned
    event is set (a stand-in for a stalled worker: the kernel's socket
    buffers would otherwise absorb small test frames)."""
    gate = threading.Event()
    real_send = dcn.send_msg
    data_sock = ctx._data_out

    def gated_send(sock, meta, payload=b""):
        if sock is data_sock and meta.get("t") == "act":
            gate.wait()
        return real_send(sock, meta, payload)

    monkeypatch.setattr(dcn, "send_msg", gated_send)
    return gate


@subproc
def test_stalled_worker_bounded_backpressure(jmodel, cluster, monkeypatch):
    """With the data wire to worker 1 gated shut, decode_async blocks once
    SEND_HIGH_WATER ships are queued instead of queueing without limit;
    when the gate opens everything drains and the results are right."""
    ctx = cluster(2)
    ctx.decode(_prompt())  # warm the pipeline end to end
    gate = _gate_head_data(ctx, monkeypatch)
    n_burst = StageWorker.SEND_HIGH_WATER + 6
    handles = []
    done = threading.Event()

    def burst():
        for j in range(n_burst):
            handles.append(ctx.decode_async(_one(40 + j, len(PROMPT) + j)))
        done.set()

    threading.Thread(target=burst, daemon=True).start()
    assert not done.wait(timeout=5.0), "head dispatched an unbounded burst into a stalled wire"
    assert len(handles) <= StageWorker.SEND_HIGH_WATER + 1, len(handles)
    gate.set()
    assert done.wait(timeout=60.0), "head never unblocked after the gate opened"
    single = _jsingle(jmodel)
    single.decode(_prompt(JBatch))
    for j, h in enumerate(handles):
        want = np.asarray(single.decode(_one(40 + j, len(PROMPT) + j, JBatch)))
        np.testing.assert_allclose(h.fetch(), want, **TOL)


@subproc
def test_handle_not_ready_before_logits_frame(jmodel, cluster, monkeypatch):
    """ready() is the controller's iprobe: False until the run's logits
    frame has landed (here held back by gating the activation it needs),
    True after, without blocking either way."""
    ctx = cluster(2)
    ctx.decode(_prompt())
    gate = _gate_head_data(ctx, monkeypatch)
    h = ctx.decode_async(_one(40, len(PROMPT)))
    for _ in range(5):
        assert not h.ready(), "a remote handle reported ready before its logits frame"
        threading.Event().wait(0.1)
    gate.set()
    got = h.fetch()
    assert h.ready()
    single = _jsingle(jmodel)
    single.decode(_prompt(JBatch))
    np.testing.assert_allclose(got, np.asarray(single.decode(_one(40, len(PROMPT), JBatch))),
                               **TOL)


@subproc
def test_worker_exit_line(path, model, tmp_path, monkeypatch):
    """At shutdown a worker exits 0 and writes one stderr line with its
    stage, its device and its kernel launch counters (0 on the CPU, where
    the wrappers run their plain versions)."""
    c = _Cluster(path, model, 2, tmp_path, monkeypatch)
    c.ctx.decode(_prompt())
    (counts,) = c.ctx.ping()
    assert sorted(counts) == sorted(dcn.launch_counts()) and not any(counts.values())
    assert c.close() == [0]
    lines = [ln for ln in c.logs[0].read_text().splitlines() if ln.startswith("dcn worker:")]
    assert len(lines) == 1, c.logs[0].read_text()
    assert lines[0].startswith("dcn worker: stage 1 device cpu launches {")
    assert '"i4g_matmul": 0' in lines[0] and '"cell_attention": 0' in lines[0]


@subproc
def test_worker_asked_for_cuda_without_it_fails(path, monkeypatch):
    """No fallback: a worker started with --device cuda on a machine
    without CUDA exits non-zero naming CUDA, before it listens."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    monkeypatch.setenv("PYTHONPATH", str(Path(__file__).resolve().parent.parent))
    out = subprocess.run(
        [sys.executable, "-m", "pipeinfer_tpu_torch.parallel.dcn", "--model", str(path),
         "--stage", "1", "--n-stages", "2", "--listen-port", "0", "--next", "localhost:1",
         "--device", "cuda"], capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "CUDA" in out.stderr


def test_frames_match_jax_bytes():
    """The wire protocol is the JAX package's: the same meta and payload
    for the metadata arrays, and the bf16 activation's words equal to
    ml_dtypes' round-to-nearest-even cast, widened back alike."""
    rng = np.random.default_rng(3)
    meta_arrays = {"pos": np.arange(8, dtype=np.int32), "valid": rng.random(8) < 0.5,
                   "seq_bits": rng.integers(-2**31, 2**31 - 1, (8, 2), dtype=np.int32)}
    assert dcn._pack_arrays(meta_arrays) == j_dcn._pack_arrays(meta_arrays)
    x = (rng.standard_normal((8, 64)) * 10).astype(np.float32)
    x[0, :4] = [1 + 2**-8, 1 + 3 * 2**-8, -0.0, np.float32(3e38)]  # ties and edges
    tmeta, tblob = dcn._pack_arrays({"x": dcn._wire_cast(torch.from_numpy(x))})
    import ml_dtypes

    jmeta, jblob = j_dcn._pack_arrays({"x": x.astype(ml_dtypes.bfloat16)})
    assert tmeta == jmeta and tblob == jblob
    got = dcn._unpack_arrays(tmeta, tblob)["x"]
    want = j_dcn._wire_uncast(j_dcn._unpack_arrays(jmeta, jblob)["x"])
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_f32_wire_keeps_activations(monkeypatch):
    monkeypatch.setenv("PIPEINFER_DCN_WIRE", "f32")
    t = torch.randn(4, 8)
    assert dcn._wire_cast(t) is t
    monkeypatch.setenv("PIPEINFER_DCN_WIRE", "bf16")
    assert dcn._wire_cast(t).dtype == torch.bfloat16
    assert dcn._wire_cast(t.long()).dtype == torch.long  # only f32 is reduced


def test_hello_needs_token_off_loopback(monkeypatch):
    monkeypatch.delenv("PIPEINFER_DCN_TOKEN", raising=False)
    assert dcn._check_hello({"token": ""}, bind_host="localhost")
    assert not dcn._check_hello({"token": ""}, bind_host="0.0.0.0")
    monkeypatch.setenv("PIPEINFER_DCN_TOKEN", "s3cret")
    assert dcn._check_hello({"token": "s3cret"}, bind_host="0.0.0.0")
    assert not dcn._check_hello({"token": "guess"}, bind_host="localhost")
