"""The port's multi-process path (parallel/multihost.py) on the CPU,
mirroring the JAX package's tests/test_multihost.py: two real OS
processes join one torch.distributed process group over gloo on
localhost, build one global mesh over their CPU "devices" (four each, as
the JAX test gives each process four virtual devices) and run sharded
computations whose collectives cross the process boundary: the mesh
collectives themselves, the fused pp(2) x tp(2) x dp(2) step (the stage
axis across the processes) against the same step in one process, and
the PipeInfer controller over a TP target whose 'model' axis spans both
processes (one controller per process) against one process's run.

Results travel through per-rank files. Every worker has a time limit and
is killed past it, so a rank left waiting in a collective fails the test
instead of hanging it. Every worker ends in multihost.shutdown() (a
barrier, then the group destroyed), so no rank exits while the other still
holds gloo pairs to it. Workers that exit without it abort now and then
under load ("terminate called without an active exception", or a rank
left waiting at exit): about 1 pair in 100 on a loaded 8-core host, and
no pair of as many that end in shutdown(). The coordinator's port is
picked below the kernel's ephemeral range, where other tests' sockets do
not land. A launch is started again on another port only where rank 0
exited with a Python error naming EADDRINUSE (its port was taken after
all) and no worker aborted; each such launch's stderr is reported as a
warning, so a failure the retry absorbs stays in the run's log."""

import json
import os
import random
import socket
import subprocess
import sys
import textwrap
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from pipeinfer_tpu_torch.models import load_model
from pipeinfer_tpu_torch.parallel import pipefused as pf
from pipeinfer_tpu_torch.parallel.tp import tp_mesh
from pipeinfer_tpu_torch.runtime.context import InferenceContext
from pipeinfer_tpu_torch.sampling.samplers import SamplingParams
from pipeinfer_tpu_torch.spec.controller import PipeInferController
from pipeinfer_tpu_torch.spec.params import SpecParams
from pipeinfer_tpu_torch.tools import testmodel

torch.set_num_threads(1)  # several test processes share the machine

ROOT = Path(__file__).resolve().parent.parent
WORKER_TIMEOUT = 240  # seconds per worker process
TOKENS = [3, 9, 21, 40]
PIPE_RTOL = 2e-3  # tests/test_multihost.py's bar

PRELUDE = textwrap.dedent(
    """
    import json, sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    pid = int(sys.argv[1]); port = sys.argv[2]; out_path = sys.argv[3]
    from pipeinfer_tpu_torch.parallel.multihost import (global_devices, global_mesh,
                                                         init_distributed, replicate_to_mesh,
                                                         shutdown)
    init_distributed(f"localhost:{port}", num_processes=2, process_id=pid, timeout_s=200)
    import torch.distributed as dist
    assert dist.get_world_size() == 2 and dist.get_rank() == pid
    """
)
EPILOGUE = "shutdown()\n"  # every worker's shared ending

WORKER_MESH = PRELUDE + textwrap.dedent(
    """
    mesh = global_mesh(pp=2, tp=2, dp=2, local_devices=["cpu"] * 4)
    assert mesh.devices.shape == (2, 2, 2) and len(mesh.local) == 4
    assert mesh.spans_processes("stage") and not mesh.spans_processes("model")
    # replicated weights x sharded activations: the model axis sums within
    # this process, the stage axis across the two
    w = replicate_to_mesh(np.arange(16, dtype=np.float32).reshape(4, 4), mesh)
    part = []
    for c, wc in zip(mesh.local, w):
        m = mesh.index(c, "model")
        part.append(torch.ones(4, 2) @ wc[:, 2 * m: 2 * m + 2].T)
    full = mesh.psum(part, "model")
    total = mesh.psum([f.sum().reshape(1) for f in full], "data")
    both = mesh.psum(total, "stage")
    stage = [torch.tensor([float(mesh.index(c, "stage"))]) for c in mesh.local]
    hop = mesh.ppermute(stage, "stage", [(0, 1), (1, 0)])
    gathered = mesh.all_gather(stage, "stage", dim=0)
    with open(out_path, "w") as f:
        json.dump(dict(total=[float(t) for t in total], both=[float(b) for b in both],
                       hop=[float(h) for h in hop], stage=[float(s) for s in stage],
                       gathered=[g.tolist() for g in gathered]), f)
    """
) + EPILOGUE

WORKER_PIPE = PRELUDE + textwrap.dedent(
    """
    from pipeinfer_tpu_torch.models import load_model
    from pipeinfer_tpu_torch.parallel import pipefused as pf
    params, cfg = load_model(sys.argv[4], device="cpu")  # every process reads the file
    pc = pf.PipeConfig(n_stages=2, tp=2, dp=2)
    mesh = global_mesh(pp=2, tp=2, dp=2, local_devices=["cpu"] * 4)
    stacked = pf.stack_params(params, cfg, pc, mesh)
    cache = pf.init_cache(cfg, pc, mesh, batch=2, max_len=16)
    step = pf.build_step(cfg, pc, mesh)
    toks = np.tile(np.asarray([3, 9, 21, 40], np.int32), (2, 1))
    logits, cache = step(stacked, cache, toks, np.arange(4, dtype=np.int32), 0)
    logits2, _ = step(stacked, cache, np.full((2, 1), 7, np.int32), np.asarray([4], np.int32), 4)
    np.savez(out_path, prompt=logits.numpy(), step=logits2.numpy())
    """
) + EPILOGUE

WORKER_CTRL = PRELUDE + textwrap.dedent(
    """
    from pipeinfer_tpu_torch.models import load_model
    from pipeinfer_tpu_torch.parallel.tp import tp_mesh
    from pipeinfer_tpu_torch.runtime.context import InferenceContext
    from pipeinfer_tpu_torch.sampling.samplers import SamplingParams
    from pipeinfer_tpu_torch.spec.controller import PipeInferController
    from pipeinfer_tpu_torch.spec.params import SpecParams
    params, cfg = load_model(sys.argv[4], device="cpu")
    # a TP target over a 'model' axis spanning both processes: every step
    # ends in collectives, and the controller runs in each process
    devs, ranks = global_devices(["cpu"] * 4)
    mesh = tp_mesh(devs, ranks)
    tgt = InferenceContext(params, cfg, n_cells=128, mesh=mesh, cache_dtype=torch.float32)
    dft = InferenceContext(params, cfg, n_cells=128, cache_dtype=torch.float32, device="cpu")
    ctrl = PipeInferController(
        tgt, dft, SamplingParams(temp=0.0, penalty_repeat=1.0, penalty_last_n=0),
        SpecParams(n_draft=3, n_parallel=1, p_accept=0.0, max_inflight=2), eos_id=-1)
    toks = ctrl.generate([3, 9, 21, 40], 10)
    with open(out_path, "w") as f:
        json.dump(dict(tokens=toks, fused=ctrl.use_fused, corrected=ctrl.use_corrected), f)
    """
) + EPILOGUE


PORTS = (20000, 32000)  # below Linux's ephemeral range (32768-60999): no port-0 socket lands here
LAUNCHES = 3  # launches to try while the picked port turns out taken


def _free_port() -> int:
    """A port that was free a moment ago. It is released before rank 0
    binds it, so another process may still take it: _run_two retries."""
    while True:
        port = random.randrange(*PORTS)
        with socket.socket() as s:
            try:
                s.bind(("localhost", port))
            except OSError:
                continue
            return port


def _port_taken(results) -> bool:
    """Whether a launch failed only because rank 0 could not bind its port:
    rank 0 exited with a Python error (code 1, not a signal) naming
    EADDRINUSE, and no worker's stderr shows an abort."""
    rc, _, err = results[0]
    return (rc == 1 and "EADDRINUSE" in err
            and not any("terminate called" in e for _, _, e in results))


def _run_two(tmp_path, worker_src, suffix, extra_args=()) -> list[Path]:
    """Run the worker as ranks 0 and 1; returns their result files."""
    script = tmp_path / "worker.py"
    script.write_text(worker_src)
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    outs = [tmp_path / f"result_{pid}{suffix}" for pid in range(2)]
    for launch in range(LAUNCHES):
        port = _free_port()
        procs = [subprocess.Popen([sys.executable, str(script), str(pid), str(port),
                                   str(outs[pid]), *map(str, extra_args)],
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env,
                                  text=True)
                 for pid in range(2)]
        results = []
        try:
            for p in procs:  # rank 0 first: it binds the port
                out, err = p.communicate(timeout=WORKER_TIMEOUT)
                results.append((p.returncode, out, err))
                if p.returncode != 0:
                    break  # the other rank is killed below
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if launch + 1 < LAUNCHES and _port_taken(results):
            warnings.warn(f"multihost launch {launch} on port {port} started again, rank 0 "
                          f"failed to bind:\n{results[0][2][-3000:]}")
            continue
        for rc, out, err in results:
            assert rc == 0, f"worker failed:\n{out}\n{err[-3000:]}"
        break
    for pid in range(2):
        assert outs[pid].exists(), f"rank {pid} wrote no result file"
    return outs


@pytest.mark.skipif(os.environ.get("CI_NO_SUBPROC"), reason="subprocess test")
def test_two_process_global_mesh(tmp_path):
    res = [json.loads(p.read_text()) for p in _run_two(tmp_path, WORKER_MESH, ".json")]
    for pid, r in enumerate(res):
        # x = ones [8, 4] @ w.T summed: every row gives sum(w) = 120
        assert r["total"] == [8 * 120.0] * 4
        assert r["both"] == [2 * 8 * 120.0] * 4  # the psum over 'stage' crossed processes
        assert r["stage"] == [float(pid)] * 4  # global_mesh: one stage per process
        assert r["hop"] == [float(1 - pid)] * 4  # the ppermute brought the other's
        assert r["gathered"] == [[0.0, 1.0]] * 4


@pytest.fixture(scope="module")
def pipe_model(tmp_path_factory):
    path = tmp_path_factory.mktemp("torch_mh") / "m.gguf"
    testmodel.build_tiny_llama(path, seed=5, n_layers=4, n_embd=64, n_heads=4, n_kv_heads=2,
                               n_ff=128, n_vocab=96)
    return path


@pytest.mark.skipif(os.environ.get("CI_NO_SUBPROC"), reason="subprocess test")
def test_two_process_pipefused_step(tmp_path, pipe_model):
    """The fused pp(2) x tp(2) x dp(2) step over a two-process global mesh
    (the stage axis across the processes): both processes' logits, the
    prompt's and one decode step's, equal the one-process step's."""
    outs = _run_two(tmp_path, WORKER_PIPE, ".npz", extra_args=(pipe_model,))
    params, cfg = load_model(pipe_model, device="cpu")
    pc = pf.PipeConfig(n_stages=2, tp=2, dp=2)
    mesh = pf.make_mesh(pc, ["cpu"] * 8)
    stacked = pf.stack_params(params, cfg, pc, mesh)
    cache = pf.init_cache(cfg, pc, mesh, batch=2, max_len=16)
    step = pf.build_step(cfg, pc, mesh)
    want, cache = step(stacked, cache, np.tile(np.asarray(TOKENS, np.int32), (2, 1)),
                       np.arange(4, dtype=np.int32), 0)
    want2, _ = step(stacked, cache, np.full((2, 1), 7, np.int32), np.asarray([4], np.int32), 4)
    for out in outs:
        got = np.load(out)
        for key, w in (("prompt", want.numpy()), ("step", want2.numpy())):
            assert got[key].shape == w.shape
            assert np.abs(got[key] - w).max() / np.abs(w).max() < PIPE_RTOL, key
            assert abs(np.abs(got[key]).sum() - np.abs(w).sum()) / np.abs(w).sum() < PIPE_RTOL


@pytest.mark.skipif(os.environ.get("CI_NO_SUBPROC"), reason="subprocess test")
def test_two_process_controller_generation(tmp_path):
    """The PipeInfer controller runs in each of two processes over one TP
    target whose 8-way 'model' axis crosses the process boundary: both
    emit the one-process run's tokens, host-verified."""
    model = tmp_path / "m.gguf"
    # dims divisible by the 8-way model axis
    testmodel.build_tiny_llama(model, seed=5, n_layers=2, n_embd=128, n_heads=8, n_kv_heads=8,
                               n_ff=256, n_vocab=96)
    outs = _run_two(tmp_path, WORKER_CTRL, ".json", extra_args=(model,))
    params, cfg = load_model(model, device="cpu")
    tgt = InferenceContext(params, cfg, n_cells=128, mesh=tp_mesh(["cpu"] * 8),
                           cache_dtype=torch.float32)
    dft = InferenceContext(params, cfg, n_cells=128, cache_dtype=torch.float32, device="cpu")
    ctrl = PipeInferController(
        tgt, dft, SamplingParams(temp=0.0, penalty_repeat=1.0, penalty_last_n=0),
        SpecParams(n_draft=3, n_parallel=1, p_accept=0.0, max_inflight=2), eos_id=-1)
    want = ctrl.generate(list(TOKENS), 10)
    for pid, out in enumerate(outs):
        got = json.loads(out.read_text())
        assert got["tokens"] == want, (pid, got, want)
        assert not got["fused"] and not got["corrected"]
