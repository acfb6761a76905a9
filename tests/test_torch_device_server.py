"""The port's DeviceLoopServer (spec/device_multi.py) and the serving
scheduler's routing (serving/batching.py::SpecBatchScheduler) against the
JAX package's, on the CPU.

Hot-joining lanes over the batched device loop stay exact: each request's
tokens equal the JAX server's and its solo plain-greedy decode.
SpecBatchScheduler routes sampler-compatible requests to the device lanes
and grammar / penalty requests to the host-verified MultiPipeInfer, and it
does so on the port's contexts (which have no `mesh`; a copied JAX check
would have sent every request to the host path without a word).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pipeinfer_tpu.models import load_model as j_load
from pipeinfer_tpu.runtime.context import InferenceContext as JContext
from pipeinfer_tpu.sampling.samplers import SamplingParams as JSampling
from pipeinfer_tpu.serving.batching import Request as JRequest
from pipeinfer_tpu.serving.batching import SpecBatchScheduler as JScheduler
from pipeinfer_tpu.spec.device_multi import DeviceLoopServer as JServer
from pipeinfer_tpu.spec.params import SpecParams as JSpec
from pipeinfer_tpu_torch.models import load_model
from pipeinfer_tpu_torch.runtime.context import Batch, InferenceContext
from pipeinfer_tpu_torch.sampling.samplers import SamplerState, SamplingParams, sample
from pipeinfer_tpu_torch.serving.batching import Request, SpecBatchScheduler
from pipeinfer_tpu_torch.spec.device_multi import DeviceLoopServer
from pipeinfer_tpu_torch.spec.multi import MAX_SEQS
from pipeinfer_tpu_torch.spec.params import SpecParams
from pipeinfer_tpu_torch.tools import testmodel

torch.set_num_threads(1)  # several test processes share the machine (test_torch_cli.py)

GREEDY = dict(temp=0.0, penalty_repeat=1.0, penalty_last_n=0)
PENALTY = dict(temp=0.0, penalty_repeat=1.3, penalty_last_n=64)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """{"t"/"d": (JAX (params, cfg), port (params, cfg))}, one GGUF each."""
    d = tmp_path_factory.mktemp("torch_dsrv")
    testmodel.build_tiny_llama(d / "t.gguf", seed=5, n_layers=2, n_embd=128, n_heads=4,
                               n_kv_heads=2, n_ff=256, n_vocab=512)
    testmodel.build_tiny_llama(d / "d.gguf", seed=9, n_layers=1, n_embd=64, n_heads=2,
                               n_kv_heads=2, n_ff=128, n_vocab=512)
    return {k: (j_load(d / f"{k}.gguf"), load_model(d / f"{k}.gguf", device="cpu"))
            for k in ("t", "d")}


def tctx(m, n_cells=2048):
    return InferenceContext(*m, n_cells=n_cells, cache_dtype=torch.float32, device="cpu")


def jctx(m, n_cells=2048):
    return JContext(*m, n_cells=n_cells, cache_dtype=jnp.float32)


_plain_cache: dict = {}


def plain(models, prompt, n):
    """Solo plain-greedy decode of the target on a fresh context."""
    key = (tuple(prompt), n)
    if key not in _plain_cache:
        ctx = tctx(models["t"][1], 512)
        b = Batch()
        for i, t in enumerate(prompt):
            b.add(t, i, 0, want_logits=(i == len(prompt) - 1))
        logits = ctx.decode(b)[-1]
        out = []
        for n_past in range(len(prompt), len(prompt) + n):
            out.append(int(np.argmax(logits)))
            b.clear()
            b.add(out[-1], n_past, 0)
            logits = ctx.decode(b)[0]
        _plain_cache[key] = out
    return _plain_cache[key]


def servers(models, *, n_lanes, seq_base, eos_id=-1, n_cells=2048, draft="d"):
    """(port server, JAX server) over fresh contexts of the same pair."""
    t = DeviceLoopServer(tctx(models["t"][1], n_cells), tctx(models[draft][1], n_cells),
                         SamplingParams(**GREEDY), SpecParams(n_draft=4), n_lanes=n_lanes,
                         seq_base=seq_base, rounds=2, eos_id=eos_id)
    j = JServer(jctx(models["t"][0], n_cells), jctx(models[draft][0], n_cells),
                JSampling(**GREEDY), JSpec(n_draft=4), n_lanes=n_lanes, seq_base=seq_base,
                rounds=2, eos_id=eos_id)
    return t, j


def test_hot_join_exact(models):
    """5 requests through 2 lanes on slots 62-63: later requests hot-join
    lanes freed by earlier ones; every output equals the JAX server's and
    its solo plain-greedy decode."""
    prompts = [[3, 17, 42], [5, 9], [100, 200, 300, 400], [7, 8, 9], [1, 2]]
    ns = [12, 9, 15, 6, 11]
    srv, jsrv = servers(models, n_lanes=2, seq_base=62)
    hs = [srv.submit(p, n) for p, n in zip(prompts, ns)]
    jhs = [jsrv.submit(p, n) for p, n in zip(prompts, ns)]
    srv.run_until_idle()
    jsrv.run_until_idle()
    for h, jh, p, n in zip(hs, jhs, prompts, ns):
        assert h.done and h.error is None
        assert h.tokens == jh.tokens == plain(models, p, n)


def test_staggered_submit_mid_decode(models):
    """Requests submitted while other lanes are mid-decode join without
    perturbing the running streams (the dispatch-time active-mask join)."""
    cases = [([3, 17, 42], 20), ([5, 9], 18), ([100, 200, 300, 400], 10), ([7, 8, 9], 8)]
    got = []
    for srv in servers(models, n_lanes=2, seq_base=50):
        hs = [srv.submit(p, n) for p, n in cases[:2]]
        for _ in range(3):  # progress the first pair mid-flight
            srv.step(block=True)
        hs += [srv.submit(p, n) for p, n in cases[2:]]
        srv.run_until_idle()
        assert all(h.done for h in hs)
        got.append([h.tokens for h in hs])
    assert got[0] == got[1] == [plain(models, p, n) for p, n in cases]


def test_lane_cells_released(models):
    """Finished requests free ALL their KV cells (full seq clear): after
    idle, both pools are back to empty mirrors, and so is the device."""
    srv, _ = servers(models, n_lanes=2, seq_base=40, n_cells=1024)
    hs = [srv.submit([3 + i, 17, 42], 8) for i in range(4)]
    srv.run_until_idle()
    assert all(h.done for h in hs)
    for ctx in (srv.tgt, srv.dft):
        assert int((ctx.h_pos >= 0).sum()) == 0
        assert int((ctx.cache.pos >= 0).sum()) == 0 and not ctx.cache.seq.any()


def test_eos_retires_lane(models):
    """A lane hitting EOS retires early and its lane is reused."""
    want = plain(models, [3, 17, 42], 16)
    j = next(i for i in range(2, len(want)) if want[i] not in want[:i])
    srv, jsrv = servers(models, n_lanes=1, seq_base=10, eos_id=want[j])
    for s in (srv, jsrv):
        h = s.submit([3, 17, 42], 50)
        h2 = s.submit([5, 9], 6)  # queued behind the single lane
        s.run_until_idle()
        assert h.tokens == want[: j + 1]  # stops AT the eos token
        assert h2.done and h2.tokens == plain(models, [5, 9], 6)


def test_compatible_routing_envelope(models):
    """The port's compatible() answers as the JAX server's does."""
    stoch = dict(temp=0.8, penalty_repeat=1.0, penalty_last_n=0, seed=-1)
    asks = [GREEDY, dict(temp=0.0), PENALTY, dict(temp=0.8, penalty_repeat=1.0, penalty_last_n=0,
                                                  seed=3),
            stoch, dict(stoch, seed=7), dict(stoch, temp=0.5)]
    for chain in (GREEDY, stoch):
        srv = DeviceLoopServer(tctx(models["t"][1]), tctx(models["d"][1]),
                               SamplingParams(**chain), SpecParams(n_draft=4), n_lanes=1,
                               rounds=2, eos_id=-1)
        jsrv = JServer(jctx(models["t"][0]), jctx(models["d"][0]), JSampling(**chain),
                       JSpec(n_draft=4), n_lanes=1, rounds=2, eos_id=-1)
        got = [srv.compatible(SamplingParams(**a)) for a in asks]
        assert got == [jsrv.compatible(JSampling(**a)) for a in asks]
        assert got == ([True] + [False] * 6 if chain is GREEDY
                       else [False] * 4 + [True, False, False])


def _scheduler(models, cls, ctx, sp_cls, n_cells=4096, **kw):
    return cls(ctx(models["t"][0 if cls is JScheduler else 1], n_cells),
               ctx(models["d"][0 if cls is JScheduler else 1], n_cells),
               spec_params=sp_cls(n_draft=4, n_parallel=1, p_accept=0.0, max_inflight=2),
               max_slots=2, eos_id=-1, device_lanes=2, device_rounds=2, **kw)


def test_scheduler_routes_and_matches(models):
    """Mixed workload through SpecBatchScheduler: greedy requests ride the
    device lanes, the penalty request keeps host verification; every
    output equals the JAX scheduler's, greedy ones plain greedy too, and
    both engines carried work."""
    greedy_prompts = [[3, 17, 42], [5, 9], [100, 200]]
    results = []
    for cls, ctx, req, samp, sp_cls in ((SpecBatchScheduler, tctx, Request, SamplingParams,
                                         SpecParams),
                                        (JScheduler, jctx, JRequest, JSampling, JSpec)):
        sched = _scheduler(models, cls, ctx, sp_cls)
        assert sched.devsrv is not None
        reqs = [sched.submit(req(prompt_ids=p, n_predict=10, sampling=samp(**GREEDY)))
                for p in greedy_prompts]
        rp = sched.submit(req(prompt_ids=[11, 12], n_predict=8, sampling=samp(**PENALTY)))
        sched.run_until_idle()
        assert all(r.done and r.error is None for r in reqs + [rp])
        assert (sched.n_device_served, sched.n_host_served) == (3, 1)
        assert not sched.devsrv.compatible(samp(**PENALTY))
        results.append([r.generated for r in reqs + [rp]])
    assert results[0] == results[1]
    assert results[0][:3] == [plain(models, p, 10) for p in greedy_prompts]
    # the penalty stream shares the pool with the lanes: exact against plain
    # decoding under the same sampler chain
    st = SamplerState(params=SamplingParams(**PENALTY))
    ctx, b = tctx(models["t"][1], 512), Batch()
    for i, t in enumerate([11, 12]):
        st.accept(t, apply_grammar=False)
        b.add(t, i, 0, want_logits=(i == 1))
    logits, want = ctx.decode(b)[-1], []
    for n_past in range(2, 10):
        want.append(sample(st, logits))
        st.accept(want[-1])
        b.clear()
        b.add(want[-1], n_past, 0)
        logits = ctx.decode(b)[0]
    assert results[0][3] == want


def test_scheduler_device_lanes_on_port_contexts(models):
    """A SpecBatchScheduler built on port contexts with a greedy
    device_sampling has its device lanes (devsrv set); only a chain the
    device verifier cannot express leaves it without them."""
    sched = _scheduler(models, SpecBatchScheduler, tctx, SpecParams, n_cells=1024,
                       device_sampling=SamplingParams(**GREEDY))
    assert isinstance(sched.devsrv, DeviceLoopServer)
    assert sched.devsrv.seq_base == MAX_SEQS - 2
    off = _scheduler(models, SpecBatchScheduler, tctx, SpecParams, n_cells=1024,
                     device_sampling=SamplingParams(**PENALTY))
    assert off.devsrv is None and off.max_slots == off.engine.max_streams


def test_scheduler_seq_namespaces_disjoint(models):
    """The host engine's slot cap shrinks by the carved device lanes."""
    sched = SpecBatchScheduler(tctx(models["t"][1]), tctx(models["d"][1]),
                               spec_params=SpecParams(n_draft=4, n_parallel=1, max_inflight=2),
                               eos_id=-1, device_lanes=4)
    stride = 1 + 1 * 2
    assert sched.engine.max_streams <= (MAX_SEQS - 4) // stride
    assert sched.devsrv.seq_base == MAX_SEQS - 4


def test_admit_reserves_running_lanes(models):
    """Admission reserves the running lanes' outstanding n_predict and one
    pool's worth of dispatch scratch: two requests that each fit the pool
    alone but not together run one after the other, both exact."""
    srv = DeviceLoopServer(tctx(models["t"][1], 176), tctx(models["d"][1], 176),
                           SamplingParams(**GREEDY), SpecParams(n_draft=4), n_lanes=2,
                           seq_base=60, rounds=2, eos_id=-1)
    assert srv.scratch == 2 * 2 * 2 * (2 * 4 + 1)
    h1 = srv.submit([3, 17, 42], 100)
    h2 = srv.submit([5, 9, 11], 100)
    srv.step()
    assert [h for h in srv.lanes if h is not None] == [h1], "the second request must wait"
    assert srv.queue == [h2]
    srv.run_until_idle()
    for h, p in ((h1, [3, 17, 42]), (h2, [5, 9, 11])):
        assert h.done and h.error is None, h.error
        assert h.tokens == plain(models, p, 100)


def test_tight_pool_serves_every_request(models):
    """A pool sized to one request plus the dispatch scratch (the JAX
    package reserves a per-lane share of scratch there, ADVICE.md): every
    queued request completes, exact, and a request that can never fit
    fails at once with an error instead of waiting forever."""
    prompts = [[3, 17, 42], [5, 9], [100, 200, 300], [7, 8, 9], [1, 2]]
    ns = [60, 20, 40, 61, 30]
    scratch = 2 * 2 * 2 * (2 * 4 + 1)
    n_cells = 3 + 61 + scratch + 1  # the largest request + scratch + the trash cell
    srv = DeviceLoopServer(tctx(models["t"][1], n_cells), tctx(models["d"][1], n_cells),
                           SamplingParams(**GREEDY), SpecParams(n_draft=4), n_lanes=2,
                           seq_base=0, rounds=2, eos_id=-1)
    hs = [srv.submit(p, n) for p, n in zip(prompts, ns)]
    too_big = srv.submit([4, 5, 6], 62)
    srv.run_until_idle()
    for h, p, n in zip(hs, prompts, ns):
        assert h.done and h.error is None, h.error
        assert h.tokens == plain(models, p, n)
    assert too_big.done and "KV cells" in too_big.error and not too_big.tokens
    assert int((srv.tgt.h_pos >= 0).sum()) == 0
