"""The port's main path end to end on the CPU against the JAX package:
load -> forward -> InferenceContext -> PipeInferController in
device-corrected greedy mode, on the nano bench pair (eps = 0.5, about 50%
draft acceptance) and on a tiny random Q4_K llama whose attention matters.

Both packages load with PIPEINFER_WEIGHT_LAYOUT=i4g: off the TPU the JAX
loader would pick k_major, which the port does not have yet. The port on
the CPU runs its kernels' plain versions."""

import functools
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pipeinfer_tpu.models.llama as j_llama
from pipeinfer_tpu.gguf.constants import GGMLQuantType as JQ
from pipeinfer_tpu.models import load_model as j_load
from pipeinfer_tpu.ops.qmatmul import QuantTensor as JQuantTensor
from pipeinfer_tpu.ops.qmatmul import qmatmul as j_qmatmul
from pipeinfer_tpu.runtime import kv_cache as jkv
from pipeinfer_tpu.runtime.context import Batch as JBatch
from pipeinfer_tpu.runtime.context import InferenceContext as JContext
from pipeinfer_tpu.tools import testmodel
from pipeinfer_tpu_torch.models import ModelConfig, load_model, params_from_numpy
from pipeinfer_tpu_torch.models import llama as t_llama
from pipeinfer_tpu_torch.runtime import kv_cache as tkv
from pipeinfer_tpu_torch.runtime.context import Batch, InferenceContext
from pipeinfer_tpu_torch.sampling.samplers import SamplingParams
from pipeinfer_tpu_torch.spec.controller import PipeInferController
from pipeinfer_tpu_torch.spec.params import SpecParams

GREEDY = SamplingParams(temp=0.0, penalty_repeat=1.0, penalty_last_n=0)
PROMPT = list(range(5, 25))
N = 96
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_slice")
    testmodel.build_bench_pair(d / "t.gguf", d / "d.gguf", scale="nano", eps=0.5)
    testmodel.build_tiny_llama(d / "tiny.gguf", seed=3, n_layers=2, n_embd=256, n_heads=4,
                               n_kv_heads=2, n_ff=512, n_vocab=512, qtype=JQ.Q4_K)
    return d


@pytest.fixture(scope="module")
def models(paths):
    """(JAX target, port target, port draft), each (params, cfg)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PIPEINFER_WEIGHT_LAYOUT", "i4g")
        jt = j_load(paths / "t.gguf")
        tt = load_model(paths / "t.gguf", device="cpu")
        td = load_model(paths / "d.gguf", device="cpu")
    return jt, tt, td


def _to_numpy(params):
    """The JAX params with every array as numpy (what params_from_numpy takes)."""
    def conv(x):
        if isinstance(x, JQuantTensor):
            return types.SimpleNamespace(
                **{f: None if getattr(x, f) is None else np.asarray(getattr(x, f))
                   for f in ("qs", "qh", "scales", "bias")},
                qtype=x.qtype, shape=x.shape, layout=x.layout)
        return np.asarray(x)

    out = {k: conv(v) for k, v in params.items() if k != "layers"}
    out["layers"] = [{k: conv(v) for k, v in lp.items()} for lp in params["layers"]]
    return out


def _port_cfg(jcfg):
    return ModelConfig(**{f: getattr(jcfg, f) for f in ModelConfig.__dataclass_fields__})


def _forward_both(jparams, jcfg, steps, monkeypatch):
    """Run the same token steps through both forwards on identical planes:
    the JAX side through its interpret-mode Pallas kernels, the port
    through its plain kernels. Returns [(jax logits, port logits)]."""
    monkeypatch.setattr(j_llama, "qmatmul",
                        functools.partial(j_qmatmul, prefer_pallas=True, interpret=True))
    cfg = _port_cfg(jcfg)
    tparams = params_from_numpy(_to_numpy(jparams), cfg, "cpu")
    n_cells = 64
    jcache = jkv.create(jcfg.n_layers, n_cells, jcfg.n_kv_heads, jcfg.head_dim, jnp.float32)
    tcache = tkv.create(cfg.n_layers, n_cells, cfg.n_kv_heads, cfg.head_dim, torch.float32,
                        device="cpu")
    out, n_past = [], 0
    for toks in steps:
        t = len(toks)
        tok = np.asarray(toks, np.int32)
        pos = np.arange(n_past, n_past + t, dtype=np.int32)
        seq = np.zeros(t, np.int32)
        cells = pos.copy()
        valid = np.ones(t, bool)
        jl, jcache = j_llama.forward(jparams, jcfg, jcache, *map(jnp.asarray,
                                     (tok, pos, seq, cells, valid)))
        tl, _ = t_llama.forward(tparams, cfg, tcache, *map(torch.from_numpy,
                                (tok, pos, seq, cells, valid)))
        out.append((np.asarray(jl), tl.numpy()))
        n_past += t
    return out


def test_prefill_logits_match_on_carried_planes(models, monkeypatch):
    """(a) the target's prefill logits, port vs JAX, atol 1e-4 (logits are
    O(8) here; the i4g dots are exact and the rest is f32 order)."""
    (jparams, jcfg), _, _ = models
    ((jl, tl),) = _forward_both(jparams, jcfg, [PROMPT], monkeypatch)
    np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=0)


def test_decode_steps_match_on_random_q4k_llama(paths, monkeypatch):
    """A random tiny Q4_K llama (attention and FFN both feed the residual,
    unlike the bench pair whose layer outputs are zeroed): prefill plus
    single-token decode steps through the KV cache agree, atol 1e-4."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PIPEINFER_WEIGHT_LAYOUT", "i4g")
        jparams, jcfg = j_load(paths / "tiny.gguf")
    steps = [[1, 17, 200, 33, 5, 9, 71], [44], [300], [2]]
    pairs = _forward_both(jparams, jcfg, steps, monkeypatch)
    for jl, tl in pairs:
        assert np.abs(jl).max() > 0.1  # non-degenerate logits
        np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=0)


def _tctx(m, n_cells=1024):
    return InferenceContext(m[0], m[1], n_cells=n_cells, device="cpu")


def _plain_greedy_port(m, prompt, n):
    ctx = _tctx(m)
    b = Batch()
    for i, t in enumerate(prompt):
        b.add(t, i, 0, want_logits=(i == len(prompt) - 1))
    logits = ctx.decode(b)[-1]
    out, n_past = [], len(prompt)
    for _ in range(n):
        tok = int(np.argmax(logits))
        out.append(tok)
        b.clear()
        b.add(tok, n_past, 0)
        logits = ctx.decode(b)[0]
        n_past += 1
    return out


def _plain_greedy_jax(m, prompt, n):
    ctx = JContext(m[0], m[1], n_cells=1024)
    b = JBatch()
    for i, t in enumerate(prompt):
        b.add(t, i, 0, want_logits=(i == len(prompt) - 1))
    logits = ctx.decode(b)[-1]
    out, n_past = [], len(prompt)
    for _ in range(n):
        tok = int(np.argmax(logits))
        out.append(tok)
        b.clear()
        b.add(tok, n_past, 0)
        logits = ctx.decode(b)[0]
        n_past += 1
    return out


@pytest.fixture(scope="module")
def streams(models):
    jt, tt, _ = models
    return _plain_greedy_jax(jt, PROMPT, N), _plain_greedy_port(tt, PROMPT, N)


def test_port_plain_greedy_equals_jax(streams):
    want_jax, want_port = streams
    assert want_port == want_jax


@pytest.mark.parametrize("device_verify", [True, False], ids=["corrected", "host_verified"])
def test_controller_streams_exact_and_no_leaks(models, streams, device_verify):
    """(b) corrected mode and (c) the host-verified fused path emit the
    plain greedy stream of both packages; (d) no cells leak."""
    _, tt, td = models
    want_jax, want_port = streams
    sp = SpecParams(n_draft=8, n_parallel=1, p_accept=0.0, max_inflight=4, min_inflight=2,
                    device_verify=device_verify)
    tctx, dctx = _tctx(tt), _tctx(td)
    free_t, free_d = tctx.n_free_cells, dctx.n_free_cells
    c = PipeInferController(tctx, dctx, GREEDY, sp, eos_id=-1)
    assert c.use_corrected is device_verify and c.use_fused is not device_verify
    got = c.generate(list(PROMPT), N, ignore_eos=True)
    assert got == want_port == want_jax
    assert 0 < c.stats.n_accept < c.stats.n_drafted  # a divergent draft, exercised
    if device_verify:
        assert c.metrics.n_canceled_runs == 0 and c.metrics.n_dead_tokens == 0
    assert not c.runs and len(c.free_offsets) == sp.max_inflight
    # committed cells = live tokens (the newest token is decided by logits,
    # never decoded); the host mirror agrees with the device truth
    live = len(PROMPT) + len(got)
    assert free_t - live <= tctx.n_free_cells <= free_t - live + 1
    for ctx in (tctx, dctx):
        np.testing.assert_array_equal(ctx.cache.pos.numpy() >= 0, ctx.h_pos >= 0)
        np.testing.assert_array_equal(ctx.cache.seq.numpy().view(np.uint32), ctx.h_seq)
    tctx.seq_rm(0, 0, -1)
    dctx.seq_rm(0, 0, -1)
    assert (tctx.n_free_cells, dctx.n_free_cells) == (free_t, free_d)
    # the same contexts serve a second generation identically
    c2 = PipeInferController(tctx, dctx, GREEDY, sp, eos_id=-1)
    assert c2.generate(list(PROMPT), N, ignore_eos=True) == got


def test_corrected_eos_stops(models, streams):
    _, tt, td = models
    want = streams[1]
    eos = want[20]
    sp = SpecParams(n_draft=8, n_parallel=1, p_accept=0.0, max_inflight=4, min_inflight=2)
    c = PipeInferController(_tctx(tt), _tctx(td), GREEDY, sp, eos_id=eos)
    assert c.generate(list(PROMPT), 64) == want[: want.index(eos) + 1]


def test_corrected_stochastic_seeded_reproducible(models):
    """Under temperature the port draws from a torch.Generator (streams
    differ from the JAX package's PRNG); a seeded generation repeats."""
    _, tt, td = models
    stoch = SamplingParams(temp=0.9, top_k=40, penalty_repeat=1.0, penalty_last_n=0, seed=13)
    sp = SpecParams(n_draft=6, n_parallel=1, p_accept=0.0, max_inflight=3, min_inflight=2)

    def run():
        c = PipeInferController(_tctx(tt), _tctx(td), stoch, sp, eos_id=-1)
        assert c.use_corrected
        return c.generate(list(PROMPT), 40, ignore_eos=True)

    a = run()
    assert a == run() and len(a) == 40


def test_draft_chain_and_precompile(models, streams):
    """The on-device chain decodes the plain greedy stream with its
    candidate packs; precompile's warm-up leaves no cell claimed."""
    _, tt, _ = models
    want = streams[1]
    ctx = _tctx(tt)
    took = ctx.precompile(buckets=(1, 8), topk=16, chain_depths=(2,))
    assert sorted(took) == ["chain[2]", "step[1,topk=16]", "step[8,topk=16]"]
    assert (ctx.cache.pos.numpy() == -1).all() and (ctx.cache.seq.numpy() == 0).all()
    b = Batch()
    for i, t in enumerate(PROMPT):
        b.add(t, i, 0, want_logits=(i == len(PROMPT) - 1))
    (first,) = [int(np.argmax(ctx.decode(b)[-1]))]
    toks, cands = ctx.draft_chain(first, len(PROMPT), 0, 6, n_cand=4)
    assert [first] + toks == want[:7]
    assert [int(c.ids[0]) for c in cands] == toks and all(c.probs()[0] > 0 for c in cands)
    out, root = ctx.draft_chain(toks[-1], len(PROMPT) + 6, 0, 3, n_cand=0, fetch=False)
    assert out.shape == (3, 1) and int(root) == want[9] == int(out[-1, 0])


@pytest.mark.parametrize("n_parallel", [1, 3])
def test_host_drafting_path_exact(models, streams, n_parallel):
    """The host-drafted tree path (no fused or corrected runs: a repetition
    penalty window that is a no-op keeps fused drafting off, and trees
    need n_parallel > 1): batches with multi-seq membership, branch seq
    prep, consolidation and cancellation, still exact under greedy."""
    _, tt, td = models
    want = streams[1]
    sampling = SamplingParams(temp=0.0, penalty_repeat=1.0001, penalty_last_n=1)
    # the penalty divides the last token's logit by 1.0001: far below the
    # pair's margin, so greedy picks the same tokens as without it
    sp = SpecParams(n_draft=4, n_parallel=n_parallel, p_accept=0.0, p_split=0.0,
                    max_inflight=3, min_inflight=2)
    tctx, dctx = _tctx(tt), _tctx(td)
    c = PipeInferController(tctx, dctx, sampling, sp, eos_id=-1)
    assert not c.use_fused and not c.use_corrected
    got = c.generate(list(PROMPT), 48, ignore_eos=True)
    assert got == want[:48]
    assert not c.runs and len(c.free_offsets) == sp.max_inflight
    for ctx in (tctx, dctx):
        np.testing.assert_array_equal(ctx.cache.pos.numpy() >= 0, ctx.h_pos >= 0)
        np.testing.assert_array_equal(ctx.cache.seq.numpy().view(np.uint32), ctx.h_seq)
