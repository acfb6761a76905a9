"""The port's staged pipeline (parallel/stages.py) on the CPU, mirroring the
JAX package's tests/test_stages.py without its tensor-parallel tests:
staged decode equals a single context at 2 and 4 stages, the port's staged
logits equal the JAX package's StagedInferenceContext on one CPU device,
the PipeInfer controller over a staged target emits plain greedy decoding's
stream (drafting with one chain dispatch per run), the seq-op surface keeps
the stages equal to a single context, a generic architecture runs staged,
and 2 stages x 2-way TP decode as one device does (tests/test_torch_tp.py
holds TP stages to the JAX package's). Stages share one device here,
as they do on one card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pipeinfer_tpu.models import load_model as j_load
from pipeinfer_tpu.parallel.stages import StagedInferenceContext as JStaged
from pipeinfer_tpu.runtime.context import Batch as JBatch
from pipeinfer_tpu_torch.models import load_model
from pipeinfer_tpu_torch.parallel.stages import StagedInferenceContext, split_ranges
from pipeinfer_tpu_torch.runtime.context import Batch, InferenceContext
from pipeinfer_tpu_torch.sampling.samplers import SamplerState, SamplingParams, sample
from pipeinfer_tpu_torch.spec.controller import PipeInferController
from pipeinfer_tpu_torch.spec.params import SpecParams
from pipeinfer_tpu_torch.tools import testmodel

torch.set_num_threads(1)  # several test processes share the machine

# tests/test_sync_spec.py's model and prompt
CFG = dict(n_layers=2, n_embd=128, n_heads=4, n_kv_heads=2, n_ff=256, n_vocab=160)
PROMPT = [3, 17, 42, 7]
N_PREDICT = 24
F32 = torch.float32
TOL = dict(rtol=2e-4, atol=2e-4)  # test_stages.py's bar: f32 steps, summation order


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_stages")
    testmodel.build_tiny_llama(d / "m.gguf", seed=7, **CFG)
    testmodel.build_tiny_llama(d / "m4.gguf", seed=7, **dict(CFG, n_layers=4))
    return d


@pytest.fixture(scope="module")
def model(paths):
    return load_model(paths / "m.gguf", device="cpu")


@pytest.fixture(scope="module")
def model4(paths):
    return load_model(paths / "m4.gguf", device="cpu")


def _staged(m, n_stages, n_cells, **kw):
    return StagedInferenceContext(*m, n_cells=n_cells, devices=["cpu"] * n_stages,
                                  cache_dtype=F32, **kw)


def _single(m, n_cells):
    return InferenceContext(*m, n_cells=n_cells, cache_dtype=F32, device="cpu")


def _prompt_batch(batch=Batch, all_logits=True):
    b = batch()
    for i, t in enumerate(PROMPT):
        b.add(t, i, 0, want_logits=all_logits or i == len(PROMPT) - 1)
    return b


def _plain(m, sp_params, n=N_PREDICT):
    ctx = _single(m, 256)
    st = SamplerState(params=sp_params)
    for t in PROMPT:
        st.accept(t, apply_grammar=False)
    logits = ctx.decode(_prompt_batch(all_logits=False))[-1]
    out, n_past = [], len(PROMPT)
    b = Batch()
    for _ in range(n):
        tok = sample(st, logits)
        st.accept(tok)
        out.append(tok)
        b.clear()
        b.add(tok, n_past, 0)
        logits = ctx.decode(b)[0]
        n_past += 1
    return out


def test_split_ranges():
    assert split_ranges(8, [0.5, 0.5]) == [(0, 4), (4, 8)]
    assert split_ranges(8, [0.25, 0.75]) == [(0, 2), (2, 8)]
    r = split_ranges(10, [0.2, 0.4, 0.4])
    assert [hi - lo for lo, hi in r] == [2, 4, 4]
    assert split_ranges(32, [0.5, 0.5]) == [(0, 16), (16, 32)]
    assert [hi - lo for lo, hi in split_ranges(32, [1, 1, 1, 1])] == [8, 8, 8, 8]


@pytest.mark.parametrize("n_stages", [2, 4])
def test_staged_decode_matches_single(model4, n_stages):
    single, stagedc = _single(model4, 64), _staged(model4, n_stages, 64)
    assert stagedc.ranges == split_ranges(4, [1.0] * n_stages)
    want = single.decode(_prompt_batch())
    got = stagedc.decode(_prompt_batch())
    np.testing.assert_allclose(got, want, **TOL)
    b = Batch()
    b.add(42, len(PROMPT), 0)
    np.testing.assert_allclose(stagedc.decode(b), single.decode(b.copy()), **TOL)
    assert [c.n_layers for c in stagedc.caches] == [4 // n_stages] * n_stages


@pytest.mark.parametrize("split", [[0.5, 0.5], [0.25, 0.75]])
def test_staged_logits_match_jax_staged(paths, split):
    """The port's StagedInferenceContext against the JAX package's on one
    CPU device (both stages there), prefill then a decode step; the
    sparse head (topk) agrees too."""
    jm = j_load(paths / "m4.gguf")
    tm = load_model(paths / "m4.gguf", device="cpu")
    jc = JStaged(*jm, n_cells=64, devices=[jax.devices()[0]] * 2, split=split,
                 cache_dtype=jnp.float32)
    tc = _staged(tm, 2, 64, split=split)
    assert tc.ranges == jc.ranges
    np.testing.assert_allclose(tc.decode(_prompt_batch()), jc.decode(_prompt_batch(JBatch)),
                               **TOL)
    jb, tb = JBatch(), Batch()
    jb.add(42, len(PROMPT), 0)
    tb.add(42, len(PROMPT), 0)
    (js,), (ts,) = jc.decode(jb, topk=8), tc.decode(tb, topk=8)
    assert ts.ids.tolist() == js.ids.tolist()
    np.testing.assert_allclose(ts.vals, js.vals, **TOL)
    np.testing.assert_allclose(ts.lse, js.lse, **TOL)


def test_pipeinfer_over_staged_pipeline(model):
    """The async controller drives a 2-stage target and a single-context
    draft, the full PipeInfer topology, token-exact."""
    want = _plain(model, SamplingParams(temp=0.0))
    c = PipeInferController(
        _staged(model, 2, 256), _single(model, 256), SamplingParams(temp=0.0),
        SpecParams(n_draft=4, n_parallel=1, p_accept=0.0, max_inflight=3), eos_id=-1)
    got = c.generate(list(PROMPT), N_PREDICT)
    assert got == want, f"staged pipeline diverges: {got} vs {want}"
    assert c.stats.n_accept > 0


def test_pipeinfer_staged_fused_eligible_sampling(model):
    """Greedy sampling without penalties is fused-eligible, but a staged
    target is not one context: the controller keeps the host drafting
    path (neither fused nor corrected) and stays exact."""
    sp = SamplingParams(temp=0.0, penalty_repeat=1.0, penalty_last_n=0)
    want = _plain(model, sp)
    c = PipeInferController(
        _staged(model, 2, 256), _single(model, 256), sp,
        SpecParams(n_draft=4, n_parallel=1, p_accept=0.0, max_inflight=3), eos_id=-1)
    assert not c.use_fused and not c.use_corrected
    assert c.generate(list(PROMPT), N_PREDICT) == want


def test_controller_trees_over_four_stages(model4):
    """Tree drafting (-np 2) over a 4-stage target: branch seqs are
    prepared and consolidated on every stage; token-exact."""
    sp = SamplingParams(temp=0.0)
    want = _plain(model4, sp, 16)
    c = PipeInferController(
        _staged(model4, 4, 256), _single(model4, 256), sp,
        SpecParams(n_draft=4, n_parallel=2, p_accept=0.0, max_inflight=3), eos_id=-1)
    got = c.generate(list(PROMPT), 16)
    assert got == want, f"{got} vs {want}"
    assert c.stats.n_accept > 0


def test_weighted_split(model):
    stagedc = _staged(model, 2, 32, split=[0.25, 0.75])
    assert stagedc.ranges == [(0, 1), (1, 2)]
    b = Batch()
    b.add(3, 0, 0)
    assert np.isfinite(stagedc.decode(b)).all()


def test_staged_generic_arch_falcon(tmp_path):
    """A non-llama architecture runs the staged pipeline too: falcon (MQA,
    parallel residual, neox rope) through the shared trait layer body."""
    path = testmodel.build_tiny_arch(tmp_path / "falcon4.gguf", "falcon", seed=31, n_layers=4,
                                     n_kv_heads=1, n_vocab=160)
    m = load_model(path, device="cpu")
    want = _single(m, 64).decode(_prompt_batch())
    got = _staged(m, 2, 64).decode(_prompt_batch())
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("arch", ["stablelm", "mpt"])
def test_staged_seq_shift_keep_rmtail(model4, tmp_path, arch):
    """The seq-op surface on staged targets (context sliding and lookahead
    need seq_shift, rm_tail and seq_keep): each op leaves the staged
    pipeline equal to a single context applying the same op. StableLM
    re-rotates a partial rope width on every stage's slab; MPT (ALiBi)
    shifts positions only."""
    path = testmodel.build_tiny_arch(tmp_path / f"{arch}.gguf", arch, seed=23, n_layers=4,
                                     n_vocab=160)
    m = load_model(path, device="cpu")
    single, stagedc = _single(m, 64), _staged(m, 2, 64)
    for c in (single, stagedc):
        c.decode(_prompt_batch(all_logits=False))
        c.seq_cp(0, 3, 0, 2)  # a scratch branch to exercise keep
    for c in (single, stagedc):  # context sliding: drop pos 0, shift the rest down
        c.seq_keep(0)
        c.seq_rm(0, 0, 1)
        c.seq_shift(0, 1, len(PROMPT), -1)
    np.testing.assert_array_equal(stagedc.h_pos, single.h_pos)
    for sc in stagedc.caches:
        assert torch.equal(sc.pos, single.cache.pos) and torch.equal(sc.seq, single.cache.seq)
    b = Batch()
    b.add(42, len(PROMPT) - 1, 0)
    np.testing.assert_allclose(stagedc.decode(b), single.decode(b.copy()), **TOL)
    for c in (single, stagedc):  # rollback and re-decode at the freed position
        c.rm_tail(len(PROMPT) - 1)
    b = Batch()
    b.add(7, len(PROMPT) - 1, 0)
    np.testing.assert_allclose(stagedc.decode(b), single.decode(b.copy()), **TOL)
    for c in (single, stagedc):
        c.clear_cache()
    assert all(int(sc.pos.max()) == -1 for sc in stagedc.caches) and (stagedc.h_pos < 0).all()


def _count_draft_dispatches(dft):
    counts = {"chain": 0, "decode": 0}
    orig_chain, orig_decode = dft.draft_chain, dft.decode_async

    def chain(*a, **kw):
        counts["chain"] += 1
        return orig_chain(*a, **kw)

    def decode_async(*a, **kw):
        counts["decode"] += 1
        return orig_decode(*a, **kw)

    dft.draft_chain = chain
    dft.decode_async = decode_async
    return counts


def test_staged_target_one_dispatch_drafting(model):
    """A staged-target speculative run drafts through draft_chain, one
    dispatch per run, not one draft decode per depth; token-exact."""
    want = _plain(model, SamplingParams(temp=0.0))
    dft = _single(model, 256)
    counts = _count_draft_dispatches(dft)
    c = PipeInferController(
        _staged(model, 2, 256), dft, SamplingParams(temp=0.0),
        SpecParams(n_draft=6, n_parallel=1, p_accept=0.0, max_inflight=3), eos_id=-1)
    assert c.generate(list(PROMPT), N_PREDICT) == want
    assert counts["decode"] <= 2, counts  # the prefill (+1 for a root re-decode)
    assert counts["chain"] >= 1
    assert counts["chain"] + counts["decode"] <= 2 * c.metrics.n_runs, counts


def test_staged_target_stochastic_one_dispatch(model):
    """temp > 0 with a stateless sampler chain drafts on the device through
    draft_chain for staged targets too; verification samples the target on
    the host with one draw per committed token, so the stream equals plain
    sampled decoding with the same seed."""
    stoch = SamplingParams(temp=0.8, penalty_repeat=1.0, penalty_last_n=0, seed=11)
    want = _plain(model, stoch)
    dft = _single(model, 256)
    counts = _count_draft_dispatches(dft)
    c = PipeInferController(
        _staged(model, 2, 256), dft, stoch,
        SpecParams(n_draft=4, n_parallel=1, p_accept=0.0, max_inflight=3), eos_id=-1)
    assert not c.use_fused
    assert c.generate(list(PROMPT), N_PREDICT) == want
    assert counts["chain"] >= 1 and counts["decode"] <= 2, counts


def test_precompile_leaves_the_pipeline_clean(model):
    stagedc = _staged(model, 2, 64)
    took = stagedc.precompile(buckets=(1, 8), topk=8)
    assert len(took) == 2 and (stagedc.h_pos < 0).all()
    assert all(int((c.pos >= 0).sum()) == 0 for c in stagedc.caches)
    np.testing.assert_allclose(stagedc.decode(_prompt_batch()),
                               _single(model, 64).decode(_prompt_batch()), **TOL)


def test_tensor_parallel_stages_decode_as_one_device(model):
    """tp=2 groups four devices into 2 stages of 2 shards, each stage's
    heads and cache split over its shards: the prompt's and the next
    steps' logits equal a single context's."""
    stagedc = _staged(model, 4, 64, tp=2)
    single = _single(model, 64)
    assert stagedc.n_stages == 2 and len(stagedc.caches) == 4
    np.testing.assert_allclose(stagedc.decode(_prompt_batch()), single.decode(_prompt_batch()),
                               **TOL)
    for i, t in enumerate([5, 9]):
        b = Batch()
        b.add(t, len(PROMPT) + i, 0)
        np.testing.assert_allclose(stagedc.decode(b), single.decode(b), **TOL)
