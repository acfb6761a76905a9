"""Golden-token equivalence of the port's SyncSpeculator (tests/
test_sync_spec.py's four tests, their configs and seeds) and acceptance
parity with the JAX package.

Each model is written once by the port's tools/testmodel and loaded by
both packages: the port's speculative stream must equal the port's plain
decoding and the JAX package's plain decoding of the same file. The
acceptance counts of SyncSpeculator (lock-step, so its order is fixed)
equal the JAX package's; the async controller's equal them in corrected
mode, whose launches do not wait on readiness, and on its host-verified
path (whose pump asks whether the oldest run is ready: JAX's CPU dispatch
answers by timing, the port's CPU steps are done when they return) its
acceptance rate stays within ACCEPT_RATE_TOL of the JAX package's.

The helpers here serve the other mirrored files as tests/test_sync_spec.py
serves theirs.
"""

import dataclasses

import pytest
import torch

import jax.numpy as jnp

from pipeinfer_tpu.models import load_model as j_load
from pipeinfer_tpu.runtime.context import Batch as JBatch
from pipeinfer_tpu.runtime.context import InferenceContext as JContext
from pipeinfer_tpu.sampling import samplers as j_samplers
from pipeinfer_tpu.spec.controller import PipeInferController as JController
from pipeinfer_tpu.spec.params import SpecParams as JSpec
from pipeinfer_tpu.spec.sync_spec import SyncSpeculator as JSync
from pipeinfer_tpu_torch.models import load_model
from pipeinfer_tpu_torch.runtime.context import Batch, InferenceContext
from pipeinfer_tpu_torch.sampling import samplers as t_samplers
from pipeinfer_tpu_torch.sampling.samplers import SamplingParams
from pipeinfer_tpu_torch.spec.controller import PipeInferController
from pipeinfer_tpu_torch.spec.params import SpecParams
from pipeinfer_tpu_torch.spec.sync_spec import SyncSpeculator
from pipeinfer_tpu_torch.tools import testmodel

torch.set_num_threads(1)  # several test processes share the machine (test_torch_cli.py)

CFG = dict(n_layers=2, n_embd=128, n_heads=4, n_kv_heads=2, n_ff=256, n_vocab=160)
PROMPT = [3, 17, 42, 7]
N_PREDICT = 24
ACCEPT_RATE_TOL = 0.15  # the host-verified controller's acceptance rate, port vs JAX


@dataclasses.dataclass
class Model:
    """One GGUF file loaded by both packages, each as (params, cfg)."""

    path: str
    port: tuple
    jax: tuple


def build(path, *, seed: int, **cfg) -> Model:
    testmodel.build_tiny_llama(path, seed=seed, **cfg)
    return Model(str(path), load_model(path, device="cpu"), j_load(path))


def tctx(m: Model, n_cells: int = 128) -> InferenceContext:
    return InferenceContext(*m.port, n_cells=n_cells, cache_dtype=torch.float32, device="cpu")


def jctx(m: Model, n_cells: int = 128):
    return JContext(*m.jax, n_cells=n_cells, cache_dtype=jnp.float32)


def decode(ctx, pkg: str, prompt, n_predict, sampling_kw, accept_prompt: bool = False):
    """Plain decoding on seq 0 of `ctx` with package `pkg`'s sampler
    ("port" or "jax"): one draw and one single-token step a position;
    accept_prompt puts the prompt in the penalty window first."""
    samplers, batch = (t_samplers, Batch) if pkg == "port" else (j_samplers, JBatch)
    st = samplers.SamplerState(params=samplers.SamplingParams(**sampling_kw))
    b = batch()
    for i, t in enumerate(prompt):
        if accept_prompt:
            st.accept(t, apply_grammar=False)
        b.add(t, i, 0, want_logits=(i == len(prompt) - 1))
    logits = ctx.decode(b)[-1]
    out, n_past = [], len(prompt)
    for _ in range(n_predict):
        tok = samplers.sample(st, logits)
        st.accept(tok)
        out.append(tok)
        b.clear()
        b.add(tok, n_past, 0)
        logits = ctx.decode(b)[0]
        n_past += 1
    return out


def plain_both(m: Model, prompt=PROMPT, n_predict=N_PREDICT, sampling_kw=None,
               accept_prompt=False, n_cells=128):
    """The port's plain stream, checked equal to the JAX package's."""
    kw = dict(temp=0.0) if sampling_kw is None else sampling_kw
    got = decode(tctx(m, n_cells), "port", prompt, n_predict, kw, accept_prompt)
    assert got == decode(jctx(m, n_cells), "jax", prompt, n_predict, kw, accept_prompt)
    return got


@pytest.fixture(scope="module")
def target(tmp_path_factory):
    return build(tmp_path_factory.mktemp("tspec") / "tgt.gguf", seed=7, **CFG)


@pytest.fixture(scope="module")
def bad(tmp_path_factory):
    return build(tmp_path_factory.mktemp("tspec_bad") / "bad_draft.gguf", seed=999, **CFG)


@pytest.fixture(scope="module")
def want(target):
    return plain_both(target)


def _sync_spec(target_model, draft_model, sp=None):
    ctx_t, ctx_d = tctx(target_model), tctx(draft_model)
    # random tiny models have flat distributions; p_accept=0 keeps drafting on
    spec = SyncSpeculator(ctx_t, ctx_d, SamplingParams(temp=0.0),
                          sp or SpecParams(n_draft=5, n_parallel=3, p_accept=0.0), eos_id=-1)
    out = spec.generate(list(PROMPT), N_PREDICT)
    return out, spec.stats


def test_self_draft_equivalence_and_acceptance(target, want):
    got, stats = _sync_spec(target, target)
    assert got == want, f"spec tokens diverge: {got} vs {want}"
    assert stats.n_drafted > 0
    assert stats.n_predict <= stats.n_accept + stats.n_rounds + 2, stats
    assert stats.accept_rate > 0.6, f"self-draft acceptance {stats.accept_rate}"


def test_bad_draft_still_exact(target, bad, want):
    got, stats = _sync_spec(target, bad)
    assert got == want, f"spec tokens diverge with bad draft: {got} vs {want}"
    assert stats.accept_rate < 0.9


def test_narrow_tree(target, want):
    got, _ = _sync_spec(target, target, SpecParams(n_draft=3, n_parallel=1, p_accept=0.0))
    assert got == want


def test_deep_tree_with_splits(target, want):
    got, _ = _sync_spec(target, target,
                        SpecParams(n_draft=8, n_parallel=4, p_accept=0.0, p_split=0.1))
    assert got == want


SYNC_CONFIGS = {"default": dict(n_draft=5, n_parallel=3, p_accept=0.0),
                "narrow": dict(n_draft=3, n_parallel=1, p_accept=0.0),
                "deep_splits": dict(n_draft=8, n_parallel=4, p_accept=0.0, p_split=0.1),
                "gated": dict(n_draft=5, n_parallel=2, p_accept=0.3)}


@pytest.mark.parametrize("draft", ["self", "bad"])
@pytest.mark.parametrize("config", list(SYNC_CONFIGS))
def test_sync_acceptance_counts_equal_jax(target, bad, draft, config):
    """Greedy, the same tiny pair: n_drafted, n_accept and the rounds of
    the port's SyncSpeculator are the JAX package's."""
    d = target if draft == "self" else bad
    kw = SYNC_CONFIGS[config]
    t = SyncSpeculator(tctx(target), tctx(d), SamplingParams(temp=0.0), SpecParams(**kw),
                       eos_id=-1)
    j = JSync(jctx(target), jctx(d), j_samplers.SamplingParams(temp=0.0), JSpec(**kw), eos_id=-1)
    assert t.generate(list(PROMPT), N_PREDICT) == j.generate(list(PROMPT), N_PREDICT)
    ts, js = t.stats, j.stats
    assert (ts.n_drafted, ts.n_accept, ts.n_rounds, ts.n_predict) == \
        (js.n_drafted, js.n_accept, js.n_rounds, js.n_predict)


@pytest.mark.parametrize("mode", ["corrected", "host_verified"])
def test_async_acceptance_counts_against_jax(tmp_path_factory, mode):
    """The async controller on the nano bench pair (eps 0.5: about half
    the drafts rejected), greedy: in corrected mode n_drafted and n_accept
    equal the JAX package's; host-verified, the acceptance rates differ by
    at most ACCEPT_RATE_TOL (the tick order there depends on readiness)."""
    d = tmp_path_factory.mktemp("tspec_pair")
    testmodel.build_bench_pair(d / "t.gguf", d / "d.gguf", scale="nano", eps=0.5)
    tgt = Model(str(d / "t.gguf"), load_model(d / "t.gguf", device="cpu"), j_load(d / "t.gguf"))
    dft = Model(str(d / "d.gguf"), load_model(d / "d.gguf", device="cpu"), j_load(d / "d.gguf"))
    greedy = dict(temp=0.0, penalty_repeat=1.0, penalty_last_n=0)
    kw = dict(n_draft=4, n_parallel=1, p_accept=0.0, max_inflight=4, min_inflight=2,
              adapt_depth=False, device_verify=mode == "corrected")
    prompt, n = list(range(5, 25)), 48
    t = PipeInferController(tctx(tgt, 1024), tctx(dft, 1024), SamplingParams(**greedy),
                            SpecParams(**kw), eos_id=-1)
    j = JController(jctx(tgt, 1024), jctx(dft, 1024), j_samplers.SamplingParams(**greedy),
                    JSpec(**kw), eos_id=-1)
    assert t.use_corrected == j.use_corrected == (mode == "corrected")
    got = t.generate(list(prompt), n, ignore_eos=True)
    assert got == j.generate(list(prompt), n, ignore_eos=True)
    assert got == plain_both(tgt, prompt, n, n_cells=1024)
    ts, js = t.stats, j.stats
    if mode == "corrected":
        assert (ts.n_drafted, ts.n_accept) == (js.n_drafted, js.n_accept)
    else:
        assert abs(ts.accept_rate - js.accept_rate) <= ACCEPT_RATE_TOL, (ts, js)
    assert 0 < ts.n_accept < ts.n_drafted, ts
