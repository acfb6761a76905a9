"""The sampled path's statistics on the CPU (pipeinfer_tpu_torch/tools/
sample_check.py), against the JAX package where it samples too.

- The exact distributions: both packages' `top_probs` agree within 1e-6.
- The device samplers: the port's `_device_draft_sample` and the JAX
  package's (`pipeinfer_tpu/runtime/context.py`, vmapped over PRNG keys)
  pass a chi-square against top_probs (p >= 1e-3, no draw outside the
  chain's kept set) on one row and on 8 rows, and each of
  sample_check.SAMPLER_FAULTS fails it on the 8 rows.
- The engines: plain sequential sampling, the corrected controller, the
  DeviceLoopEngine and the BatchedDeviceLoop's lanes at temp 0.8 pass the
  randomized PIT / KS test (D <= 1.95 / sqrt(n), n = 768 each) against a
  teacher-forced pass, with the chain's mean entropy reported and at least
  1 bit; the target sampled at temp 1.0 through each fails it.

The model is a tiny f32 llama (n_vocab 256) whose output norm is scaled by
LOGIT_SCALE: at the unscaled weights' nearly flat top 40 the temperature
moves the chain's distribution too little for the KS test to see the
temp-1.0 fault at this n.
"""

import functools

import numpy as np
import pytest
import scipy.stats
import torch

import jax
import jax.numpy as jnp

from pipeinfer_tpu.runtime.context import _device_draft_sample as j_draft_sample
from pipeinfer_tpu.sampling import samplers as j_samplers
from pipeinfer_tpu_torch.models import load_model
from pipeinfer_tpu_torch.runtime.context import InferenceContext, _device_draft_sample
from pipeinfer_tpu_torch.sampling import samplers as t_samplers
from pipeinfer_tpu_torch.spec.controller import PipeInferController
from pipeinfer_tpu_torch.spec.device_loop import DeviceLoopEngine
from pipeinfer_tpu_torch.spec.device_multi import BatchedDeviceLoop
from pipeinfer_tpu_torch.spec.params import SpecParams
from pipeinfer_tpu_torch.tools import sample_check as SC
from pipeinfer_tpu_torch.tools import testmodel

torch.set_num_threads(1)  # several test processes share the machine (test_torch_cli.py)

CFG = dict(n_layers=2, n_embd=64, n_heads=4, n_kv_heads=2, n_ff=128, n_vocab=256)
LOGIT_SCALE = 3.0  # logits std about 1.5 instead of 0.5
PROMPTS = [[3, 17, 42, 7], [5, 9, 2], [11, 30, 7, 2, 8], [1, 2, 3]]
N = 96  # tokens per run: 8 runs (2 x 4 lanes) make n = 768
DRAWS = 65536


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    path = tmp_path_factory.mktemp("torch_sampling") / "t.gguf"
    w = testmodel.random_llama_weights(np.random.default_rng(11), **CFG)
    w["output_norm"] = w["output_norm"] * LOGIT_SCALE
    testmodel.build_tiny_llama(path, weights=w, **CFG)
    return load_model(path, device="cpu")


def _ctx(model):
    return InferenceContext(*model, n_cells=1024, cache_dtype=torch.float32, device="cpu")


@pytest.fixture(scope="module")
def rows(model):
    """8 logits rows [8, 256]: the prompt's last 8 positions."""
    toks = np.random.default_rng(3).integers(3, CFG["n_vocab"], 16).tolist()
    return torch.from_numpy(SC.teacher_rows(_ctx(model), [(toks[:8], toks[8:])])[0])


def test_top_probs_agree_with_jax(rows):
    """The exact distributions (full rows and sparse heads, with and
    without penalties) agree within 1e-6."""
    rng = np.random.default_rng(0)
    chains = [dict(temp=0.8, top_k=40, top_p=0.95, min_p=0.05, penalty_last_n=0),
              dict(temp=1.3, top_k=0, top_p=0.5, min_p=0.0, penalty_last_n=0),
              dict(temp=0.8, top_k=40, top_p=0.95, min_p=0.05, penalty_repeat=1.1)]
    for row in rows.numpy():
        ids = np.argsort(-row)[:128].astype(np.int32)
        lse = float(np.log(np.exp(row.astype(np.float64)).sum()))
        for kw in chains:
            prev = rng.integers(0, CFG["n_vocab"], 20).tolist()
            for logits in (row, t_samplers.SparseLogits(ids, row[ids], lse)):
                got = t_samplers.top_probs(t_samplers.SamplerState(
                    params=t_samplers.SamplingParams(**kw), prev=list(prev)), logits, 40)
                jl = logits if isinstance(logits, np.ndarray) else \
                    j_samplers.SparseLogits(ids, row[ids], lse)
                want = j_samplers.top_probs(j_samplers.SamplerState(
                    params=j_samplers.SamplingParams(**kw), prev=list(prev)), jl, 40)
                assert [i for i, _ in got] == [i for i, _ in want]
                np.testing.assert_allclose([p for _, p in got], [p for _, p in want],
                                           atol=1e-6, rtol=0)


def test_chi2_sf_matches_scipy():
    for stat, dof in [(0.5, 1), (3.0, 2), (40.0, 37), (300.0, 233), (12.0, 29), (80.0, 20),
                      (1e-3, 5), (5000.0, 300)]:
        assert SC.chi2_sf(stat, dof) == pytest.approx(scipy.stats.chi2.sf(stat, dof),
                                                      rel=1e-9, abs=1e-300)


def test_merged_cells_reach_the_minimum():
    expected = np.array([3000.0, 400.0, 6.0, 4.9, 2.0, 1.0, 0.5, 0.2, 0.1])
    groups = SC.merged_cells(expected)
    assert sorted(np.concatenate(groups).tolist()) == list(range(len(expected)))
    assert all(expected[g].sum() >= SC.MIN_EXPECTED for g in groups)
    assert [len(g) for g in groups] == [1, 1, 1, 6]  # the last pool (1.8) joins the one before
    res = SC.chi_square(np.array([10, 20, 30]), np.array([0.2, 0.3, 0.5]))
    assert res["dof"] == 2 and res["stat"] == pytest.approx(
        scipy.stats.chisquare([10, 20, 30], [12, 18, 30]).statistic)


@functools.lru_cache(maxsize=None)
def _jax_sampler_fn(samp: tuple):
    return jax.jit(jax.vmap(lambda k, r: j_draft_sample(r, samp, k)))


def _jax_sampler(rows_t: torch.Tensor, samp: tuple, gen) -> torch.Tensor:
    """The JAX package's device sampler over rows [n, V], one PRNG key a
    row (keys split from the torch generator's first draw)."""
    seed = int(torch.randint(0, 2**31 - 1, (1,), generator=gen))
    keys = jax.random.split(jax.random.PRNGKey(seed), rows_t.shape[0])
    out = _jax_sampler_fn(tuple(samp))(keys, jnp.asarray(rows_t.numpy()))
    return torch.from_numpy(np.array(out))


@pytest.mark.parametrize("n_rows", [1, 8], ids=["one_row", "8_rows"])
@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_device_sampler_chi_square(rows, pkg, n_rows):
    """65536 draws over one row or 8 rows (8192 each) against top_probs:
    p >= 1e-3 and nothing outside the kept set."""
    sampler = _device_draft_sample if pkg == "port" else _jax_sampler
    res = SC.sampler_check(sampler, rows[-n_rows:], DRAWS, SC.CHAIN, seed=7)
    assert res["outside"] == 0, res
    assert res["p"] >= SC.CHI2_MIN_P, res
    assert res["rows"] == n_rows and res["n"] == DRAWS


@pytest.mark.parametrize("fault", SC.SAMPLER_FAULTS)
def test_sampler_faults_fail_the_chi_square(rows, fault):
    res = SC.sampler_check(SC.sampler_fault(fault), rows, DRAWS, SC.CHAIN, seed=7)
    assert res["p"] < SC.CHI2_MIN_P, res


def _plain(model, sampling, n):
    """Plain sequential sampling: one host draw and one single-token step a
    position."""
    from pipeinfer_tpu_torch.runtime.context import Batch

    st, ctx, b = t_samplers.SamplerState(params=sampling), _ctx(model), Batch()
    for i, t in enumerate(PROMPTS[0]):
        b.add(t, i, 0)
    logits, out = ctx.decode(b)[-1], []
    for pos in range(len(PROMPTS[0]), len(PROMPTS[0]) + n):
        out.append(t_samplers.sample(st, logits))
        b = Batch()
        b.add(out[-1], pos, 0)
        logits = ctx.decode(b)[0]
    return [(PROMPTS[0], out)]


SP = SpecParams(n_draft=2, n_parallel=1, p_accept=0.0, max_inflight=3)


def _corrected(model, sampling, n):
    c = PipeInferController(_ctx(model), _ctx(model), sampling, SP, eos_id=-1)
    assert c.use_corrected
    return [(PROMPTS[0], c.generate(list(PROMPTS[0]), n, ignore_eos=True))]


def _device_loop(model, sampling, n):
    e = DeviceLoopEngine(_ctx(model), _ctx(model), sampling, SP, eos_id=-1, rounds=4)
    return [(PROMPTS[0], e.generate(list(PROMPTS[0]), n, ignore_eos=True))]


def _batched(model, sampling, n):
    e = BatchedDeviceLoop(_ctx(model), _ctx(model), sampling, SP, n_streams=4, eos_id=-1,
                          rounds=4)
    return list(zip(PROMPTS, e.generate_many(PROMPTS, n, ignore_eos=True)))


ENGINES = {"plain": (_plain, 8), "corrected": (_corrected, 8),
           "device_loop": (_device_loop, 8), "batched": (_batched, 2)}


def _pit_check(model, engine: str, fault: bool) -> tuple[dict, dict]:
    """(pooled KS result, per-lane results) of the engine's runs."""
    fn, n_seeds = ENGINES[engine]
    rng = np.random.default_rng(5)
    lanes: dict = {}
    for seed in range(n_seeds):
        sampling = SC.chain_params(seed=100 + seed)
        if fault:
            with SC.target_temp_fault():
                runs = fn(model, sampling, N)
        else:
            runs = fn(model, sampling, N)
        for lane, ((prompt, stream), rows) in enumerate(zip(runs, SC.teacher_rows(
                _ctx(model), runs))):
            assert len(stream) == N
            lanes.setdefault(lane, []).append(SC.pit(stream, rows, SC.CHAIN, rng))
    pooled = SC.ks_check([p for ps in lanes.values() for p in ps])
    return pooled, {k: SC.ks_check(v) for k, v in lanes.items()}


@pytest.mark.parametrize("engine", list(ENGINES))
def test_engine_streams_pass_the_pit(model, engine):
    """Each engine's 768 tokens at temp 0.8 (the BatchedDeviceLoop's 4
    lanes each 192, pooled and each on its own bar) are the target chain's
    samples: KS D within the bar, the mean entropy at least 1 bit."""
    res, lanes = _pit_check(model, engine, fault=False)
    assert res["n"] == 768
    assert res["entropy_bits"] >= SC.MIN_ENTROPY_BITS, res
    assert res["ok"], res
    assert all(v["ok"] for v in lanes.values()), lanes


@pytest.mark.parametrize("engine", ["corrected", "device_loop", "batched"])
def test_target_sampled_at_temp_1_fails_the_pit(model, engine):
    res, _ = _pit_check(model, engine, fault=True)
    assert not res["passes_ks"], res


def test_part_report_explains_a_shifted_boundary():
    """Two draws from one rng state over two-token rows whose CDF boundary
    sits just above and just below the draw's uniform u: the report finds
    the tokens apart, at distance 0.01 with a shift of 0.02 (explained);
    the same row twice is not."""
    st = t_samplers.SamplerState(params=SC.chain_params(seed=0))
    rng = np.random.default_rng(0)
    rng.bit_generator.state = st.rng.bit_generator.state
    u = float(rng.random())

    def row(p_first):  # the chain's tempered p of token 0 is p_first
        logit = np.log(p_first / (1 - p_first)) * SC.CHAIN[0]
        return np.array([logit, 0.0] + [-30.0] * 6, np.float32)

    above, below = [(st.copy(), row(u + 0.01))], [(st.copy(), row(u - 0.01))]
    rep = SC.part_report(above, below, 0)
    assert (rep["token_a"], rep["token_b"]) == (0, 1) and rep["explained"], rep
    assert rep["u"] == u
    assert rep["distance"] == pytest.approx(0.01, abs=1e-5)
    assert rep["shift"] == pytest.approx(0.02, abs=1e-5)
    same = SC.part_report(above, [(st.copy(), row(u + 0.01))], 0)
    assert same["token_a"] == same["token_b"] and not same["explained"]
