"""The port's lookahead decoding (spec/lookahead.py) on the CPU, mirroring
the JAX package's tests/test_lookahead.py: the greedy stream equals plain
decoding (every accepted token is sampled from true target logits), and
the stream and the n-gram acceptance `n_accept` equal the JAX package's
LookaheadDecoder on the same model, on a single context and on 2- and
4-stage pipelines."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pipeinfer_tpu.models import load_model as j_load
from pipeinfer_tpu.runtime.context import InferenceContext as JContext
from pipeinfer_tpu.sampling.samplers import SamplingParams as JSamplingParams
from pipeinfer_tpu.spec.lookahead import LookaheadDecoder as JLookahead
from pipeinfer_tpu_torch.models import load_model
from pipeinfer_tpu_torch.parallel.stages import StagedInferenceContext
from pipeinfer_tpu_torch.runtime.context import Batch, InferenceContext
from pipeinfer_tpu_torch.sampling.samplers import SamplerState, SamplingParams, sample
from pipeinfer_tpu_torch.spec.lookahead import LookaheadDecoder
from pipeinfer_tpu_torch.tools import testmodel

torch.set_num_threads(1)  # several test processes share the machine

CFG = dict(n_layers=2, n_embd=128, n_heads=4, n_kv_heads=2, n_ff=256, n_vocab=160)
PROMPT = [3, 17, 42, 7]
N_PREDICT = 24
CYCLIC = [3, 17, 42, 3, 17, 42, 3, 17, 42]  # greedy continuations loop on tiny random models


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    p = tmp_path_factory.mktemp("torch_la") / "m.gguf"
    testmodel.build_tiny_llama(p, seed=7, **CFG)
    return p


@pytest.fixture(scope="module")
def target(path):
    return load_model(path, device="cpu")


@pytest.fixture(scope="module")
def jtarget(path):
    return j_load(path)


def _ctx(m, n_cells):
    return InferenceContext(*m, n_cells=n_cells, cache_dtype=torch.float32, device="cpu")


def _plain(m, prompt, n, sp):
    ctx = _ctx(m, 256)
    st = SamplerState(params=sp)
    b = Batch()
    for i, t in enumerate(prompt):
        st.accept(t, apply_grammar=False)
        b.add(t, i, 0, want_logits=(i == len(prompt) - 1))
    logits = ctx.decode(b)[-1]
    out, pos = [], len(prompt)
    for _ in range(n):
        tok = sample(st, logits)
        st.accept(tok)
        out.append(tok)
        b.clear()
        b.add(tok, pos, 0)
        logits = ctx.decode(b)[0]
        pos += 1
    return out


def _jax_lookahead(jm, prompt, n, n_cells, sp_kw, **wng):
    eng = JLookahead(JContext(*jm, n_cells=n_cells, cache_dtype=jnp.float32),
                     JSamplingParams(**sp_kw), eos_id=-1, **wng)
    return eng.generate(list(prompt), n), eng


@pytest.mark.parametrize("prompt,n,n_cells,sp_kw,wng", [
    (PROMPT, N_PREDICT, 512, dict(temp=0.0), dict(W=4, N=3, G=4)),
    (PROMPT, N_PREDICT, 1024, dict(temp=0.0), dict(W=8, N=4, G=8)),
    (CYCLIC, 48, 2048, dict(temp=0.0, penalty_repeat=1.0, penalty_last_n=0),
     dict(W=6, N=4, G=8)),
    (PROMPT, 32, 512, dict(temp=0.0), dict(W=15, N=5, G=15)),  # the CLI's defaults
], ids=["w4n3g4", "w8n4g8", "repetitive", "w15n5g15"])
def test_lookahead_matches_plain_and_jax(target, jtarget, prompt, n, n_cells, sp_kw, wng):
    sp = SamplingParams(**sp_kw)
    want = _plain(target, prompt, n, sp)
    eng = LookaheadDecoder(_ctx(target, n_cells), sp, eos_id=-1, **wng)
    got = eng.generate(list(prompt), n)
    assert got == want, f"lookahead diverges: {got} vs {want}"
    assert eng.stats.n_predict == n
    jgot, jeng = _jax_lookahead(jtarget, prompt, n, n_cells, sp_kw, **wng)
    assert got == jgot and eng.stats.n_accept == jeng.stats.n_accept
    np.testing.assert_array_equal(eng.pool, jeng.pool)  # the same n-gram pool


def test_lookahead_accepts_on_repetitive_text(target):
    """A prompt whose continuation loops fills the n-gram pool and yields
    accepted tokens: the speedup mechanism engages."""
    sp = SamplingParams(temp=0.0, penalty_repeat=1.0, penalty_last_n=0)
    eng = LookaheadDecoder(_ctx(target, 2048), sp, W=6, N=4, G=8, eos_id=-1)
    assert eng.generate(list(CYCLIC), 48) == _plain(target, CYCLIC, 48, sp)
    assert eng.stats.n_accept > 0, "n-gram verification never accepted"
    assert eng.pool_cnt.sum() > 0


def test_lookahead_seq_budget_guard(target):
    with pytest.raises(ValueError):
        LookaheadDecoder(_ctx(target, 256), SamplingParams(temp=0.0), W=40, N=5, G=40, eos_id=-1)


@pytest.mark.parametrize("n_stages", [2, 4])
def test_lookahead_on_staged_pipeline(path, n_stages):
    """Lookahead over a layer-split target (rm_tail, seq_keep and seq_cp
    fan out to every stage), token-exact, with the JAX package's
    acceptance."""
    m4 = path.with_name("m4.gguf")
    if not m4.exists():
        testmodel.build_tiny_llama(m4, seed=7, **dict(CFG, n_layers=4))
    tm, jm = load_model(m4, device="cpu"), j_load(m4)
    sp = SamplingParams(temp=0.0, penalty_repeat=1.0, penalty_last_n=0)
    want = _plain(tm, CYCLIC, 32, sp)
    ctx = StagedInferenceContext(*tm, n_cells=512, devices=["cpu"] * n_stages,
                                 cache_dtype=torch.float32)
    dec = LookaheadDecoder(ctx, sp, W=6, N=4, G=8, eos_id=-1)
    got = dec.generate(list(CYCLIC), 32)
    assert got == want, f"{got} vs {want}"
    jgot, jeng = _jax_lookahead(jm, CYCLIC, 32, 512,
                                dict(temp=0.0, penalty_repeat=1.0, penalty_last_n=0),
                                W=6, N=4, G=8)
    assert got == jgot and dec.stats.n_accept == jeng.stats.n_accept
