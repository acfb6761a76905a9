"""The port's tools that run a model (tools/perplexity.py, bench.py,
beam_search.py, batched.py, batched_bench.py, embedding.py, shapebench.py)
on the CPU, against the JAX package's on the same GGUF files, mirroring
tests/test_state_and_tools.py and tests/test_batched_tools.py. Greedy and
seeded token streams must be identical; perplexity, beam scores and
embeddings agree within the tolerance each test states (the two packages'
CPU matmuls sum in other orders)."""

import contextlib
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pipeinfer_tpu.models import load_model as j_load
from pipeinfer_tpu.runtime.context import InferenceContext as JContext
from pipeinfer_tpu.sampling.samplers import SamplingParams as JSamplingParams
from pipeinfer_tpu.tools import batched_bench as j_batched_bench
from pipeinfer_tpu.tools import bench as j_bench
from pipeinfer_tpu.tools.batched import batched_generate as j_batched_generate
from pipeinfer_tpu.tools.beam_search import beam_search as j_beam_search
from pipeinfer_tpu.tools.embedding import embed_text as j_embed_text
from pipeinfer_tpu.tools.perplexity import perplexity as j_perplexity
from pipeinfer_tpu_torch.models import load_model
from pipeinfer_tpu_torch.ops.qmatmul import dequant
from pipeinfer_tpu_torch.runtime.context import Batch, InferenceContext
from pipeinfer_tpu_torch.sampling.samplers import SamplerState, SamplingParams, sample
from pipeinfer_tpu_torch.tools import batched_bench, bench, shapebench, testmodel
from pipeinfer_tpu_torch.tools.batched import batched_generate
from pipeinfer_tpu_torch.tools.beam_search import beam_search
from pipeinfer_tpu_torch.tools.embedding import embed_text
from pipeinfer_tpu_torch.tools.perplexity import perplexity

torch.set_num_threads(1)  # several test processes share the machine

CFG = dict(n_layers=2, n_embd=64, n_heads=4, n_kv_heads=2, n_ff=128, n_vocab=300)
PROMPT = [5, 77, 12]
GREEDY = dict(temp=0.0, penalty_repeat=1.0, penalty_last_n=0)  # argmax, no repeat penalty


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    p = tmp_path_factory.mktemp("torch_tools") / "m.gguf"
    testmodel.build_tiny_llama(p, seed=3, **CFG)
    return p


@pytest.fixture(scope="module")
def model(path):
    return load_model(path, device="cpu")


@pytest.fixture(scope="module")
def jmodel(path):
    return j_load(path)


def _ctx(model, n_cells):
    return InferenceContext(*model, n_cells=n_cells, cache_dtype=torch.float32, device="cpu")


def _jctx(jmodel, n_cells):
    return JContext(*jmodel, n_cells=n_cells, cache_dtype=jnp.float32)


def _plain(model, prompt, n, sp):
    ctx = _ctx(model, 256)
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


def _stdout(entry, argv) -> list[str]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert entry(argv) == 0
    return buf.getvalue().splitlines()


class TokStub:
    """tests/test_state_and_tools.py:83-90: 131 tokens from a seed."""

    class vocab:
        eos_id = 2

    def encode(self, text, add_bos=True):
        rng = np.random.default_rng(0)
        return [1] + rng.integers(3, CFG["n_vocab"], 130).tolist()


def test_perplexity_matches_jax(model, jmodel):
    """Two windows of 64, the second half of each scored: the same count
    and the perplexity within 1e-4 relative."""
    ppl, n = perplexity(_ctx(model, 80), TokStub(), "x", n_ctx=64)
    want, n_want = j_perplexity(_jctx(jmodel, 80), TokStub(), "x", n_ctx=64)
    assert n == n_want == 2 * (64 - 1 - 32)
    assert 1.0 < ppl < CFG["n_vocab"] * 2
    assert abs(ppl - want) <= 1e-4 * want, (ppl, want)


def test_perplexity_refuses_a_short_corpus(model):
    with pytest.raises(SystemExit, match="corpus too short"):
        perplexity(_ctx(model, 512), TokStub(), "x", n_ctx=256)


def test_beam_search_one_beam_is_greedy(model):
    beams = beam_search(_ctx(model, 128), PROMPT, 8, n_beams=1, eos_id=-1, topk=None)
    assert len(beams) == 1
    assert beams[0][1] == _plain(model, PROMPT, 8, SamplingParams(**GREEDY))


@pytest.mark.parametrize("topk", [None, 64])
def test_beam_search_matches_jax(model, jmodel, topk):
    """4 beams on sequence slots 0..7: sorted by score, at least the
    greedy beam's score, and the JAX package's beams token for token,
    their scores within 1e-4."""
    beams = beam_search(_ctx(model, 256), PROMPT, 8, n_beams=4, eos_id=-1, topk=topk)
    want = j_beam_search(_jctx(jmodel, 256), PROMPT, 8, n_beams=4, eos_id=-1, topk=topk)
    assert len(beams) == 4
    scores = [s for s, _ in beams]
    assert scores == sorted(scores, reverse=True)
    greedy = beam_search(_ctx(model, 128), PROMPT, 8, n_beams=1, eos_id=-1, topk=topk)
    assert beams[0][0] >= greedy[0][0] - 1e-4
    assert [t for _, t in beams] == [t for _, t in want]
    np.testing.assert_allclose(scores, [s for s, _ in want], rtol=0, atol=1e-4)


def test_beam_search_ends_beams_on_eos(model):
    """A beam that samples EOS stops growing and keeps its score."""
    greedy = _plain(model, PROMPT, 8, SamplingParams(**GREEDY))
    beams = beam_search(_ctx(model, 256), PROMPT, 8, n_beams=2, eos_id=greedy[2], topk=None)
    assert any(t[-1] == greedy[2] and len(t) < 8 for _, t in beams)


def test_batched_greedy_matches_single(model):
    """All-greedy parallel continuations each equal the single-stream
    result (tests/test_batched_tools.py:46-57)."""
    sp = SamplingParams(temp=0.0)
    want = _plain(model, PROMPT, 10, sp)
    outs = batched_generate(_ctx(model, 256), PROMPT, 10, 3, sp, eos_id=-1)
    assert outs == [want] * 3


def test_batched_seeded_streams_decorrelate(model):
    """With temp > 0 each sequence samples from its own RNG stream (seed +
    s), so a sequence's stream is the single-stream run under its seed."""
    outs = batched_generate(_ctx(model, 256), PROMPT, 12, 4,
                            SamplingParams(temp=1.2, seed=9), eos_id=-1)
    assert len({tuple(o) for o in outs}) > 1, "parallel streams identical"
    assert outs[2] == _plain(model, PROMPT, 12, SamplingParams(temp=1.2, seed=11))


@pytest.mark.parametrize("sp_kw", [dict(temp=0.0), dict(temp=1.2, seed=9)])
def test_batched_matches_jax(model, jmodel, sp_kw):
    got = batched_generate(_ctx(model, 256), PROMPT, 12, 4, SamplingParams(**sp_kw), eos_id=-1)
    want = j_batched_generate(_jctx(jmodel, 256), PROMPT, 12, 4, JSamplingParams(**sp_kw),
                              eos_id=-1)
    assert got == want


def test_batched_drops_a_sequence_on_eos(model):
    """A sequence that samples EOS leaves the batch (seq_rm of its bit
    only); the others continue on the shared prompt cells."""
    sp = SamplingParams(temp=1.2, seed=9)
    free = batched_generate(_ctx(model, 256), PROMPT, 12, 4, sp, eos_id=-1)
    eos = free[1][3]
    ctx = _ctx(model, 256)
    outs = batched_generate(ctx, PROMPT, 12, 4, sp, eos_id=eos)
    for s, o in enumerate(outs):
        cut = free[s].index(eos) + 1 if eos in free[s] else 12
        assert o == free[s][:cut]


def test_batched_bench_prints_the_jax_table(path):
    """The reference's header and columns, one row per (pp, tg, pl) cell,
    the same N_KV as the JAX tool, shared and --no-share."""
    for extra in ([], ["--no-share"]):
        argv = ["-m", str(path), "-pp", "8", "-tg", "4", "-pl", "1,2", *extra]
        got = _stdout(batched_bench.main, argv + ["--device", "cpu"])
        want = _stdout(j_batched_bench.main, argv)
        assert len(got) == len(want) == 2 + 2
        assert got[:2] == want[:2] and "S_TG t/s" in got[0]
        assert [r.split("|")[1:5] for r in got[2:]] == [r.split("|")[1:5] for r in want[2:]]


def test_bench_prints_the_jax_rows(path):
    """pp and tg rows by the JAX tool's names, in markdown and JSON."""
    argv = ["-m", str(path), "-pp", "8,16", "-tg", "4", "-r", "1", "-c", "64"]
    got = _stdout(bench.main, argv + ["--device", "cpu"])
    want = _stdout(j_bench.main, argv)
    assert got[:2] == want[:2] == ["| test | t/s |", "|------|-----|"]
    assert [r.split("|")[1] for r in got[2:]] == [r.split("|")[1] for r in want[2:]] \
        == [" pp8 ", " pp16 ", " tg4 "]
    import json

    got = json.loads(_stdout(bench.main, argv + ["-o", "json", "--device", "cpu"])[-1])
    want = json.loads(_stdout(j_bench.main, argv + ["-o", "json"])[-1])
    assert [r["test"] for r in got["results"]] == [r["test"] for r in want["results"]]
    assert all(r["t/s"] > 0 for r in got["results"])


def test_bench_functions_run(model):
    ctx = _ctx(model, 64)
    assert bench.bench_pp(ctx, 16, reps=1) > 0
    assert bench.bench_tg(ctx, 4, reps=1) > 0
    assert bench.bench_tg(ctx, 4, reps=1, topk=None) > 0


@pytest.mark.parametrize("arch", ["llama", "falcon"])
def test_embedding_matches_jax(tmp_path, arch):
    """Mean-pooled, L2-normalized output-normed hidden states of the
    architecture's forward: unit norm, and within 1e-5 of the JAX
    package's (llama, and falcon through the generic decoder)."""
    p = tmp_path / f"{arch}.gguf"
    if arch == "llama":
        testmodel.build_tiny_llama(p, seed=3, **CFG)
    else:
        testmodel.build_tiny_arch(p, arch, seed=3, n_layers=2, n_embd=64, n_heads=4,
                                  n_kv_heads=1, n_ff=128, n_vocab=300)
    ids = [1, 44, 9, 123, 7]
    params, cfg = load_model(p, device="cpu")
    got = embed_text(params, cfg, ids)
    want = j_embed_text(*j_load(p), ids)
    assert cfg.arch == arch and got.shape == (cfg.n_embd,)
    assert abs(float(np.linalg.norm(got)) - 1.0) < 1e-5
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_shapebench_functions_at_a_tiny_shape():
    """The synthesized k_major Q4_K tensors are one packed tile repeated
    (valid planes in the port's shapes), model_bytes counts every plane,
    and the probe's steps and chains run at a tiny shape."""
    qt = shapebench.synth_qtensor(300, 512, device="cpu")
    assert qt.qs.shape == (256, 300) and qt.scales.shape == (16, 300)
    w = dequant(qt)
    tile = w[:shapebench._TILE_N, :shapebench._TILE_K]
    assert torch.equal(w, tile.repeat(3, 2)[:300])
    emb = shapebench.synth_qtensor(300, 512, layout="n_major", device="cpu")
    assert torch.equal(dequant(emb), w)
    tiny = dict(n_layers=2, n_embd=256, n_heads=2, n_kv_heads=1, n_ff=512, n_vocab=512)
    params = shapebench.synth_params(tiny, device="cpu")
    assert shapebench.model_bytes(params) == sum(
        shapebench.model_bytes(v) for v in params.values())
    assert shapebench.model_bytes(params["output"]) == params["output"].nbytes() > 0
    res = shapebench.probe(tiny, tiny, name="tiny", n_cells=512, iters=1, device="cpu")
    for key in ("step1_ms", "step8_ms", "step32_ms", "chain8_ms", "chain32_ms", "fetch_ms",
                "draft_chain8_ms", "draft_chain32_ms"):
        assert res[key] > 0, key
    assert 0 <= res["step1_bw_frac"] < 1 and res["packed_gb"] >= 0


@pytest.mark.parametrize("name", ["perplexity", "bench", "beam_search", "batched",
                                  "batched_bench", "embedding", "shapebench"])
def test_tool_runs_as_a_module(name):
    """`python -m pipeinfer_tpu_torch.tools.<name> --help` in a process of
    its own: the entry exists, parses, and offers --device (default cuda)."""
    import subprocess
    import sys
    from pathlib import Path

    out = subprocess.run([sys.executable, "-m", f"pipeinfer_tpu_torch.tools.{name}", "--help"],
                         cwd=Path(__file__).resolve().parent.parent, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "--device" in out.stdout


def test_tools_default_to_cuda(path, monkeypatch):
    """Without --device a tool asks for the card, and raises without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.main(["-m", str(path), "-pp", "8", "-tg", "2", "-r", "1"])
