"""The port's device-resident speculative loop (spec/device_loop.py)
against the JAX package's, on the CPU.

The same tiny f32 llama pair, from one GGUF file each, goes through the
JAX DeviceLoopEngine and the port's (the port on its kernels' plain
versions): the greedy streams must be identical to each other and to
plain greedy decoding, for a perfect draft (the target itself) and a
divergent one (another random model). Stochastic runs are judged by their
properties (the port draws from a torch.Generator, so its streams differ
from the JAX PRNG's): a seeded run repeats, and top_k = 1 is greedy.
"""

import contextlib
import io
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pipeinfer_tpu.cli import speculative as j_spec
from pipeinfer_tpu.models import load_model as j_load
from pipeinfer_tpu.runtime.context import InferenceContext as JContext
from pipeinfer_tpu.sampling.samplers import SamplingParams as JSampling
from pipeinfer_tpu.spec.device_loop import DeviceLoopEngine as JEngine
from pipeinfer_tpu.spec.device_loop import supported as j_supported
from pipeinfer_tpu.spec.params import SpecParams as JSpec
from pipeinfer_tpu_torch.cli import speculative as t_spec
from pipeinfer_tpu_torch.models import load_model
from pipeinfer_tpu_torch.runtime import kv_cache as kv
from pipeinfer_tpu_torch.runtime.context import Batch, InferenceContext
from pipeinfer_tpu_torch.sampling.samplers import SamplingParams
from pipeinfer_tpu_torch.spec.device_loop import DeviceLoopEngine, supported
from pipeinfer_tpu_torch.spec.params import SpecParams
from pipeinfer_tpu_torch.tools import testmodel

torch.set_num_threads(1)  # several test processes share the machine (test_torch_cli.py)

GREEDY = dict(temp=0.0, penalty_repeat=1.0, penalty_last_n=0)
PROMPT = [3, 17, 42]
N = 40


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_dloop")
    testmodel.build_tiny_llama(d / "t.gguf", seed=5, n_layers=2, n_embd=128, n_heads=4,
                               n_kv_heads=2, n_ff=256, n_vocab=512)
    testmodel.build_tiny_llama(d / "d.gguf", seed=9, n_layers=1, n_embd=64, n_heads=2,
                               n_kv_heads=2, n_ff=128, n_vocab=512)
    return d


@pytest.fixture(scope="module")
def models(paths):
    """{"t"/"d": (JAX (params, cfg), port (params, cfg))}."""
    return {k: (j_load(paths / f"{k}.gguf"), load_model(paths / f"{k}.gguf", device="cpu"))
            for k in ("t", "d")}


def tctx(m, n_cells=512):
    return InferenceContext(*m, n_cells=n_cells, cache_dtype=torch.float32, device="cpu")


def jctx(m, n_cells=512):
    return JContext(*m, n_cells=n_cells, cache_dtype=jnp.float32)


def plain_greedy(ctx, prompt, n):
    """Plain greedy decoding on seq 0 of a fresh context."""
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
    return out


@pytest.fixture(scope="module")
def ref(models):
    return plain_greedy(tctx(models["t"][1]), PROMPT, N)


def mirrors_match_device(ctx: InferenceContext) -> bool:
    """The host mirrors and the device metadata agree cell for cell."""
    return (np.array_equal(ctx.h_pos, ctx.cache.pos.numpy())
            and np.array_equal(ctx.h_seq.view(np.int32), ctx.cache.seq.numpy()))


def test_supported_gate():
    cases = [GREEDY, dict(temp=0.8, top_k=40, penalty_repeat=1.0, penalty_last_n=0),
             dict(temp=0.0), dict(temp=0.8, top_k=0, penalty_repeat=1.0, penalty_last_n=0),
             dict(temp=0.0, mirostat=2), dict(temp=0.0, penalty_last_n=0, logit_bias={5: 1.0}),
             dict(temp=0.7, top_k=65, penalty_last_n=0), dict(temp=0.7, top_k=8, tfs_z=0.9,
                                                             penalty_last_n=0)]
    got = [supported(SamplingParams(**c)) for c in cases]
    assert got == [j_supported(JSampling(**c)) for c in cases]
    assert got == [True, True, False, False, False, False, False, False]
    assert not supported(SamplingParams(**GREEDY), grammar=object())


@pytest.mark.parametrize("draft", ["perfect", "divergent"])
@pytest.mark.parametrize("depth,rounds", [(4, 4), (8, 2), (3, 5)])
def test_greedy_equals_jax_and_plain(models, ref, draft, depth, rounds):
    """Greedy: the port's stream == the JAX engine's == plain greedy, with
    the same acceptance (on-device verify from the true frontier)."""
    d = "t" if draft == "perfect" else "d"
    eng = DeviceLoopEngine(tctx(models["t"][1]), tctx(models[d][1]), SamplingParams(**GREEDY),
                           SpecParams(n_draft=depth), eos_id=-1, rounds=rounds)
    got = eng.generate(list(PROMPT), N, ignore_eos=True)
    jeng = JEngine(jctx(models["t"][0]), jctx(models[d][0]), JSampling(**GREEDY),
                   JSpec(n_draft=depth), eos_id=-1, rounds=rounds)
    assert got == jeng.generate(list(PROMPT), N, ignore_eos=True) == ref
    assert (eng.stats.n_accept, eng.stats.n_predict) == (jeng.stats.n_accept,
                                                         jeng.stats.n_predict)
    if draft == "perfect":
        assert eng.stats.n_accept > 0
    else:
        assert eng.stats.accept_rate < 0.9  # the draft really diverges


def test_eos_stop(models, ref):
    eos = ref[7]  # stop at this token's FIRST occurrence
    eng = DeviceLoopEngine(tctx(models["t"][1]), tctx(models["t"][1]), SamplingParams(**GREEDY),
                           SpecParams(n_draft=4), eos_id=eos, rounds=4)
    got = eng.generate(list(PROMPT), N)
    assert got == ref[: ref.index(eos) + 1]
    jeng = JEngine(jctx(models["t"][0]), jctx(models["t"][0]), JSampling(**GREEDY),
                   JSpec(n_draft=4), eos_id=eos, rounds=4)
    assert got == jeng.generate(list(PROMPT), N)


def test_back_to_back_no_leaked_cells(models, ref):
    """Generations on the same contexts: after each, every dead cell is
    free and the host mirrors equal the device metadata; the target cache
    holds each position of the prompt and the generated tokens once (the
    last token's only where a later round decoded it)."""
    t, d = tctx(models["t"][1]), tctx(models["d"][1])
    drained = []
    for trial in range(3):
        eng = DeviceLoopEngine(t, d, SamplingParams(**GREEDY), SpecParams(n_draft=4), eos_id=-1,
                               rounds=3)
        n = 24 + trial
        assert eng.generate(list(PROMPT), n, ignore_eos=True) == ref[:n], trial
        drained.append(eng.stats.n_drafted_unverified > 0)
        for ctx in (t, d):
            assert mirrors_match_device(ctx), trial
        live = np.sort(t.h_pos[t.h_pos >= 0])
        assert np.array_equal(live, np.arange(len(live))), trial
        assert len(live) in (len(PROMPT) + n - 1, len(PROMPT) + n), trial
        t.clear_cache()
        d.clear_cache()
    assert any(drained)  # a generation ended with rounds it never consumed


def test_hot_window_zero_same_tokens(models, ref, monkeypatch):
    """The hot window (refreshed per dispatch from the mirrors) covers
    every cell a dispatch writes: the same tokens with it forced to 0 (the
    whole pool streamed) over a 1024-cell pool."""
    def run():
        eng = DeviceLoopEngine(tctx(models["t"][1], 1024), tctx(models["d"][1], 1024),
                               SamplingParams(**GREEDY), SpecParams(n_draft=6), eos_id=-1,
                               rounds=4)
        out = eng.generate(list(PROMPT), N, ignore_eos=True)
        return out, eng.tgt.cache.hot

    got, hot = run()
    assert hot == 512  # the window was in use
    monkeypatch.setattr(kv, "hot_bucket", lambda h_pos, trash: 0)
    got0, hot0 = run()
    assert hot0 == 0
    assert got == got0 == ref


def test_stochastic_reproducible_and_top1_greedy(models, ref):
    stoch = SamplingParams(temp=0.8, top_k=40, penalty_repeat=1.0, penalty_last_n=0, seed=7)

    def run(sampling):
        eng = DeviceLoopEngine(tctx(models["t"][1]), tctx(models["d"][1]), sampling,
                               SpecParams(n_draft=4), eos_id=-1, rounds=3)
        return eng.generate(list(PROMPT), 16, ignore_eos=True)

    a, b = run(stoch), run(stoch)
    assert a == b and len(a) == 16, "a seeded run must repeat"
    assert a != ref[:16]  # really sampled (temperature 0.8 over a random model)
    # top_k = 1 collapses the chain to the argmax: plain greedy
    one = SamplingParams(temp=0.7, top_k=1, penalty_repeat=1.0, penalty_last_n=0, seed=3)
    assert run(one) == ref[:16]


def test_cli_device_loop_lines_on_vocab_pair(tmp_path):
    """On a pair with a vocabulary, the port's device-loop run prints the
    JAX CLI's stderr metric lines (values aside) and its stdout."""
    t, d = tmp_path / "t.gguf", tmp_path / "d.gguf"
    testmodel.build_bench_pair(t, d, scale="nano", eps=0.5, vocab=True)
    argv = ["-m", str(t), "-md", str(d), "-p", "Once upon a time", "-n", "24", "--temp", "0",
            "--repeat-penalty", "1.0", "--repeat-last-n", "0", "--ignore-eos", "-c", "256",
            "--engine", "device-loop", "-np", "1", "--draft", "5", "--loop-rounds", "3"]

    def run(entry, extra):
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stderr(err), contextlib.redirect_stdout(out):
            assert entry(argv + extra) == 0
        return out.getvalue(), err.getvalue()

    j_out, j_err = run(j_spec.main, [])
    t_out, t_err = run(t_spec.main, ["--device", "cpu"])
    assert t_out == j_out

    def metric_keys(text):
        return [line.split(" = ")[0].strip() for line in text.splitlines() if " = " in line]

    assert metric_keys(t_err) == metric_keys(j_err)
    assert re.search(r"^encode    = [0-9.]+ t/s$", t_err, re.M)
    rounds = re.search(r"^decode    = [0-9.]+ t/s \(device loop, (\d+) rounds\)$", t_err, re.M)
    j_rounds = re.search(r"\(device loop, (\d+) rounds\)", j_err)
    assert rounds and int(rounds.group(1)) % 3 == 0 and rounds.group(1) == j_rounds.group(1)
