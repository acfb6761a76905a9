"""The host-verified sampled paths, exact against the JAX package on the CPU.

Where verification samples on the host, every position is drawn once, in
order, from the one numpy generator of the sampler (what the JAX package's
tests/test_async_spec.py:90 rests on), so a seeded speculative run prints
plain sampled decoding's stream. Here the port's streams are held to the
JAX package's plain sampled stream on the same file and seed:

- the host-verified controller with the default chain, repetition
  penalties on, one branch and trees of 3 (p_split 0.1), self-drafted and
  with another model as the draft;
- the fused stochastic run (-np 1, no penalties, device_verify off: the
  draft chains sample on the device, the target on the host);
- `cli.main` and `cli.speculative` with no sampling flags and `-s 1234`
  print the JAX package's stdout byte for byte, and not the greedy text.

The models are tiny f32 llamas with a synthetic SPM vocabulary, their
output norm scaled by LOGIT_SCALE so the logits spread (std about 1.5)
and a seeded stream visibly differs from greedy.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pipeinfer_tpu.cli import main as j_main
from pipeinfer_tpu.cli import speculative as j_spec
from pipeinfer_tpu.models import load_model as j_load
from pipeinfer_tpu.runtime.context import Batch as JBatch
from pipeinfer_tpu.runtime.context import InferenceContext as JContext
from pipeinfer_tpu.sampling import samplers as j_samplers
from pipeinfer_tpu_torch.cli import main as t_main
from pipeinfer_tpu_torch.cli import speculative as t_spec
from pipeinfer_tpu_torch.models import load_model
from pipeinfer_tpu_torch.runtime.context import Batch, InferenceContext
from pipeinfer_tpu_torch.sampling import samplers as t_samplers
from pipeinfer_tpu_torch.spec.controller import PipeInferController
from pipeinfer_tpu_torch.spec.params import SpecParams
from pipeinfer_tpu_torch.tools import testmodel

torch.set_num_threads(1)  # several test processes share the machine (test_torch_cli.py)

CFG = dict(n_layers=2, n_embd=64, n_heads=4, n_kv_heads=2, n_ff=128, n_vocab=512)
LOGIT_SCALE = 3.0
PROMPT = [1, 17, 42, 7, 300, 5]
N = 48
SEED = 1234
DEFAULT = dict(seed=SEED)  # the CLI's defaults: temp 0.8, top_k 40, top_p 0.95, min_p 0.05,
# repeat penalty 1.1 over the last 64
CHAIN = dict(seed=SEED, penalty_repeat=1.0, penalty_last_n=0)
TEXT = "once upon a time the little robot"


def _write(path, seed):
    w = testmodel.random_llama_weights(np.random.default_rng(seed), **CFG)
    w["output_norm"] = w["output_norm"] * LOGIT_SCALE
    testmodel.write_llama_gguf(path, w, **CFG,
                               extra_kv=testmodel.synthetic_spm_vocab(CFG["n_vocab"]))
    return str(path)


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_sampled_exact")
    return {"t": _write(d / "t.gguf", 21), "d": _write(d / "d.gguf", 22)}


@pytest.fixture(scope="module")
def models(paths):
    return {k: load_model(p, device="cpu") for k, p in paths.items()}


def _ctx(m):
    return InferenceContext(*m, n_cells=512, cache_dtype=torch.float32, device="cpu")


def _plain(ctx, samplers, batch, sampling_kw, n=N):
    """Plain sampled decoding: the prompt into the sampler's window, then
    one host draw and one single-token step a position."""
    st = samplers.SamplerState(params=samplers.SamplingParams(**sampling_kw))
    b = batch()
    for i, t in enumerate(PROMPT):
        st.accept(t, apply_grammar=False)
        b.add(t, i, 0, want_logits=(i == len(PROMPT) - 1))
    logits, out = ctx.decode(b)[-1], []
    for pos in range(len(PROMPT), len(PROMPT) + n):
        out.append(samplers.sample(st, logits))
        st.accept(out[-1])
        b = batch()
        b.add(out[-1], pos, 0)
        logits = ctx.decode(b)[0]
    return out


@pytest.fixture(scope="module")
def jax_streams(paths):
    params, cfg = j_load(paths["t"])
    ctx = lambda: JContext(params, cfg, n_cells=512, cache_dtype=jnp.float32)  # noqa: E731
    return {name: _plain(ctx(), j_samplers, JBatch, kw)
            for name, kw in (("default", DEFAULT), ("chain", CHAIN), ("greedy", dict(temp=0.0)))}


def test_port_plain_sampling_equals_jax(models, jax_streams):
    for name, kw in (("default", DEFAULT), ("chain", CHAIN), ("greedy", dict(temp=0.0))):
        assert _plain(_ctx(models["t"]), t_samplers, Batch, kw) == jax_streams[name], name
    assert jax_streams["default"] != jax_streams["greedy"]  # really sampled
    assert jax_streams["chain"] != jax_streams["default"]  # the penalties act


@pytest.mark.parametrize("draft", ["self", "other"])
@pytest.mark.parametrize("n_parallel", [1, 3], ids=["np1", "trees_np3"])
def test_host_verified_controller_equals_jax_plain(models, jax_streams, draft, n_parallel):
    """Penalties keep the controller on host drafting and host
    verification (neither fused nor corrected): its seeded stream is the
    JAX package's plain sampled stream."""
    sp = SpecParams(n_draft=4, n_parallel=n_parallel, p_accept=0.0, p_split=0.1,
                    max_inflight=3)
    d = models["t" if draft == "self" else "d"]
    c = PipeInferController(_ctx(models["t"]), _ctx(d),
                            t_samplers.SamplingParams(**DEFAULT), sp, eos_id=-1)
    assert not c.use_fused and not c.use_corrected
    assert c.generate(list(PROMPT), N, ignore_eos=True) == jax_streams["default"]
    assert c.stats.n_drafted > 0
    assert len(c.free_offsets) == sp.max_inflight and not c.runs


@pytest.mark.parametrize("draft", ["self", "other"])
def test_fused_stochastic_run_equals_jax_plain(models, jax_streams, draft):
    """-np 1 without penalties and with device verification off: fused
    runs (device Gumbel drafts, host verification) give the JAX package's
    plain sampled stream of the chain."""
    sp = SpecParams(n_draft=4, n_parallel=1, p_accept=0.0, max_inflight=3, device_verify=False)
    d = models["t" if draft == "self" else "d"]
    c = PipeInferController(_ctx(models["t"]), _ctx(d), t_samplers.SamplingParams(**CHAIN), sp,
                            eos_id=-1)
    assert c.use_fused and not c.use_corrected
    assert c.generate(list(PROMPT), N, ignore_eos=True) == jax_streams["chain"]
    assert c.stats.n_accept > 0 if draft == "self" else c.stats.n_drafted > 0


def _stdout(entry, argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(io.StringIO()):
        assert entry(argv) == 0
    return buf.getvalue()


@pytest.mark.parametrize("case", ["main", "speculative"])
def test_cli_default_sampling_prints_the_jax_stdout(paths, case, monkeypatch):
    """No sampling flags (penalties on, -np 3 for speculative) and -s 1234:
    the port prints the JAX package's stdout, cli.speculative prints
    cli.main's, and the text is not the greedy one."""
    monkeypatch.delenv("PIPEINFER_WEIGHT_LAYOUT", raising=False)
    argv = ["-m", paths["t"], "-p", TEXT, "-n", "32", "-s", str(SEED), "-c", "256"]
    if case == "speculative":
        argv += ["-md", paths["d"]]
    j_entry, t_entry = (j_main.main, t_main.main) if case == "main" else \
        (j_spec.main, t_spec.main)
    want = _stdout(j_entry, argv)
    got = _stdout(t_entry, argv + ["--device", "cpu"])
    assert got == want
    main_text = _stdout(t_main.main, argv[:8] + ["-c", "256", "--device", "cpu"])
    assert got == main_text and len(got) > len(TEXT) + 32
    greedy = _stdout(t_main.main, argv[:8] + ["-c", "256", "--temp", "0", "--device", "cpu"])
    assert got != greedy
