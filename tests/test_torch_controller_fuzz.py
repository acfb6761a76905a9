"""Adversarial and property tests of the port's async controller state
machine: tests/test_controller_fuzz.py's three tests with their configs
and seeds. Random draft quality, tick interleavings, KV pools sized to
force backpressure and multi-stream scheduling: golden tokens (the
port's plain decoding and the JAX package's of the same file), no leaked
offsets or branch cells, no deadlock."""

import numpy as np
import pytest

from pipeinfer_tpu_torch.runtime import kv_cache as kv
from pipeinfer_tpu_torch.sampling.samplers import SamplingParams
from pipeinfer_tpu_torch.spec.controller import PipeInferController
from pipeinfer_tpu_torch.spec.multi import MultiPipeInfer
from pipeinfer_tpu_torch.spec.params import SpecParams

from .test_torch_sync_spec import CFG, build, plain_both, tctx


@pytest.fixture(scope="module")
def target(tmp_path_factory):
    return build(tmp_path_factory.mktemp("tfuzz") / "tgt.gguf", seed=7, **CFG)


@pytest.fixture(scope="module")
def bad_draft(tmp_path_factory):
    """A draft that disagrees with the target almost everywhere."""
    return build(tmp_path_factory.mktemp("tfuzz") / "dft.gguf", seed=23, **CFG)


def _golden(target, prompt, n_predict):
    # the default SamplingParams carry repetition penalties: the prompt
    # enters the penalty window as the controller's start_generation does
    return plain_both(target, prompt, n_predict, dict(temp=0.0), accept_prompt=True)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_fuzz_random_params_and_ticks(target, bad_draft, seed):
    rng = np.random.default_rng(seed)
    prompt = [int(x) for x in rng.integers(3, CFG["n_vocab"] - 1, size=4)]
    n_predict = int(rng.integers(8, 20))
    sp = SpecParams(
        n_draft=int(rng.integers(2, 7)),
        n_parallel=int(rng.integers(1, 4)),
        p_accept=float(rng.choice([0.0, 0.1, 0.4])),
        p_split=float(rng.choice([0.5, 0.9])),
        max_inflight=int(rng.integers(1, 5)),
    )
    want = _golden(target, prompt, n_predict)

    tgt, dft = tctx(target, 256), tctx(bad_draft, 256)
    c = PipeInferController(tgt, dft, SamplingParams(temp=0.0), sp, eos_id=-1)
    n_offsets = len(c.free_offsets)
    c.start_generation(list(prompt), n_predict)
    ticks = 0
    while not c.done:
        ticks += 1
        assert ticks < 5000, "controller deadlocked / livelocked"
        c.tick(block=bool(rng.random() < 0.4))
    got = c.finish_generation()

    assert got == want, f"seed {seed}: {got} vs {want}"
    assert len(c.free_offsets) == n_offsets, "leaked sequence offsets"
    live = any(kv.host_member(tgt.h_seq, sq).any() for sq in range(1, 32 * kv.SEQ_WORDS))
    assert not live, "leaked branch cells on the target"


@pytest.mark.parametrize("n_cells", [40, 56])
def test_cache_full_backpressure(target, bad_draft, n_cells):
    """KV pools barely larger than the committed stream: speculation hits
    CacheFull, backs off, and still finishes with golden tokens."""
    prompt, n_predict = [3, 17, 42, 7], 16
    want = _golden(target, prompt, n_predict)
    sp = SpecParams(n_draft=6, n_parallel=2, p_accept=0.0, max_inflight=4)
    c = PipeInferController(tctx(target, n_cells), tctx(bad_draft, n_cells),
                            SamplingParams(temp=0.0), sp, eos_id=-1)
    got = c.generate(list(prompt), n_predict)
    assert got == want, f"n_cells={n_cells}: {got} vs {want}"
    assert len(c.free_offsets) == sp.max_inflight


def test_fuzz_multi_stream_interleaving(target, bad_draft):
    rng = np.random.default_rng(11)
    prompts = [[int(x) for x in rng.integers(3, CFG["n_vocab"] - 1,
                                             size=int(rng.integers(3, 6)))] for _ in range(3)]
    n_predicts = [int(rng.integers(6, 14)) for _ in range(3)]
    goldens = [_golden(target, p, n) for p, n in zip(prompts, n_predicts)]

    eng = MultiPipeInfer(
        tctx(target, 512), tctx(bad_draft, 512), SamplingParams(temp=0.0),
        SpecParams(n_draft=4, n_parallel=1, p_accept=0.0, max_inflight=2), eos_id=-1)
    reqs = [eng.submit(prompt_ids=p, n_predict=n, ignore_eos=True)
            for p, n in zip(prompts, n_predicts)]
    steps = 0
    while not all(r.done for r in reqs):
        steps += 1
        assert steps < 20000, "multi-stream engine deadlocked"
        eng.step()
    for i, r in enumerate(reqs):
        assert r.error is None, r.error
        assert r.tokens == goldens[i], f"stream {i}: {r.tokens} vs {goldens[i]}"
