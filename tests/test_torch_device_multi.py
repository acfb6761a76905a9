"""The port's batched device-resident speculation (spec/device_multi.py:
BatchedDeviceLoop, the S-lane loop behind DeviceLoopServer) against the
JAX package's, on the CPU.

Greedy: every stream's output equals the JAX engine's and its own solo
plain-greedy decode, across uneven lengths, EOS retirement and cell
reclamation. Stochastic: a seeded run repeats, identical prompts in
different lanes draw different noise, unseeded runs differ (the port
draws from a torch.Generator, so its streams differ from the JAX PRNG's).
Lanes may sit at the top of the sequence-slot namespace: slot 63 is bit
31 of word 1, negative in the int32 seq words.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pipeinfer_tpu.models import load_model as j_load
from pipeinfer_tpu.runtime.context import InferenceContext as JContext
from pipeinfer_tpu.sampling.samplers import SamplingParams as JSampling
from pipeinfer_tpu.spec.device_multi import BatchedDeviceLoop as JBatched
from pipeinfer_tpu.spec.params import SpecParams as JSpec
from pipeinfer_tpu_torch.models import load_model
from pipeinfer_tpu_torch.ops.cell_attention import _cell_attention_plain
from pipeinfer_tpu_torch.runtime import kv_cache as kv
from pipeinfer_tpu_torch.runtime.context import Batch, InferenceContext
from pipeinfer_tpu_torch.sampling.samplers import SamplingParams
from pipeinfer_tpu_torch.spec.device_multi import (BatchedDeviceLoop, DeviceLoopServer,
                                                   _rm_stream_tails)
from pipeinfer_tpu_torch.spec.params import SpecParams
from pipeinfer_tpu_torch.tools import testmodel

torch.set_num_threads(1)  # several test processes share the machine (test_torch_cli.py)

GREEDY = dict(temp=0.0, penalty_repeat=1.0, penalty_last_n=0)
PROMPTS = [[3, 17, 42], [5, 9], [100, 200, 300, 400]]


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """{"t"/"d": (JAX (params, cfg), port (params, cfg))}, one GGUF each."""
    d = tmp_path_factory.mktemp("torch_dmulti")
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


def engines(models, draft, *, depth=4, rounds=3, eos_id=-1, n_streams=3, n_cells=2048):
    """(port engine, JAX engine) over fresh contexts of the same pair."""
    t = BatchedDeviceLoop(tctx(models["t"][1], n_cells), tctx(models[draft][1], n_cells),
                          SamplingParams(**GREEDY), SpecParams(n_draft=depth),
                          n_streams=n_streams, eos_id=eos_id, rounds=rounds)
    j = JBatched(jctx(models["t"][0], n_cells), jctx(models[draft][0], n_cells),
                 JSampling(**GREEDY), JSpec(n_draft=depth), n_streams=n_streams, eos_id=eos_id,
                 rounds=rounds)
    return t, j


def test_greedy_per_stream_exact_divergent_draft(models):
    """Every stream equals the JAX engine's stream and its solo plain
    greedy decode, with a low-acceptance draft."""
    N = 24
    eng, jeng = engines(models, "d")
    outs = eng.generate_many([list(p) for p in PROMPTS], N, ignore_eos=True)
    assert outs == jeng.generate_many([list(p) for p in PROMPTS], N, ignore_eos=True)
    assert outs == [plain(models, p, N) for p in PROMPTS]
    assert [st.stats.n_accept for st in eng.streams] == [st.stats.n_accept for st in jeng.streams]


def test_uneven_lengths_and_early_retirement(models):
    """Streams with different n_predict: short ones retire and become
    padding rows; long ones keep exact greedy output to the end, and
    rounds committed after a stream retires are tail waste, not accepts."""
    nps = [6, 30, 14]
    eng, jeng = engines(models, "t", rounds=2)
    outs = eng.generate_many([list(p) for p in PROMPTS], nps, ignore_eos=True)
    assert outs == jeng.generate_many([list(p) for p in PROMPTS], nps, ignore_eos=True)
    for s, (got, p, n) in enumerate(zip(outs, PROMPTS, nps)):
        assert len(got) == n and got == plain(models, p, n), s
    for s, st in enumerate(eng.streams):
        decided = st.stats.n_drafted - st.stats.n_drafted_unverified
        assert st.stats.n_accept <= decided, f"stream {s} double-dips accepts"
        assert 0.0 <= st.stats.accept_rate_decided <= 1.0


def test_eos_retires_one_stream(models):
    ref1 = plain(models, PROMPTS[1], 30)
    eos = ref1[5]
    eng, jeng = engines(models, "t", rounds=2, eos_id=eos)
    outs = eng.generate_many([list(p) for p in PROMPTS], 30)
    assert outs == jeng.generate_many([list(p) for p in PROMPTS], 30)
    assert outs[1][-1] == eos and len(outs[1]) == ref1.index(eos) + 1
    for s in (0, 2):  # the other streams stop at eos too, against THEIR own reference
        assert outs[s] == plain(models, PROMPTS[s], 30)[: len(outs[s])]


def test_cell_reclamation_back_to_back(models):
    """Two generate_many calls on the same contexts: every scratch cell is
    freed (host mirrors reconciled, equal to the device metadata), and the
    final state is trimmed per stream."""
    t, d = tctx(models["t"][1]), tctx(models["d"][1])
    free0 = t.n_free_cells
    eng = BatchedDeviceLoop(t, d, SamplingParams(**GREEDY), SpecParams(n_draft=4), n_streams=3,
                            eos_id=-1, rounds=2)
    outs1 = eng.generate_many([list(p) for p in PROMPTS], 12, ignore_eos=True)
    assert t.n_free_cells == free0 - sum(len(p) + len(o) for p, o in zip(PROMPTS, outs1))
    for ctx in (t, d):
        assert np.array_equal(ctx.h_pos, ctx.cache.pos.numpy())
        assert np.array_equal(ctx.h_seq.view(np.int32), ctx.cache.seq.numpy())
    for s in range(3):
        t.seq_rm(s, 0, -1)
        d.seq_rm(s, 0, -1)
    assert t.n_free_cells == free0
    outs2 = BatchedDeviceLoop(t, d, SamplingParams(**GREEDY), SpecParams(n_draft=4), n_streams=3,
                              eos_id=-1, rounds=2).generate_many(
        [list(p) for p in PROMPTS], 12, ignore_eos=True)
    assert outs1 == outs2


def _stoch_run(models, prompts, n, *, temp, seed):
    eng = BatchedDeviceLoop(tctx(models["t"][1]), tctx(models["d"][1]),
                            SamplingParams(temp=temp, top_k=40, penalty_repeat=1.0,
                                           penalty_last_n=0, seed=seed),
                            SpecParams(n_draft=3), n_streams=3, eos_id=-1, rounds=2)
    return eng.generate_many([list(p) for p in prompts], n, ignore_eos=True)


def test_stochastic_seeded_reproducible(models):
    a = _stoch_run(models, PROMPTS, 10, temp=0.8, seed=11)
    assert a == _stoch_run(models, PROMPTS, 10, temp=0.8, seed=11)
    assert all(len(x) == 10 for x in a)
    assert a != [plain(models, p, 10) for p in PROMPTS]  # really sampled


def test_empty_prompt_rejected(models):
    """An empty prompt would silently mis-index prefill logits (ends =
    cumsum-1 hands it the previous stream's row) — must fail fast."""
    eng, _ = engines(models, "t", rounds=2)
    with pytest.raises(ValueError, match="empty prompt"):
        eng.generate_many([[3, 17], [], [5]], 4, ignore_eos=True)


def test_seeded_identical_prompts_diverge_across_streams(models):
    """Seeded stochastic runs: identical prompts in different lanes draw
    different noise (the host root draw folds the lane into its seed, and
    each lane's rows draw their own device noise)."""
    outs = _stoch_run(models, [[3, 17, 42]] * 3, 12, temp=1.2, seed=7)
    assert not (outs[0] == outs[1] == outs[2]), "streams replay one sample path"


def test_unseeded_runs_differ(models):
    """seed = -1 draws real entropy: two unseeded runs do not replay one
    noise sequence."""
    assert _stoch_run(models, PROMPTS, 16, temp=1.2, seed=-1) != \
        _stoch_run(models, PROMPTS, 16, temp=1.2, seed=-1)


def test_stream_count_guard(models):
    with pytest.raises(ValueError):
        engines(models, "t")[0].generate_many([[1]], 4)
    with pytest.raises(ValueError):  # default penalties: host verification
        BatchedDeviceLoop(tctx(models["t"][1]), tctx(models["t"][1]), SamplingParams(temp=0.0),
                          SpecParams(n_draft=4), n_streams=2)
    with pytest.raises(ValueError, match="single-device"):
        BatchedDeviceLoop(object(), tctx(models["t"][1]), SamplingParams(**GREEDY),
                          SpecParams(n_draft=4), n_streams=2)
    with pytest.raises(ValueError):
        BatchedDeviceLoop(tctx(models["t"][1]), tctx(models["t"][1]), SamplingParams(**GREEDY),
                          SpecParams(n_draft=4), n_streams=32 * kv.SEQ_WORDS + 1)


def test_lanes_at_the_top_slots_equal_the_bottom_ones(models):
    """Four lanes on slots 60-63 (63: the sign bit of word 1) give the
    streams of four lanes on slots 0-3, and both equal plain greedy."""
    prompts = PROMPTS + [[7, 8, 9]]
    outs = []
    for base in (0, 60):
        srv = DeviceLoopServer(tctx(models["t"][1]), tctx(models["d"][1]),
                               SamplingParams(**GREEDY), SpecParams(n_draft=4), n_lanes=4,
                               seq_base=base, rounds=2, eos_id=-1)
        hs = [srv.submit(p, 14) for p in prompts]
        srv.run_until_idle()
        assert all(h.done and h.error is None for h in hs)
        assert int((srv.tgt.h_pos >= 0).sum()) == 0
        outs.append([h.tokens for h in hs])
    assert outs[0] == outs[1] == [plain(models, p, 14) for p in prompts]


def test_slot_63_metadata_and_mask():
    """Slot 63 through the cache's seq ops, the dense mask and the cell
    kernel's plain version: membership, visibility and removal as for any
    other slot."""
    cache = kv.create(1, 64, 2, 8, torch.float32, device="cpu")
    cells = torch.arange(6, dtype=torch.int32)
    pos = torch.tensor([0, 1, 2, 0, 1, 2], dtype=torch.int32)
    seq = torch.tensor([63, 63, 63, 62, 62, 62], dtype=torch.int32)
    kv.write_meta(cache, cells, pos, seq, torch.tensor([True] * 5 + [False]))
    assert cache.seq[0, 1].item() == -(1 << 31)  # bit 31 of word 1, as int32
    assert kv._member(cache.seq, 63).tolist()[:6] == [True] * 3 + [False] * 3
    assert kv._member(cache.seq, 62).tolist()[:6] == [False] * 3 + [True, True, False]
    h_seq = kv.host_seq_zeros(64)
    h_seq[:3] = kv.host_only(63)
    h_seq[3:5] = kv.host_only(62)
    assert np.array_equal(h_seq.view(np.int32), cache.seq.numpy())
    tok_pos = torch.tensor([2, 1], dtype=torch.int32)
    tok_seq = torch.tensor([63, 62], dtype=torch.int32)
    mask = kv.attn_mask(cache, tok_pos, tok_seq)
    assert (mask[0, :3] == 0).all() and (mask[0, 3:] < 0).all()
    assert (mask[1, 3:5] == 0).all() and (mask[1, :3] < 0).all() and (mask[1, 5:] < 0).all()
    g = torch.Generator().manual_seed(0)
    cache.k.copy_(torch.randn(cache.k.shape, generator=g))
    cache.v.copy_(torch.randn(cache.v.shape, generator=g))
    q = torch.randn(2, 4, 8, generator=g)
    valid = torch.ones(2, dtype=torch.bool)
    got = _cell_attention_plain(q, cache.k, cache.v, cache.pos, cache.seq, tok_pos, tok_seq,
                                valid, 0, 0.35, None, 64)
    want = kv.attention(q, cache.k[0], cache.v[0], mask, scale=0.35)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    kv.seq_rm(cache, 63, 1, -1)
    assert cache.pos[:6].tolist() == [0, -1, -1, 0, 1, -1]
    assert kv._member(cache.seq, 63).tolist()[:3] == [True, False, False]


def test_rm_stream_tails_equals_per_stream_loop():
    """The vectorised tail trim equals the JAX package's per-stream loop
    (kv._member & pos >= base, one stream at a time) on random metadata
    over slots 60-63."""
    rng = np.random.default_rng(3)
    c, seqs = 256, torch.arange(60, 64, dtype=torch.int32)
    for _ in range(5):
        cache = kv.create(1, c, 1, 8, torch.float32, device="cpu")
        owner = rng.integers(56, 64, c)
        pos = rng.integers(-1, 40, c)
        rows = kv.host_rows([[int(o)] if p >= 0 else [] for o, p in zip(owner, pos)])
        cache.pos.copy_(torch.from_numpy(pos.astype(np.int32)))
        cache.seq.copy_(torch.from_numpy(rows.view(np.int32)))
        bases = torch.from_numpy(rng.integers(0, 40, 4).astype(np.int32))
        hit = torch.zeros(c, dtype=torch.bool)
        for s in range(4):
            hit |= kv._member(cache.seq, 60 + s) & (cache.pos >= bases[s])
        want_pos = torch.where(hit, -1, cache.pos)
        want_seq = torch.where(hit[:, None], 0, cache.seq)
        _rm_stream_tails(cache, bases, (seqs // 32).long(), kv._bits_of(seqs))
        assert torch.equal(cache.pos, want_pos) and torch.equal(cache.seq, want_seq)
        assert hit.any()
