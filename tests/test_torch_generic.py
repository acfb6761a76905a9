"""The port's generic decoder (models/generic.py) against the JAX
package's, on the CPU: the nine non-llama architectures, Falcon-40B's
second attention norm and Baichuan-13B's switch to ALiBi, each a random
f32 GGUF (tools/testmodel.build_tiny_arch, made from a seed) loaded by
both packages. Prefill of 6 tokens, then 2 decode steps through the cell
cache; logits agree within 1e-4 of max|logit| (both sides compute in f32;
the measured gap is ~1e-6 of it, summation order). Plus one Q4_K model on
identical i4g planes (models/convert.params_from_numpy), ALiBi over a
cache with holes, and the loader's fusion guard for biased projections."""

import functools
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pipeinfer_tpu.models.llama as j_llama
from pipeinfer_tpu.models import load_model as j_load
from pipeinfer_tpu.models.loader import forward_for_arch as j_forward_for_arch
from pipeinfer_tpu.ops.qmatmul import QuantTensor as JQuantTensor
from pipeinfer_tpu.ops.qmatmul import qmatmul as j_qmatmul
from pipeinfer_tpu.runtime import kv_cache as jkv
from pipeinfer_tpu.runtime.context import Batch as JBatch
from pipeinfer_tpu.runtime.context import InferenceContext as JContext
from pipeinfer_tpu_torch.gguf.constants import GGMLQuantType
from pipeinfer_tpu_torch.models import ModelConfig, load_model, params_from_numpy
from pipeinfer_tpu_torch.models import generic, llama
from pipeinfer_tpu_torch.models.loader import forward_for_arch, fuse_projections
from pipeinfer_tpu_torch.runtime import kv_cache as tkv
from pipeinfer_tpu_torch.runtime.context import Batch, InferenceContext
from pipeinfer_tpu_torch.tools import testmodel

torch.set_num_threads(1)  # several test processes share the machine

STEPS = [[3, 17, 42, 7, 101, 55], [9], [200]]
RTOL = 1e-4  # of max|logit|
# (architecture, build_tiny_arch keywords): MQA, GQA and full heads, every
# norm, rope and FFN variant of config._ARCH_TRAITS
CASES = {
    "baichuan": ("baichuan", dict(n_kv_heads=2)),
    "baichuan13b_alibi": ("baichuan", dict(n_layers=40)),  # >= 40 layers: ALiBi, no rope
    "falcon": ("falcon", dict(n_kv_heads=1)),
    "falcon40b": ("falcon", dict(n_kv_heads=2, attn_norm_2=True)),
    "starcoder": ("starcoder", dict(n_kv_heads=1)),
    "persimmon": ("persimmon", {}),
    "refact": ("refact", dict(n_kv_heads=1)),
    "bloom": ("bloom", {}),
    "mpt": ("mpt", dict(clamp_kqv=6.0)),
    "stablelm": ("stablelm", {}),
    "gptneox": ("gptneox", {}),
}


@pytest.fixture(scope="module")
def gguf_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("torch_generic")


def _steps_both(jparams, jcfg, tparams, tcfg, steps, n_cells=32):
    """The same token steps through both packages' forwards on position-
    ordered cells; returns [(jax logits, port logits)]."""
    jf, tf = j_forward_for_arch(jcfg.arch), forward_for_arch(tcfg.arch)
    jcache = jkv.create(jcfg.n_layers, n_cells, jcfg.n_kv_heads, jcfg.head_dim, jnp.float32)
    tcache = tkv.create(tcfg.n_layers, n_cells, tcfg.n_kv_heads, tcfg.head_dim, torch.float32,
                        device="cpu")
    out, n = [], 0
    for toks in steps:
        t = len(toks)
        arrs = (np.asarray(toks, np.int32), np.arange(n, n + t, dtype=np.int32),
                np.zeros(t, np.int32), np.arange(n, n + t, dtype=np.int32), np.ones(t, bool))
        jl, jcache = jf(jparams, jcfg, jcache, *map(jnp.asarray, arrs))
        tl, _ = tf(tparams, tcfg, tcache, *(torch.from_numpy(a.copy()) for a in arrs))
        out.append((np.asarray(jl), tl.numpy()))
        n += t
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_architecture_logits_match_jax(gguf_dir, case):
    arch, kw = CASES[case]
    path = testmodel.build_tiny_arch(gguf_dir / f"{case}.gguf", arch, seed=11, **kw)
    jparams, jcfg = j_load(path)
    tparams, tcfg = load_model(path, device="cpu")
    assert tcfg == ModelConfig(**{f: getattr(jcfg, f) for f in ModelConfig.__dataclass_fields__})
    assert (forward_for_arch(arch) is generic.forward) == (arch != "llama")
    assert sorted(tparams["layers"][0]) == sorted(jparams["layers"][0])
    for jl, tl in _steps_both(jparams, jcfg, tparams, tcfg, STEPS):
        assert np.isfinite(tl).all() and np.abs(jl).max() > 0.1
        np.testing.assert_allclose(tl, jl, atol=RTOL * np.abs(jl).max(), rtol=0)
    if case == "baichuan13b_alibi":
        assert tcfg.rope_mode == "none" and tcfg.max_alibi_bias == 8.0


def _to_numpy(params):
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


def test_q4k_mpt_matches_jax_on_carried_planes(gguf_dir, monkeypatch):
    """A Q4_K MPT (ALiBi, LayerNorm, fused qkv, GELU) on identical i4g
    planes: the JAX side through its interpret-mode Pallas kernels, the
    port through its kernels' plain versions, at test_torch_slice.py's bar
    (atol 1e-4: the integer dots are exact, the rest is f32 order)."""
    path = testmodel.build_tiny_arch(gguf_dir / "mpt_q4k.gguf", "mpt", seed=3, n_embd=256,
                                     n_heads=4, n_ff=512, n_vocab=512, qtype=GGMLQuantType.Q4_K)
    monkeypatch.setenv("PIPEINFER_WEIGHT_LAYOUT", "i4g")
    jparams, jcfg = j_load(path)
    assert jparams["layers"][0]["wqkv"].layout == "i4g"
    monkeypatch.setattr(j_llama, "qmatmul",
                        functools.partial(j_qmatmul, prefer_pallas=True, interpret=True))
    tcfg = ModelConfig(**{f: getattr(jcfg, f) for f in ModelConfig.__dataclass_fields__})
    tparams = params_from_numpy(_to_numpy(jparams), tcfg, "cpu")
    for jl, tl in _steps_both(jparams, jcfg, tparams, tcfg, STEPS):
        assert np.abs(jl).max() > 0.1
        np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=0)


@pytest.mark.parametrize("arch", ["mpt", "bloom", "refact"])
def test_alibi_over_a_cache_with_holes_matches_jax(gguf_dir, arch):
    """ALiBi biases by cell position: after seq_rm frees cells in the middle
    of the prompt (holes in the pool) a 9-token step (T = 9, padded to 32)
    and single-token steps (T = 1) through both packages' contexts give
    the same logits; a 512-cell pool, where the JAX package's dispatch
    would take its flash kernel for T = 1 on a TPU."""
    path = testmodel.build_tiny_arch(gguf_dir / f"holes_{arch}.gguf", arch, seed=13,
                                     n_kv_heads=1 if arch == "refact" else 4)
    jm, tm = j_load(path), load_model(path, device="cpu")
    jc = JContext(*jm, n_cells=512, cache_dtype=jnp.float32)
    tc = InferenceContext(*tm, n_cells=512, cache_dtype=torch.float32, device="cpu")
    prompt = [5, 9, 13, 17, 21, 25, 29, 33, 37, 41, 45, 49]
    outs = []
    for ctx, batch in ((jc, JBatch), (tc, Batch)):
        got = []
        b = batch()
        for i, t in enumerate(prompt):
            b.add(t, i, 0)
        got.append(np.asarray(ctx.decode(b)))
        ctx.seq_rm(0, 3, 7)  # free the cells of positions 3..6
        b = batch()
        for i in range(9):  # a 9-token step after the gap, into the freed cells first
            b.add(60 + i, len(prompt) + i, 0)
        got.append(np.asarray(ctx.decode(b)))
        for j in range(3):
            b = batch()
            b.add(100 + j, len(prompt) + 9 + j, 0)
            got.append(np.asarray(ctx.decode(b)))
        outs.append(got)
    assert tc.h_pos[3:7].tolist() == list(range(12, 16))  # the step reused the holes
    for jl, tl in zip(*outs):
        np.testing.assert_allclose(tl, jl, atol=RTOL * np.abs(jl).max(), rtol=0)


def test_fusion_keeps_biased_projections_split(gguf_dir):
    """fuse_projections must not fuse wq/wk/wv where bq/bk/bv exist (the
    fused slot has no bias): a StableLM layer with q/k/v biases keeps its
    split projections (its bias-free gate and up still fuse) and the
    logits of the unfused forward; a bias-free Baichuan layer fuses both
    groups, to the same logits."""
    for arch, fuses in (("stablelm", False), ("baichuan", True)):
        path = testmodel.build_tiny_arch(gguf_dir / f"fuse_{arch}.gguf", arch, seed=17)
        params, cfg = load_model(path, device="cpu", fuse=False)
        fused, _ = load_model(path, device="cpu", fuse=False)
        fuse_projections(fused)
        assert ("wqkv" in fused["layers"][0]) == fuses
        assert "wgu" in fused["layers"][0]  # no gate/up biases: that group fuses
        if not fuses:
            assert {"bq", "bk", "bv", "wq", "wk", "wv"} <= set(fused["layers"][0])
        outs = []
        for p in (params, fused):
            cache = tkv.create(cfg.n_layers, 32, cfg.n_kv_heads, cfg.head_dim, torch.float32,
                               device="cpu")
            t = torch.tensor(STEPS[0], dtype=torch.int32)
            pos = torch.arange(len(t), dtype=torch.int32)
            logits, _ = generic.forward(p, cfg, cache, t, pos, torch.zeros_like(t), pos.clone(),
                                        torch.ones(len(t), dtype=torch.bool))
            outs.append(logits)
        torch.testing.assert_close(outs[1], outs[0], rtol=0, atol=1e-5 * float(outs[0].abs().max()))


def test_llama_keeps_its_fast_path():
    assert forward_for_arch("llama") is llama.forward


def test_mpt_bench_pair_streams_match_jax(gguf_dir):
    """tools.testmodel.build_mpt_bench_pair (here at its "mpt_nano" widths;
    chip_smoke.py builds "mpt7b"): LayerNorm on the zero-mean embedding
    rows keeps the head's margin, so both packages decode the same greedy
    stream from the target, the draft agrees on most tokens, and the live
    model's attention reaches its logits."""
    t, d, live = (gguf_dir / n for n in ("mpt_t.gguf", "mpt_d.gguf", "mpt_live.gguf"))
    testmodel.build_mpt_bench_pair(t, d, scale="mpt_nano", eps=0.05, live_path=live)
    prompt, n = [1, 40, 300, 7, 1999, 5], 32

    def greedy(ctx, batch):
        b = batch()
        for i, tok in enumerate(prompt):
            b.add(tok, i, 0, want_logits=(i == len(prompt) - 1))
        logits = ctx.decode(b)[-1]
        out = []
        for j in range(n):
            out.append(int(np.argmax(logits)))
            b = batch()
            b.add(out[-1], len(prompt) + j, 0)
            logits = ctx.decode(b)[0]
        return out, float(np.sort(logits)[-1] - np.sort(logits)[-2])

    tm, dm = load_model(t, device="cpu"), load_model(d, device="cpu")
    assert tm[1].arch == "mpt" and tm[1].max_alibi_bias == 8.0 and not tm[1].norm_rms
    want, margin = greedy(JContext(*j_load(t), n_cells=256), JBatch)
    got, _ = greedy(InferenceContext(*tm, n_cells=256, device="cpu"), Batch)
    assert got == want and margin > 1.0
    drafted, _ = greedy(InferenceContext(*dm, n_cells=256, device="cpu"), Batch)
    assert np.mean(np.asarray(drafted) == np.asarray(got)) > 0.5  # eps 0.05 of tokens differ
    lm = load_model(live, device="cpu")
    assert lm[1].n_layers == 2 and float(lm[0]["layers"][0]["wo"].scales.abs().max()) > 0
