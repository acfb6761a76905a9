"""The port's fused pp x tp x dp pipeline (parallel/pipefused.py) on the
CPU, mirroring the JAX package's tests/test_pipefused.py: the sharded step
reproduces the port's one-device forward within that test's bar (0.03 of
max|logit|: the step runs bf16 weights and activations and a bf16 ring
cache against an f32 reference) at every (pp, tp, dp) and (pp, mb) case
it runs, the ring wraps safely, and packed slots stay packed. Against the
JAX package's own fused step on the same file the port agrees within 2e-4
of max|logit| (the same bf16 roundings; f32 summation order only).

The port's mesh repeats one CPU device, as the JAX tests use 8 virtual
CPU devices."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pipeinfer_tpu.models import load_model as j_load
from pipeinfer_tpu.parallel import pipefused as jpf
from pipeinfer_tpu_torch.gguf.constants import GGMLQuantType
from pipeinfer_tpu_torch.models import llama as t_llama
from pipeinfer_tpu_torch.models import load_model
from pipeinfer_tpu_torch.ops.qmatmul import QuantTensor, dequant
from pipeinfer_tpu_torch.parallel import pipefused as pf
from pipeinfer_tpu_torch.runtime import kv_cache as tkv
from pipeinfer_tpu_torch.runtime.context import Batch, InferenceContext
from pipeinfer_tpu_torch.tools import testmodel

torch.set_num_threads(1)  # several test processes share the machine

CFG = dict(n_layers=4, n_embd=64, n_heads=4, n_kv_heads=2, n_ff=128, n_vocab=96)
QCFG = dict(n_layers=4, n_embd=256, n_heads=4, n_kv_heads=2, n_ff=512, n_vocab=256)
TOKENS = [3, 9, 21, 40]
BAR = 0.03  # tests/test_pipefused.py's, of max|logit|
JAX_RTOL = 2e-4  # of max|logit|, against the JAX package's fused step


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    p = tmp_path_factory.mktemp("torch_pf") / "m.gguf"
    testmodel.build_tiny_llama(p, seed=5, **CFG)
    return p


@pytest.fixture(scope="module")
def model(path):
    return load_model(path, device="cpu")


def _err(got, want) -> float:
    return float(np.abs(np.asarray(got) - np.asarray(want)).max() / (np.abs(want).max() + 1e-6))


def _reference_steps(params, cfg, steps, cache_dtype=torch.float32) -> list[np.ndarray]:
    """The port's one-device forward over token steps [T] at consecutive
    positions (on an f32 cache by default)."""
    cache = tkv.create(cfg.n_layers, 32, cfg.n_kv_heads, cfg.head_dim, cache_dtype,
                       device="cpu")
    out, n = [], 0
    for toks in steps:
        t = len(toks)
        ar = torch.arange(n, n + t, dtype=torch.int32)
        logits, _ = t_llama.forward(params, cfg, cache, torch.tensor(toks, dtype=torch.int32), ar,
                                    torch.zeros(t, dtype=torch.int32), ar,
                                    torch.ones(t, dtype=torch.bool))
        out.append(logits.numpy())
        n += t
    return out


def _port(m, pc, batch, max_len=16):
    params, cfg = m
    mesh = pf.make_mesh(pc, ["cpu"] * pc.n_devices)
    return (pf.stack_params(params, cfg, pc, mesh), pf.init_cache(cfg, pc, mesh, batch, max_len),
            pf.build_step(cfg, pc, mesh))


def _jax(path, pp, tp, dp, mb, batch, max_len=16):
    jp, jc = j_load(path)
    pc = jpf.PipeConfig(n_stages=pp, tp=tp, dp=dp, n_microbatches=mb)
    mesh = jpf.make_mesh(pc)
    return (jpf.stack_params(jp, jc, pc, mesh), jpf.init_cache(jc, pc, mesh, batch, max_len),
            jpf.build_step(jc, pc, mesh))


@pytest.mark.parametrize("pp,mb", [(4, 4), (2, 2), (4, 2)])
def test_microbatch_schedule_matches_single_device(path, model, pp, mb):
    """The (M + S - 1)-phase schedule: M microbatches flow through S
    stages, every stage on a different microbatch per phase; every stream
    matches the one-device forward, and the JAX package's step."""
    pc = pf.PipeConfig(n_stages=pp, tp=1, dp=1, n_microbatches=mb)
    stacked, cache, step = _port(model, pc, batch=mb)
    toks = np.random.default_rng(3).integers(1, CFG["n_vocab"], size=(mb, 4)).astype(np.int32)
    logits, cache = step(stacked, cache, toks, np.arange(4, dtype=np.int32), 0)
    assert logits.shape == (mb, 4, CFG["n_vocab"])
    for b in range(mb):
        (want,) = _reference_steps(*model, [list(toks[b])])
        assert _err(logits[b], want) < BAR, f"S={pp} M={mb} stream {b}"
    jst, jcache, jstep = _jax(path, pp, 1, 1, mb, batch=mb)
    jl, _ = jstep(jst, jcache, jnp.asarray(toks), jnp.arange(4, dtype=jnp.int32), 0)
    assert _err(logits, jl) < JAX_RTOL
    # a decode step on top of the filled caches (streams advance together)
    logits2, _ = step(stacked, cache, toks[:, :1] + 1, np.asarray([4], np.int32), 4)
    assert torch.isfinite(logits2).all()


def test_ring_wrap_positions(path, model):
    """Per-slot stored positions make the ring wrap-safe: decoding past
    max_len equals a one-device context that keeps only the last C
    positions (evicting progressively, as the ring does)."""
    params, cfg = model
    pc = pf.PipeConfig(n_stages=2, tp=1, dp=1)
    C = 8
    stacked, cache, step = _port(model, pc, batch=1, max_len=C)
    jst, jcache, jstep = _jax(path, 2, 1, 1, 1, batch=1, max_len=C)
    seq = np.random.default_rng(4).integers(1, CFG["n_vocab"], size=14).astype(np.int32)
    ctx = InferenceContext(params, cfg, n_cells=32, cache_dtype=torch.float32, device="cpu")
    for i, tok in enumerate(seq):
        logits, cache = step(stacked, cache, np.asarray([[tok]]), np.asarray([i], np.int32), i)
        jl, jcache = jstep(jst, jcache, jnp.asarray([[tok]]), jnp.asarray([i], jnp.int32), i)
        if i >= C:
            ctx.seq_rm(0, 0, i - C + 1)
        b = Batch()
        b.add(int(tok), i, 0)
        want = ctx.decode(b)[0]
    assert _err(logits[0, 0], want) < BAR, "ring wrap decode"
    assert _err(logits, jl) < JAX_RTOL


@pytest.mark.parametrize("pp,tp,dp", [(2, 2, 2), (4, 2, 1), (2, 1, 1), (1, 2, 1)])
def test_fused_pipeline_matches_single_device(path, model, pp, tp, dp):
    pc = pf.PipeConfig(n_stages=pp, tp=tp, dp=dp)
    stacked, cache, step = _port(model, pc, batch=dp)
    t = len(TOKENS)
    logits, cache = step(stacked, cache, np.tile(np.asarray(TOKENS, np.int32), (dp, 1)),
                         np.arange(t, dtype=np.int32), 0)
    want, want2 = _reference_steps(*model, [TOKENS, [7]])
    for b in range(dp):
        assert _err(logits[b], want) < BAR, f"pp={pp} tp={tp} dp={dp} stream {b}"
    # one more token through the pipeline
    logits2, cache = step(stacked, cache, np.full((dp, 1), 7, np.int32),
                          np.asarray([t], np.int32), t)
    assert _err(logits2[0], want2) < BAR, "decode step"
    jst, jcache, jstep = _jax(path, pp, tp, dp, 1, batch=dp)
    jl, jcache = jstep(jst, jcache, jnp.tile(jnp.asarray(TOKENS, jnp.int32)[None], (dp, 1)),
                       jnp.arange(t, dtype=jnp.int32), 0)
    jl2, _ = jstep(jst, jcache, jnp.full((dp, 1), 7, jnp.int32), jnp.asarray([t], jnp.int32), t)
    assert _err(logits, jl) < JAX_RTOL and _err(logits2, jl2) < JAX_RTOL


# -- packed-quantized pipefused ---------------------------------------------


@pytest.fixture(scope="module", params=["i4g", "i8g"])
def qmodel(request, tmp_path_factory):
    p = tmp_path_factory.mktemp("torch_pfq") / f"m_{request.param}.gguf"
    testmodel.build_tiny_llama(p, seed=7, qtype=GGMLQuantType.Q4_K, **QCFG)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PIPEINFER_WEIGHT_LAYOUT", request.param)
        return load_model(p, device="cpu"), request.param


def test_stack_params_keeps_quant_packed(qmodel):
    """Uniform-format quantized slots stay packed: every matmul slot (the
    head too) keeps its integer planes, narrowed to the shard's output
    columns, each a contiguous copy; the dense ones would be bf16."""
    (params, cfg), layout = qmodel
    pc = pf.PipeConfig(n_stages=2, tp=2, dp=1)
    mesh = pf.make_mesh(pc, ["cpu"] * 4)
    stacked = pf.stack_params(params, cfg, pc, mesh)
    assert len(stacked) == 4
    for c, tree in zip(mesh.local, stacked):
        m = mesh.index(c, "model")
        assert len(tree["layers"]) == 2  # this stage's Lps layers
        for slot in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
            w = tree["layers"][0][slot]
            assert isinstance(w, QuantTensor) and w.layout == layout, f"{slot} densified"
            assert w.qs.dtype in (torch.uint8, torch.int8) and w.qs.is_contiguous()
            full = params["layers"][0][slot]
            n = full.shape[0] // pc.tp
            assert w.shape == (n, full.shape[1])
            li = mesh.index(c, "stage") * 2
            assert torch.equal(w.qs, params["layers"][li][slot].qs[:, m * n: (m + 1) * n])
        assert isinstance(tree["output"], QuantTensor)
        assert tree["tok_embd"].dtype == torch.bfloat16


@pytest.mark.parametrize("pp,tp,dp", [(2, 2, 1), (2, 1, 1), (1, 2, 1)])
def test_packed_pipeline_matches_single_device_quant(qmodel, pp, tp, dp):
    """The packed pp x tp step reproduces the one-device quantized forward
    with the same layout under the step's own roundings (the bf16 token
    table and ring cache of the JAX package's design) within 1e-5 of
    max|logit|. Against the f32-table, f32-cache forward the JAX test's
    0.03 does not hold here: the kernels' shared activation scale carries
    the table's bf16 rounding into every matmul (4.4% on this model,
    0.038 from the cache alone), where the JAX package's CPU fallback
    rounds both sides alike."""
    (params, cfg), _ = qmodel
    pc = pf.PipeConfig(n_stages=pp, tp=tp, dp=dp)
    stacked, cache, step = _port((params, cfg), pc, batch=dp)
    logits, _ = step(stacked, cache, np.tile(np.asarray(TOKENS, np.int32), (dp, 1)),
                     np.arange(4, dtype=np.int32), 0)
    rounded = dict(params, tok_embd=dequant(params["tok_embd"], torch.bfloat16).float())
    (want,) = _reference_steps(rounded, cfg, [TOKENS], torch.bfloat16)
    for b in range(dp):
        assert _err(logits[b], want) < 1e-5, f"pp={pp} tp={tp} stream {b}"


def test_pipefused_refuses_a_non_llama_body(tmp_path):
    path = testmodel.build_tiny_arch(tmp_path / "mpt.gguf", "mpt", seed=1, n_layers=2)
    params, cfg = load_model(path, device="cpu")
    pc = pf.PipeConfig(n_stages=2, tp=1, dp=1)
    with pytest.raises(NotImplementedError, match="llama-family"):
        pf.stack_params(params, cfg, pc, pf.make_mesh(pc, ["cpu"] * 2))

