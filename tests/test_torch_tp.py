"""The port's tensor parallelism (parallel/tp.py, parallel/mesh.py) on the
CPU, mirroring the JAX package's tests/test_tp.py and the TP tests of
tests/test_stages.py: InferenceContext(mesh=...) and StagedInferenceContext
(tp=2) against the port's one-device context and against the JAX
package's TP contexts on its virtual CPU devices, the shard planes byte
for byte against the JAX package's _stack_qt / _stack_qt_segs in every
N-last layout, the controller over a TP target, the seq ops on every
shard's slab, and the four device-engine gates refusing a mesh context.

The port's mesh repeats one CPU device (["cpu"] * n), as one card holds
several shards in chip_smoke.py. Tolerances:
- port TP against port one-device: 1e-5 of max|logit| (the same f32 and
  kernel arithmetic per output column; only the collectives' copies lie
  between), greedy streams identical;
- port against the JAX package: test_torch_stages.py's bar for f32
  models (2e-4 rtol and atol: f32 steps, summation order) and
  test_torch_slice.py's for quantized ones (atol 1e-4 on carried planes:
  the integer dots are exact, the rest is f32 order)."""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pipeinfer_tpu.models.llama as j_llama
from pipeinfer_tpu.gguf.constants import GGMLQuantType as JQ
from pipeinfer_tpu.models import load_model as j_load
from pipeinfer_tpu.models.loader import fuse_projections as j_fuse
from pipeinfer_tpu.ops.qmatmul import QuantTensor as JQuantTensor
from pipeinfer_tpu.ops.qmatmul import qmatmul as j_qmatmul
from pipeinfer_tpu.parallel import tp as jtp
from pipeinfer_tpu.parallel.stages import StagedInferenceContext as JStaged
from pipeinfer_tpu.runtime import kv_cache as jkv
from pipeinfer_tpu.runtime.context import Batch as JBatch
from pipeinfer_tpu.runtime.context import InferenceContext as JContext
from pipeinfer_tpu_torch.models import ModelConfig, load_model, params_from_numpy
from pipeinfer_tpu_torch.ops.qmatmul import QuantTensor
from pipeinfer_tpu_torch.parallel import tp
from pipeinfer_tpu_torch.parallel.stages import StagedInferenceContext
from pipeinfer_tpu_torch.runtime import kv_cache as tkv
from pipeinfer_tpu_torch.runtime.context import Batch, InferenceContext
from pipeinfer_tpu_torch.sampling.samplers import SamplerState, SamplingParams, sample
from pipeinfer_tpu_torch.spec.controller import PipeInferController
from pipeinfer_tpu_torch.spec.params import SpecParams
from pipeinfer_tpu_torch.tools import testmodel

torch.set_num_threads(1)  # several test processes share the machine

# tests/test_tp.py's model and prompt
CFG = dict(n_layers=2, n_embd=128, n_heads=4, n_kv_heads=2, n_ff=256, n_vocab=160)
QCFG = dict(CFG, n_embd=256, n_ff=512)  # Q4_K needs K % 256 == 0
PROMPT = [3, 17, 42, 7]
F32 = torch.float32
SELF_RTOL = 1e-5  # port TP against port one-device, of max|logit|
JAX_TOL = {"f32": dict(rtol=2e-4, atol=2e-4), "q4k": dict(rtol=0, atol=1e-4)}
LAYOUTS = ("k_major", "i8", "i8g", "i4g", "k4")


def _mesh(n=2):
    return tp.tp_mesh(["cpu"] * n)


def _jmesh(n=2):
    return jtp.tp_mesh(jax.devices()[:n])


@pytest.fixture(scope="module")
def gguf_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("torch_tp")


@pytest.fixture(scope="module", params=["f32", "q4k"])
def model(request, gguf_dir):
    """(kind, path, port params and config): k_major planes for Q4_K on
    the CPU in both packages."""
    path = gguf_dir / f"m_{request.param}.gguf"
    if request.param == "f32":
        testmodel.build_tiny_llama(path, seed=13, **CFG)
    else:
        testmodel.build_tiny_llama(path, seed=13, qtype=JQ.Q4_K, **QCFG)
    return request.param, path, load_model(path, device="cpu")


def _ctx(m, n_cells=64, **kw):
    if "mesh" not in kw:
        kw["device"] = "cpu"
    return InferenceContext(*m, n_cells=n_cells, cache_dtype=F32, **kw)


def _prompt_batch(cls=Batch):
    b = cls()
    for i, t in enumerate(PROMPT):
        b.add(t, i, 0)
    return b


def _greedy(ctx, n=12):
    sampler = SamplerState(params=SamplingParams(temp=0.0))
    for t in PROMPT:
        sampler.accept(t, apply_grammar=False)
    b = Batch()
    for i, t in enumerate(PROMPT):
        b.add(t, i, 0, want_logits=(i == len(PROMPT) - 1))
    logits = ctx.decode(b)[-1]
    out, n_past = [], len(PROMPT)
    for _ in range(n):
        tok = sample(sampler, logits)
        sampler.accept(tok)
        out.append(tok)
        b.clear()
        b.add(tok, n_past, 0)
        logits = ctx.decode(b)[0]
        n_past += 1
    return out


def _close_to_self(got, want):
    np.testing.assert_allclose(got, want, atol=SELF_RTOL * np.abs(want).max(), rtol=0)


def test_tp_logits_parity(model):
    kind, path, m = model
    want = _ctx(m).decode(_prompt_batch())
    got = _ctx(m, mesh=_mesh()).decode(_prompt_batch())
    _close_to_self(got, want)
    jp, jc = j_load(path)
    jgot = JContext(jp, jc, n_cells=64, cache_dtype=jnp.float32, mesh=_jmesh()).decode(
        _prompt_batch(JBatch))
    np.testing.assert_allclose(got, np.asarray(jgot), **JAX_TOL[kind])


def test_tp_greedy_token_exact(model):
    _, _, m = model
    assert _greedy(_ctx(m, mesh=_mesh())) == _greedy(_ctx(m))


def test_tp_chain_parity(model):
    """The TP draft chain: greedy with candidates, bare greedy (n_cand 0)
    and the sampled chain from one seed give the one-device chain's."""
    _, _, m = model
    ref, tpc = _ctx(m), _ctx(m, mesh=_mesh())
    for ctx in (ref, tpc):
        ctx.decode(_prompt_batch())
    t_ref, c_ref = ref.draft_chain(5, len(PROMPT), 0, 4)
    t_tp, c_tp = tpc.draft_chain(5, len(PROMPT), 0, 4)
    assert t_ref == t_tp
    for a, b in zip(c_ref, c_tp):
        _close_to_self(b.vals, a.vals)
        assert list(a.ids) == list(b.ids)
    for ctx in (ref, tpc):
        ctx.seq_rm(0, len(PROMPT), -1)
    assert ref.draft_chain(5, len(PROMPT), 0, 4, n_cand=0) == \
        tpc.draft_chain(5, len(PROMPT), 0, 4, n_cand=0)
    for ctx in (ref, tpc):
        ctx.seq_rm(0, len(PROMPT), -1)
    samp = (0.8, 40, 0.95, 0.05)
    assert ref.draft_chain(5, len(PROMPT), 0, 4, samp=samp, seed=3)[0] == \
        tpc.draft_chain(5, len(PROMPT), 0, 4, samp=samp, seed=3)[0]


def test_tp_chain_matches_jax_tp_chain(model):
    kind, path, m = model
    tpc = _ctx(m, mesh=_mesh())
    jp, jc = j_load(path)
    jctx = JContext(jp, jc, n_cells=64, cache_dtype=jnp.float32, mesh=_jmesh())
    tpc.decode(_prompt_batch())
    jctx.decode(_prompt_batch(JBatch))
    t_tp, c_tp = tpc.draft_chain(5, len(PROMPT), 0, 4)
    t_j, c_j = jctx.draft_chain(5, len(PROMPT), 0, 4)
    assert t_tp == list(t_j)
    for a, b in zip(c_j, c_tp):
        np.testing.assert_allclose(b.vals, np.asarray(a.vals), **JAX_TOL[kind])


def test_controller_over_tp_target(model):
    """The PipeInfer controller over a TP target: host-verified (the
    corrected and fused runs refuse a mesh), token-exact against plain
    greedy on one device."""
    _, _, m = model
    want = _greedy(_ctx(m, 256), n=16)
    c = PipeInferController(
        _ctx(m, 256, mesh=_mesh()), _ctx(m, 256), SamplingParams(temp=0.0),
        SpecParams(n_draft=4, n_parallel=2, p_accept=0.0, max_inflight=3), eos_id=-1)
    assert not c.use_fused and not c.use_corrected
    got = c.generate(list(PROMPT), 16)
    assert got == want, f"TP-target async spec diverges: {got} vs {want}"
    assert c.stats.n_accept > 0


def test_tp_seq_ops_keep_every_shard_in_step(model):
    """Each seq op runs on every shard's slab: the replicated metadata of
    all shards stays equal to the one-device cache's, and the next decode
    still matches."""
    _, _, m = model
    ref, tpc = _ctx(m), _ctx(m, mesh=_mesh())
    for ctx in (ref, tpc):
        ctx.decode(_prompt_batch())
        ctx.seq_cp(0, 1, 0, 3)
        ctx.seq_rm(0, 2, 3)
        ctx.seq_shift(1, 1, -1, 2)
        ctx.seq_keep(1)
        ctx.rm_tail(4)
        b = Batch()
        b.add(9, 4, 1)
        b.add(11, 5, 1)
        ctx.decode(b)
    assert len(tpc.caches) == 2
    for c in tpc.caches:
        assert torch.equal(c.pos, ref.cache.pos) and torch.equal(c.seq, ref.cache.seq)
        assert c.hot == ref.cache.hot
    b = Batch()
    b.add(13, 6, 1)
    _close_to_self(tpc.decode(b), ref.decode(b))


def test_tp_precompile_and_placement(model):
    """precompile warms every shard (steps and a chain) and leaves the
    pool empty; each shard's planes are contiguous copies whose starts
    keep the kernels' 16-byte alignment, and the context names its mesh
    (a one-device context's mesh is None)."""
    _, _, m = model
    mesh = _mesh()
    tpc = _ctx(m, mesh=mesh)
    took = tpc.precompile(buckets=(1, 8), topk=8, chain_depths=(3,))
    assert set(took) == {"step[1,topk=8]", "step[8,topk=8]", "chain[3]"}
    assert (tpc.h_pos < 0).all() and all(int((c.pos >= 0).sum()) == 0 for c in tpc.caches)
    assert tpc.mesh is mesh and _ctx(m).mesh is None
    assert len(tpc.params) == 2
    for shard in tpc.params:
        for w in [shard["output"], *shard["layers"][0].values()]:
            planes = [getattr(w, f) for f in ("qs", "scales", "bias")] \
                if isinstance(w, QuantTensor) else [w]
            for p in planes:
                assert p.is_contiguous() and p.device.type == "cpu"
                assert p.numel() == 0 or p.data_ptr() % 16 == 0
    with pytest.raises(AttributeError, match="per shard"):
        tpc.cache


# -- packed-quantized TP: i4g/i8g planes shard along output columns ---------


def _load_layout(path, layout, monkeypatch):
    monkeypatch.setenv("PIPEINFER_WEIGHT_LAYOUT", layout)
    return j_load(path), load_model(path, device="cpu")


@pytest.fixture(scope="module")
def q4k_path(gguf_dir):
    """A vocabulary of 256: the JAX package's interpret-mode kernels,
    which the parity test runs, tile N by 128."""
    path = gguf_dir / "q4k_packed.gguf"
    testmodel.build_tiny_llama(path, seed=13, qtype=JQ.Q4_K, **dict(QCFG, n_vocab=256))
    return path


@pytest.mark.parametrize("layout", ["i4g", "i8g"])
def test_tp_packed_layout_stays_packed(q4k_path, layout, monkeypatch):
    _, (params, cfg) = _load_layout(q4k_path, layout, monkeypatch)
    shards, specs = tp.shard_params(params, cfg, _mesh())
    for i, shard in enumerate(shards):
        lp = shard["layers"][0]
        for slot in ("wq", "wo", "w_gate", "w_down"):
            w, full = lp[slot], params["layers"][0][slot]
            assert isinstance(w, QuantTensor) and w.layout == layout, f"{slot} densified"
            assert w.qs.dtype in (torch.uint8, torch.int8) and specs["layers"][0][slot]
            assert w.shape == (full.shape[0] // 2, full.shape[1])
            n = w.shape[0]
            assert torch.equal(w.qs, full.qs[:, i * n: (i + 1) * n])
    assert not specs["layers"][0]["attn_norm"] and not specs["tok_embd"]


def _to_numpy(params):
    """The JAX params with every array as numpy (what params_from_numpy
    takes), k4's second planes included."""
    def conv(x):
        if isinstance(x, JQuantTensor):
            return types.SimpleNamespace(
                **{f: None if getattr(x, f, None) is None else np.asarray(getattr(x, f))
                   for f in ("qs", "qh", "scales", "bias", "scales2", "bias2")},
                qtype=x.qtype, shape=x.shape, layout=x.layout)
        return np.asarray(x)

    out = {k: conv(v) for k, v in params.items() if k != "layers"}
    out["layers"] = [{k: conv(v) for k, v in lp.items()} for lp in params["layers"]]
    return out


def _carried(jm):
    """The JAX params and config carried into the port bit for bit."""
    jp, jc = jm
    cfg = ModelConfig(**{f: getattr(jc, f) for f in ModelConfig.__dataclass_fields__})
    return params_from_numpy(_to_numpy(jp), cfg, "cpu"), cfg


@pytest.mark.parametrize("layout", ["i4g", "i8g"])
def test_tp_packed_logits_parity(q4k_path, layout, monkeypatch):
    """TP decode from packed shards matches one-device decode with the
    same layout; and the TP step on the unpadded prompt matches the JAX
    package's forward on the same (carried) planes through its
    interpret-mode Pallas kernels, whose activation rounding the port's
    kernels and their plain versions share (one absmax scale per slab
    across all rows, so a context's padding rows take part). Those
    kernels give NaN inside the JAX package's shard_map on the CPU, so
    its reference is its eager one-device forward (as in
    test_torch_slice.py), which its tests/test_tp.py holds to its TP
    step."""
    (jp, jc), _ = _load_layout(q4k_path, layout, monkeypatch)
    params, cfg = m = _carried((jp, jc))
    mesh = _mesh()
    _close_to_self(_ctx(m, mesh=mesh).decode(_prompt_batch()), _ctx(m).decode(_prompt_batch()))
    t = len(PROMPT)
    arrs = (np.asarray(PROMPT, np.int32), np.arange(t, dtype=np.int32), np.zeros(t, np.int32),
            np.arange(t, dtype=np.int32), np.ones(t, bool))
    shards, _ = tp.shard_params(params, cfg, mesh)
    caches = tp.shard_cache(tkv.create(cfg.n_layers, 64, cfg.n_kv_heads, cfg.head_dim, F32,
                                       device="cpu"), mesh)
    got = tp.build_tp_step(cfg, None, mesh)(shards, caches,
                                            *(torch.from_numpy(a) for a in arrs), None)
    monkeypatch.setattr(j_llama, "qmatmul",
                        functools.partial(j_qmatmul, prefer_pallas=True, interpret=True))
    jgot, _ = j_llama.forward(jp, jc, jkv.create(jc.n_layers, 64, jc.n_kv_heads, jc.head_dim,
                                                 jnp.float32), *map(jnp.asarray, arrs))
    np.testing.assert_allclose(got.numpy(), np.asarray(jgot), **JAX_TOL["q4k"])


@pytest.mark.parametrize("layout", ["i4g", "i8g"])
def test_tp_packed_greedy_token_exact(q4k_path, layout, monkeypatch):
    _, m = _load_layout(q4k_path, layout, monkeypatch)
    assert _greedy(_ctx(m, mesh=_mesh())) == _greedy(_ctx(m))


def _planes_equal(port: QuantTensor, jax_qt, i: int):
    """Port shard i's planes against the JAX stacked planes' slice i, byte
    for byte."""
    for f in ("qs", "qh", "scales", "bias", "scales2", "bias2"):
        a, b = getattr(port, f), getattr(jax_qt, f, None)
        assert (a is None) == (b is None), f
        if a is not None:
            want = np.asarray(b)[i]
            assert a.is_contiguous() and a.shape == want.shape, (f, a.shape, want.shape)
            assert a.numpy().tobytes() == want.tobytes(), f


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("n_tp", [2, 4])
def test_shard_planes_match_jax_byte_for_byte(q4k_path, layout, n_tp, monkeypatch):
    """_stack_qt and _stack_qt_segs (fused wqkv and wgu) cut the JAX
    package's own planes, carried in bit for bit, into the JAX package's
    shards, in every N-last layout."""
    monkeypatch.setenv("PIPEINFER_WEIGHT_LAYOUT", layout)
    jp, jc = j_load(q4k_path)
    j_fuse(jp)
    tparams, tcfg = _carried((jp, jc))
    jlp, tlp = jp["layers"][0], tparams["layers"][0]
    assert {"wqkv", "wgu"} <= set(tlp) and tlp["wqkv"].layout == layout
    for slot in ("wqkv", "wgu", "wo", "w_down"):
        want, _ = jtp._shard_leaf(slot, jlp[slot], n_tp, jc)
        got, sharded = tp._shard_leaf(slot, tlp[slot], n_tp, tcfg)
        assert sharded and len(got) == n_tp
        for i, g in enumerate(got):
            assert g.shape == want.shape and g.layout == want.layout
            _planes_equal(g, want, i)
    want = jtp._stack_qt(jp["output"], n_tp)
    for i, g in enumerate(tp._stack_qt(tparams["output"], n_tp)):
        _planes_equal(g, want, i)


# -- TP inside pipeline stages ----------------------------------------------


@pytest.fixture(scope="module")
def model4(gguf_dir):
    path = gguf_dir / "m4.gguf"
    testmodel.build_tiny_llama(path, seed=7, **dict(CFG, n_layers=4))
    return path, load_model(path, device="cpu")


@pytest.fixture(scope="module")
def mpt(gguf_dir):
    """An MPT (ALiBi, fused qkv with clamp, LayerNorm, GELU) with heads
    that split two ways."""
    path = testmodel.build_tiny_arch(gguf_dir / "mpt4.gguf", "mpt", seed=11, n_layers=4,
                                     clamp_kqv=6.0)
    return path, load_model(path, device="cpu")


def _staged(m, n_cells=64, **kw):
    return StagedInferenceContext(*m, n_cells=n_cells, cache_dtype=F32, **kw)


@pytest.mark.parametrize("which", ["llama", "mpt"])
def test_staged_tp_decode_matches_single(model4, mpt, which):
    """2 stages x 2-way TP: tensor-sharded weights inside each pipeline
    stage, against one device and the JAX package's staged TP context;
    then single-token steps through the shard caches (the ALiBi slopes cut
    per shard on MPT)."""
    path, m = model4 if which == "llama" else mpt
    single = _ctx(m)
    stagedc = _staged(m, devices=["cpu"] * 4, tp=2)
    assert len(stagedc.groups) == 2 and all(len(g) == 2 for g in stagedc.groups)
    assert len(stagedc.caches) == 4
    got = stagedc.decode(_prompt_batch())
    _close_to_self(got, single.decode(_prompt_batch()))
    jp, jc = j_load(path)
    jstaged = JStaged(jp, jc, n_cells=64, devices=jax.devices()[:4], cache_dtype=jnp.float32,
                      tp=2)
    np.testing.assert_allclose(got, np.asarray(jstaged.decode(_prompt_batch(JBatch))),
                               **JAX_TOL["f32"])
    for i, t in enumerate([5, 9, 21]):
        b = Batch()
        b.add(t, len(PROMPT) + i, 0)
        _close_to_self(stagedc.decode(b), single.decode(b))


def test_controller_over_staged_tp(model4):
    """The async controller drives a 2-stage x 2-TP target, token-exact
    against one-device greedy decoding."""
    _, m = model4
    want = _greedy(_ctx(m, 256), n=16)
    c = PipeInferController(
        _staged(m, 256, devices=["cpu"] * 4, tp=2), _ctx(m, 256), SamplingParams(temp=0.0),
        SpecParams(n_draft=4, n_parallel=2, p_accept=0.0, max_inflight=3), eos_id=-1)
    got = c.generate(list(PROMPT), 16)
    assert got == want, f"staged+TP async spec diverges: {got} vs {want}"
    assert c.stats.n_accept > 0


def test_staged_tp_precompile_leaves_the_pipeline_clean(model4):
    _, m = model4
    stagedc = _staged(m, devices=["cpu"] * 4, tp=2)
    took = stagedc.precompile(buckets=(1, 8), topk=8)
    assert len(took) == 2 and (stagedc.h_pos < 0).all()
    assert all(int((c.pos >= 0).sum()) == 0 for c in stagedc.caches)
    _close_to_self(stagedc.decode(_prompt_batch()), _ctx(m).decode(_prompt_batch()))


def test_tp_refuses_what_does_not_split(model4):
    _, m = model4
    with pytest.raises(ValueError, match="not divisible by tp=8"):
        _ctx(m, mesh=_mesh(8))  # 4 heads
    with pytest.raises(ValueError, match="tp=2 sub-meshes"):
        _staged(m, devices=["cpu"] * 3, tp=2)


# -- the single-device gates ------------------------------------------------


GATES = ["corrected", "fused", "device_loop", "serving"]


@pytest.mark.parametrize("gate", GATES)
def test_device_engine_gates_refuse_a_mesh_context(model, gate):
    """The device-verified engines need one-device contexts (the JAX
    package's `mesh is None` gates): a TP target is verified on the host."""
    from pipeinfer_tpu_torch.serving.batching import SpecBatchScheduler
    from pipeinfer_tpu_torch.spec import corrected, device_loop, fused

    _, _, m = model
    tgt, dft = _ctx(m, 256, mesh=_mesh()), _ctx(m, 256)
    greedy = SamplingParams(temp=0.0, penalty_repeat=1.0, penalty_last_n=0)
    if gate in ("corrected", "fused"):
        sp = SpecParams(n_draft=4, n_parallel=1, p_accept=0.0, max_inflight=3)
        one = PipeInferController(_ctx(m, 256), dft, greedy, sp, eos_id=-1)
        assert (corrected if gate == "corrected" else fused).supported(one)
        c = PipeInferController(tgt, dft, greedy, sp, eos_id=-1)
        assert not (corrected if gate == "corrected" else fused).supported(c)
    elif gate == "device_loop":
        device_loop.check_engine_args("DeviceLoopEngine", _ctx(m, 256), dft, greedy, "x")
        with pytest.raises(ValueError, match="single-device contexts"):
            device_loop.check_engine_args("DeviceLoopEngine", tgt, dft, greedy, "x")
    else:
        assert SpecBatchScheduler(_ctx(m, 256), dft, device_lanes=4).devsrv is not None
        assert SpecBatchScheduler(tgt, dft, device_lanes=4).devsrv is None
