"""The port's LoRA path (tools/lora.py, tools/export_lora.py and the
load-time merge) against the JAX package's, on the CPU, without the
reference's vocabulary fixture that tests/test_lora.py reads: the same
tiny f32 llama (build_tiny_llama without vocab_from) through both.

- init_lora gives the JAX package's A and B bit for bit;
- train_lora's losses within 1e-4 relative at every step, and the loss
  falls below 0.9x its first value (tests/test_lora.py's bar);
- save_adapter writes the JAX package's bytes for the same factors;
- apply_lora then decoding gives the JAX package's logits within 1e-5 of
  max|logit| (f32 weights and cache on both sides; the merged delta and
  the products differ in summation order only);
- export_lora.merge_file writes the JAX package's file (sha256) and
  rejects a shape mismatch;
- an adapted (dense) slot stays split from its quantized group under
  fuse_projections, as in the JAX package;
- `tools.lora.main` runs end to end with --device cpu.
"""

import contextlib
import hashlib
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pipeinfer_tpu.models import load_model as j_load
from pipeinfer_tpu.models import loader as j_loader
from pipeinfer_tpu.runtime.context import Batch as JBatch
from pipeinfer_tpu.runtime.context import InferenceContext as JContext
from pipeinfer_tpu.tools import export_lora as j_export
from pipeinfer_tpu.tools import finetune as jft
from pipeinfer_tpu.tools import lora as jl
from pipeinfer_tpu_torch.gguf.constants import GGMLQuantType
from pipeinfer_tpu_torch.gguf.reader import GGUFReader
from pipeinfer_tpu_torch.models import load_model as t_load
from pipeinfer_tpu_torch.models import loader as t_loader
from pipeinfer_tpu_torch.ops.qmatmul import QuantTensor
from pipeinfer_tpu_torch.runtime.context import Batch, InferenceContext
from pipeinfer_tpu_torch.tools import export_lora as t_export
from pipeinfer_tpu_torch.tools import finetune as tft
from pipeinfer_tpu_torch.tools import lora as tl
from pipeinfer_tpu_torch.tools import testmodel

CFG = dict(n_layers=2, n_embd=64, n_heads=4, n_kv_heads=2, n_ff=128)
LOSS_RTOL = 1e-4
LOGIT_RTOL = 1e-5  # of max|logit|
QUIET = dict(log=lambda s: None)


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    path = tmp_path_factory.mktemp("torch_lora") / "m.gguf"
    testmodel.build_tiny_llama(path, seed=5, **CFG)
    return path


def _sha(path) -> str:
    return hashlib.sha256(open(path, "rb").read()).hexdigest()


def _t_logits(params, cfg, prompt=(1, 5, 9)):
    ctx = InferenceContext(params, cfg, n_cells=64, cache_dtype=torch.float32, device="cpu")
    b = Batch()
    for i, t in enumerate(prompt):
        b.add(t, i, 0, want_logits=(i == len(prompt) - 1))
    return np.asarray(ctx.decode(b)[-1])


def _j_logits(params, cfg, prompt=(1, 5, 9)):
    ctx = JContext(params, cfg, n_cells=64, cache_dtype=jnp.float32)
    b = JBatch()
    for i, t in enumerate(prompt):
        b.add(t, i, 0, want_logits=(i == len(prompt) - 1))
    return np.asarray(ctx.decode(b)[-1])


def _close(got, want, rtol=LOGIT_RTOL):
    assert np.abs(got - want).max() <= rtol * np.abs(want).max()


def _adapters(model, targets, b_value, seed):
    """The same factors in both packages' init_lora form, B set to b_value."""
    jp, _ = j_load(model)
    tp, _ = t_load(model, device="cpu")
    j_lora = jl.init_lora(jft.dense_params(jp), 4, targets, seed=seed)
    t_lora = tl.init_lora(tft.dense_params(tp), 4, targets, seed=seed)
    j_lora = [{s: (a, jnp.ones_like(b) * b_value) for s, (a, b) in e.items()} for e in j_lora]
    t_lora = [{s: (a, torch.ones_like(b) * b_value) for s, (a, b) in e.items()} for e in t_lora]
    return j_lora, t_lora


def test_init_lora_is_the_jax_packages(model):
    jp, _ = j_load(model)
    tp, _ = t_load(model, device="cpu")
    targets = ("wq", "wv", "w_down")
    want = jl.init_lora(jft.dense_params(jp), 8, targets, seed=3)
    got = tl.init_lora(tft.dense_params(tp), 8, targets, seed=3)
    assert [sorted(e) for e in got] == [sorted(e) for e in want] == [sorted(targets)] * 2
    for je, te in zip(want, got):
        for slot in targets:
            for jx, tx in zip(je[slot], te[slot]):
                assert tx.dtype == torch.float32
                np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))


def test_train_lora_matches_jax_and_reduces_loss(model):
    jp, jc = j_load(model)
    tp, tc = t_load(model, device="cpu")
    corpus = np.array(([4, 9, 2, 7, 1] * 40), np.int32)
    kw = dict(rank=4, alpha=8.0, seq_len=16, batch=2, steps=30, lr=5e-3, **QUIET)
    j_lora, j_losses = jl.train_lora(jft.dense_params(jp), jc, corpus, **kw)
    dense = tft.dense_params(tp)
    t_lora, t_losses = tl.train_lora(dense, tc, corpus, **kw)
    np.testing.assert_allclose(t_losses, j_losses, rtol=LOSS_RTOL, atol=0)
    assert t_losses[-1] < t_losses[0] * 0.9, f"loss did not drop: {t_losses[0]} -> {t_losses[-1]}"
    # only the factors learned: the base is untouched and took no gradient
    assert not any(x.requires_grad for x in tft.tree_leaves(dense))
    np.testing.assert_array_equal(dense["layers"][0]["wq"].numpy(),
                                  tft.dense_params(tp)["layers"][0]["wq"].numpy())
    for je, te in zip(j_lora, t_lora):
        for slot in te:
            for jx, tx in zip(je[slot], te[slot]):
                assert np.abs(tx.numpy() - np.asarray(jx)).max() <= 2 * 5e-3 * 30


def test_adapter_file_roundtrip_and_apply(model, tmp_path):
    j_lora, t_lora = _adapters(model, ("wq", "wo"), 0.01, seed=1)
    j_path, t_path = tmp_path / "j.gguf", tmp_path / "t.gguf"
    jl.save_adapter(j_path, j_lora, rank=4, alpha=8.0)
    tl.save_adapter(t_path, t_lora, rank=4, alpha=8.0)
    assert _sha(t_path) == _sha(j_path)

    alpha, rank, pairs = tl.load_adapter(t_path)
    assert (alpha, rank) == (8.0, 4)
    assert set(pairs) == {(i, s) for i in range(CFG["n_layers"]) for s in ("wq", "wo")}

    tp, tc = t_load(model, device="cpu")
    jp, jc = j_load(model)
    base = _t_logits(tp, tc)
    merged = tl.apply_lora(tp, t_path)
    got = _t_logits(merged, tc)
    assert not np.allclose(base, got), "adapter had no effect"
    _close(got, _j_logits(jl.apply_lora(jp, j_path), jc))
    _close(_t_logits(tl.apply_lora(tp, t_path, scale=0.5), tc),
           _j_logits(jl.apply_lora(jp, j_path, 0.5), jc))
    np.testing.assert_allclose(_t_logits(tl.apply_lora(tp, t_path, scale=0.0), tc), base,
                               atol=1e-5)
    # runtime merge == train-time merge
    train_merged = tl.merge_lora(tft.dense_params(tp), t_lora, alpha / rank)
    np.testing.assert_allclose(_t_logits(train_merged, tc), got, rtol=1e-4, atol=1e-4)


def test_export_lora_is_the_jax_packages_file(model, tmp_path):
    _, t_lora = _adapters(model, ("wq",), 0.02, seed=2)
    apath = tmp_path / "adapter.gguf"
    tl.save_adapter(apath, t_lora, rank=4, alpha=8.0)
    j_out, t_out = tmp_path / "j_merged.gguf", tmp_path / "t_merged.gguf"
    adapters = [(str(apath), 1.0), (str(apath), 0.5)]
    assert j_export.merge_file(str(model), str(j_out), adapters) == CFG["n_layers"]
    assert t_export.merge_file(str(model), str(t_out), adapters, device="cpu") == CFG["n_layers"]
    assert _sha(t_out) == _sha(j_out)

    tp, tc = t_load(model, device="cpu")
    want = _t_logits(tl.apply_lora(tl.apply_lora(tp, apath, 1.0), apath, 0.5), tc)
    mp, mc = t_load(t_out, device="cpu")
    np.testing.assert_allclose(_t_logits(mp, mc), want, rtol=1e-4, atol=1e-4)
    with GGUFReader(model) as rb, GGUFReader(t_out) as rm:
        assert bytes(rb.tensor_bytes("blk.0.ffn_up.weight")) == bytes(
            rm.tensor_bytes("blk.0.ffn_up.weight"))


def test_export_lora_main_and_shape_mismatch(model, tmp_path):
    bad = [{"wq": (torch.zeros((4, 32)), torch.zeros((32, 4)))}]  # wrong K/N
    apath = tmp_path / "bad.gguf"
    tl.save_adapter(apath, bad, rank=4, alpha=8.0)
    with pytest.raises(SystemExit, match="does not match"):
        t_export.merge_file(str(model), str(tmp_path / "o.gguf"), [(str(apath), 1.0)],
                            device="cpu")
    with pytest.raises(SystemExit, match="no adapters"):
        t_export.main(["-m", str(model), "-o", str(tmp_path / "o.gguf"), "--device", "cpu"])
    _, t_lora = _adapters(model, ("wo",), 0.01, seed=4)
    good = tmp_path / "good.gguf"
    tl.save_adapter(good, t_lora, rank=4, alpha=8.0)
    assert t_export.main(["-m", str(model), "-o", str(tmp_path / "m1.gguf"), "-s", str(good),
                          "0.5", "--device", "cpu"]) == 0
    j_export.main(["-m", str(model), "-o", str(tmp_path / "m2.gguf"), "-s", str(good), "0.5"])
    assert _sha(tmp_path / "m1.gguf") == _sha(tmp_path / "m2.gguf")


@pytest.mark.parametrize("targets", [("wq",), ("wq", "wk", "wv")])
def test_adapted_slots_and_fusion_match_jax(tmp_path, targets):
    """On a Q4_K model: the adapted slots turn dense f32, the others keep
    their quantized layout; fuse_projections leaves a dense wq beside
    quantized wk/wv split and fuses an all-dense q/k/v group, as the JAX
    package does; the logits match the JAX package's."""
    path = tmp_path / "q.gguf"
    testmodel.build_tiny_llama(path, seed=6, n_layers=2, n_embd=256, n_heads=4, n_kv_heads=2,
                               n_ff=512, qtype=GGMLQuantType.Q4_K)
    tp, tc = t_load(path, device="cpu", fuse=False)
    jp, jc = j_load(path, fuse=False)
    rng = np.random.default_rng(7)
    lora = [{s: (torch.from_numpy(rng.standard_normal((4, 256)).astype(np.float32) * 0.1),
                 torch.from_numpy(rng.standard_normal((tp["layers"][0][s].shape[0], 4))
                                  .astype(np.float32) * 0.1)) for s in targets}
            for _ in range(2)]
    apath = tmp_path / "a.gguf"
    tl.save_adapter(apath, lora, rank=4, alpha=4.0)
    t_adapted = tl.apply_lora(tp, apath)
    j_adapted = jl.apply_lora(jp, apath)
    lp = t_adapted["layers"][1]
    for s in targets:
        assert isinstance(lp[s], torch.Tensor) and lp[s].dtype == torch.float32
    assert isinstance(lp["w_up"], QuantTensor) and isinstance(tp["layers"][1]["wq"], QuantTensor)
    t_loader.fuse_projections(t_adapted)
    j_loader.fuse_projections(j_adapted)
    for tl_, jl_ in zip(t_adapted["layers"], j_adapted["layers"]):
        assert sorted(tl_) == sorted(jl_)
    fused = "wqkv" in t_adapted["layers"][0]
    assert fused == (len(targets) == 3) and "wgu" in t_adapted["layers"][0]
    _close(_t_logits(t_adapted, tc), _j_logits(j_adapted, jc), rtol=1e-4)


def _vocab_model(path, n_vocab=384, seed=4):
    rng = np.random.default_rng(seed)
    shape = dict(n_layers=2, n_embd=64, n_heads=4, n_kv_heads=4, n_ff=128, n_vocab=n_vocab)
    testmodel.write_llama_gguf(path, testmodel.random_llama_weights(rng, **shape), **shape,
                               extra_kv=testmodel.synthetic_spm_vocab(n_vocab, seed))
    return path


def test_lora_main_runs_and_matches_jax(tmp_path):
    model = _vocab_model(tmp_path / "m.gguf")
    words = testmodel.synthetic_spm_vocab(384)["tokenizer.ggml.tokens"][259:319]
    (tmp_path / "c.txt").write_text((" ".join(w.lstrip("▁") for w in words) + "\n") * 4)
    argv = ["-m", str(model), "-f", str(tmp_path / "c.txt"), "--rank", "4", "--targets",
            "wq,wo,w_down", "--seq-len", "32", "--batch", "2", "--steps", "5", "--lr", "1e-2"]
    outs = []
    for entry, extra in ((jl.main, ["-o", str(tmp_path / "j.gguf")]),
                         (tl.main, ["-o", str(tmp_path / "t.gguf"), "--device", "cpu"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(io.StringIO()):
            assert entry(argv + extra) == 0
        outs.append(float(buf.getvalue().split("final loss ")[1].split()[0]))
    assert outs[1] == pytest.approx(outs[0], rel=LOSS_RTOL, abs=1e-4)
    _, _, pairs = tl.load_adapter(tmp_path / "t.gguf")
    assert set(pairs) == {(i, s) for i in range(2) for s in ("wq", "wo", "w_down")}
    with pytest.raises(SystemExit, match="unknown target"):
        tl.main(argv[:6] + ["--targets", "wq,bogus", "-o", str(tmp_path / "x.gguf"),
                            "--device", "cpu"])


