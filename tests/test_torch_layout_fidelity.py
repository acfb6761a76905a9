"""Model-level fidelity of the port's lossy layouts, rebuilt without a
vocabulary file: the JAX package's tests/test_layout_fidelity.py needs the
reference's ggml-vocab-llama.gguf fixture, which is absent here.

As that test does (:32-73), a tiny llama of its widths is trained with the
JAX package's own tools/finetune.train on dense_params, here on a repeating
token stream: the test's corpus tokenized by a synthetic SPM vocabulary of
the fixture's 32000 tokens (testmodel.synthetic_spm_vocab, written into
the model file). The trained weights are written as Q4_K where K is a
multiple of 256 (at these widths ffn_down alone, as in the JAX test; the
rest stays f32) and loaded by the port on the CPU under the exact k_major
layout and the approximate i8g and i4g. The JAX test's own
budgets hold: perplexity ratio against k_major <= 1.005 (i8g) and <= 1.02
(i4g), top-1 agreement >= 0.99."""

import numpy as np
import pytest
import torch

from pipeinfer_tpu.models import load_model as j_load
from pipeinfer_tpu.tools.finetune import dense_params, train
from pipeinfer_tpu_torch.gguf.constants import GGMLQuantType
from pipeinfer_tpu_torch.gguf.reader import GGUFReader
from pipeinfer_tpu_torch.models import load_model
from pipeinfer_tpu_torch.runtime.context import Batch, InferenceContext
from pipeinfer_tpu_torch.tokenizer import tokenizer_from_gguf
from pipeinfer_tpu_torch.tools import testmodel

torch.set_num_threads(1)  # several test processes share the machine

CORPUS = (
    "the quick brown fox jumps over the lazy dog and then "
    "the quick brown fox jumps over the lazy dog again because "
) * 30
# tests/test_layout_fidelity.py's widths; the fixture's vocabulary size
CFG = dict(n_layers=2, n_embd=128, n_heads=4, n_kv_heads=4, n_ff=256, n_vocab=32000)


@pytest.fixture(scope="module")
def trained_q4k(tmp_path_factory):
    return _trained(tmp_path_factory.mktemp("torch_fidelity"), CFG)


def _trained(d, cfg_kw):
    """(Q4_K model trained on CORPUS, its first 96 stream tokens)."""
    vocab = testmodel.synthetic_spm_vocab(cfg_kw["n_vocab"], seed=0)
    init = d / "init.gguf"
    testmodel.write_llama_gguf(init, testmodel.random_llama_weights(
        np.random.default_rng(1), **cfg_kw), **cfg_kw, extra_kv=vocab)
    with GGUFReader(init) as r:
        tok = tokenizer_from_gguf(r)
    stream = np.asarray(tok.encode(CORPUS, add_bos=True), np.int32)
    params, cfg = j_load(init)
    params = dense_params(params)
    params, losses = train(
        params, cfg, stream, seq_len=48, batch=4, steps=220, lr=6e-3,
        log=lambda s: None, seed=1,
    )
    assert losses[-1] < 1.0, losses[-1]
    w = {
        "tok_embd": np.asarray(params["tok_embd"], np.float32),
        "output_norm": np.asarray(params["output_norm"], np.float32),
        "output": np.asarray(params["output"], np.float32),
    }
    for i, lp in enumerate(params["layers"]):
        for slot, arr in lp.items():
            w[f"layers.{i}.{slot}"] = np.asarray(arr, np.float32)
    q = d / "q.gguf"
    testmodel.write_llama_gguf(q, w, **cfg_kw, qtype=GGMLQuantType.Q4_K, extra_kv=vocab)
    return q, stream[:96]


def _logits(path, layout, toks, monkeypatch):
    monkeypatch.setenv("PIPEINFER_WEIGHT_LAYOUT", layout)
    params, cfg = load_model(path, device="cpu")
    monkeypatch.delenv("PIPEINFER_WEIGHT_LAYOUT")
    assert params["layers"][0]["w_down"].layout == layout  # the one K % 256 tensor
    ctx = InferenceContext(params, cfg, n_cells=128, cache_dtype=torch.float32, device="cpu")
    b = Batch()
    for i, t in enumerate(toks):
        b.add(int(t), i, 0)
    return np.asarray(ctx.decode(b))


def _ce(logits, nxt):
    z = logits - logits.max(-1, keepdims=True)
    lp = z - np.log(np.exp(z).sum(-1, keepdims=True))
    return float(-lp[np.arange(len(nxt)), nxt].mean())


@pytest.mark.parametrize("layout,ppl_budget", [("i8g", 1.005), ("i4g", 1.02)])
def test_layout_perplexity_parity(trained_q4k, layout, ppl_budget, monkeypatch):
    path, toks = trained_q4k
    exact = _logits(path, "k_major", toks, monkeypatch)
    got = _logits(path, layout, toks, monkeypatch)
    nxt = toks[1:]
    ce_exact = _ce(exact[:-1], nxt)
    ce_got = _ce(got[:-1], nxt)
    ppl_ratio = float(np.exp(ce_got - ce_exact))
    top1 = float((exact.argmax(-1) == got.argmax(-1)).mean())
    print(f"{layout}: ppl ratio {ppl_ratio:.4f} (budget {ppl_budget}), "
          f"top-1 agreement {top1:.4f}")
    assert ppl_ratio <= ppl_budget, (layout, ppl_ratio)
    assert top1 >= 0.99, (layout, top1)


# every tensor Q4_K: the same recipe at n_embd 256 and n_ff 512 (K % 256 ==
# 0 everywhere, the head included), over a 512-token synthetic vocabulary
FULL = dict(n_layers=2, n_embd=256, n_heads=4, n_kv_heads=4, n_ff=512, n_vocab=512)


def _jax_logits(path, layout, toks, monkeypatch):
    import jax.numpy as jnp

    from pipeinfer_tpu.runtime.context import Batch as JBatch
    from pipeinfer_tpu.runtime.context import InferenceContext as JContext

    monkeypatch.setenv("PIPEINFER_WEIGHT_LAYOUT", layout)
    params, cfg = j_load(path)
    monkeypatch.delenv("PIPEINFER_WEIGHT_LAYOUT")
    ctx = JContext(params, cfg, n_cells=128, cache_dtype=jnp.float32)
    b = JBatch()
    for i, t in enumerate(toks):
        b.add(int(t), i, 0)
    return np.asarray(ctx.decode(b))


@pytest.fixture(scope="module")
def trained_full_q4k(tmp_path_factory):
    return _trained(tmp_path_factory.mktemp("torch_fidelity_full"), FULL)


@pytest.mark.parametrize("layout", ["i8g", "i4g"])
def test_full_quantization_loses_what_the_jax_layout_loses(trained_full_q4k, layout,
                                                           monkeypatch):
    """With every tensor Q4_K the i4g layout flips top-1 on some rows, in
    the JAX package as in the port: the port's agreement with its k_major
    equals the JAX package's with its own, and the port's perplexity ratio
    stays within the layout's budget."""
    path, toks = trained_full_q4k
    nxt = toks[1:]
    out = {}
    for pkg, logits in (("port", _logits), ("jax", _jax_logits)):
        exact = logits(path, "k_major", toks, monkeypatch)
        got = logits(path, layout, toks, monkeypatch)
        out[pkg] = (float(np.exp(_ce(got[:-1], nxt) - _ce(exact[:-1], nxt))),
                    float((exact.argmax(-1) == got.argmax(-1)).mean()))
    print(f"{layout}, every tensor Q4_K: (ppl ratio, top-1 agreement) port {out['port']}, "
          f"JAX {out['jax']}")
    assert out["port"][1] == out["jax"][1]
    assert out["port"][0] <= {"i8g": 1.005, "i4g": 1.02}[layout]
