"""The live-model check's bar against what it must let through and what it
must catch, on the CPU at unit-test widths (the mpt_nano live model: 2
layers, n_embd 256, 2 heads of 128, ALiBi max bias 8).

tools/live_check.LIVE_RTOL bounds the card-against-CPU spread of the live
model's logits in chip_smoke.py. Here another f32 summation order
(every quantized matmul's output moved by 3e-7 relative) must stay well
inside it, and each of live_check.FAULTS (cells dropped, positions read
one cell off, ALiBi slopes one head off) must land outside it.

The tools' bars (LIVE_PPL_RTOL, LIVE_EMBED_ATOL) bound the card-against-
CPU spread of a live llama's perplexity and embedding: here, on the
nano bench target's live llama, another f32 order stays inside them and
each of live_check.MASK_FAULTS moves the embedding past its bar."""

import numpy as np
import pytest
import torch

from pipeinfer_tpu_torch.models import load_model
from pipeinfer_tpu_torch.tools import live_check as LC
from pipeinfer_tpu_torch.tools import testmodel


@pytest.fixture(scope="module")
def live(tmp_path_factory):
    d = tmp_path_factory.mktemp("live_check")
    testmodel.build_mpt_bench_pair(d / "t.gguf", d / "d.gguf", scale="mpt_nano", seed=42,
                                   live_path=d / "live.gguf")
    params, cfg = load_model(d / "live.gguf", device="cpu")
    toks = LC.live_tokens(cfg.n_vocab, 42)
    return params, cfg, toks, LC.run_live(params, cfg, toks, torch.device("cpu"))


def test_another_f32_order_stays_inside_the_bar(live):
    """At most a tenth of the bar: the card's kernels sum in other orders."""
    params, cfg, toks, want = live
    assert want.shape == (LC.PREFILL + LC.STEPS, cfg.n_vocab) and np.isfinite(want).all()
    with LC.perturbed_matmuls(3e-7):
        got = LC.run_live(params, cfg, toks, torch.device("cpu"))
    assert 0 < LC.spread(got, want) <= LC.LIVE_RTOL / 10


@pytest.mark.parametrize("name", list(LC.FAULTS))
def test_each_fault_fails_the_bar(live, name):
    params, cfg, toks, want = live
    with LC.fault(name):
        got = LC.run_live(params, cfg, toks, torch.device("cpu"))
    assert LC.spread(got, want) > LC.LIVE_RTOL


def test_fault_routes_single_token_steps_through_the_cell_kernel(live, monkeypatch):
    """Under a fault the single-token steps reach the kernel's wrapper (its
    plain version here), so the fault sits where the card's kernel reads
    its inputs; with the fault a no-op the logits equal the plain run's."""
    params, cfg, toks, want = live
    calls = []
    monkeypatch.setitem(LC.FAULTS, "none", lambda pos, tok_pos, alibi: (calls.append(1) or pos,
                                                                          alibi))
    with LC.fault("none"):
        got = LC.run_live(params, cfg, toks, torch.device("cpu"))
    assert len(calls) == LC.STEPS * cfg.n_layers
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.fixture(scope="module")
def live_llama(tmp_path_factory):
    """The tools' live llama (testmodel.build_llama_live) of the nano bench
    target's widths, its tokenizer, text of 2 perplexity windows of 128
    drawn from the synthetic vocabulary, and the plain CPU run's
    perplexity and 13-token embedding."""
    from pipeinfer_tpu_torch.gguf.reader import GGUFReader
    from pipeinfer_tpu_torch.tokenizer import tokenizer_from_gguf

    d = tmp_path_factory.mktemp("live_llama")
    testmodel.build_bench_pair(d / "t.gguf", d / "d.gguf", scale="nano", eps=0.02, vocab=True)
    path = testmodel.build_llama_live(d / "live.gguf", d / "t.gguf")
    params, cfg = load_model(path, device="cpu")
    with GGUFReader(path) as r:
        tok = tokenizer_from_gguf(r)
    rng = np.random.default_rng(5)
    text = tok.decode(rng.integers(259, cfg.n_vocab, 2 * 128 + 64).tolist())
    ids = tok.encode(text, add_bos=True)[:13]
    return params, cfg, tok, text, ids, _tools_run(params, cfg, tok, text, ids)


def _tools_run(params, cfg, tok, text, ids):
    from pipeinfer_tpu_torch.runtime.context import InferenceContext
    from pipeinfer_tpu_torch.tools.embedding import embed_text
    from pipeinfer_tpu_torch.tools.perplexity import perplexity

    ctx = InferenceContext(params, cfg, n_cells=136, device="cpu")
    return perplexity(ctx, tok, text, n_ctx=128)[0], embed_text(params, cfg, ids)


def test_live_llama_is_live(live_llama):
    """attn_output and ffn_down are non-zero (attention reaches the
    output), the layers are the bench target's widths, its head is the
    target's, and the two windows score 2 * 63 tokens."""
    params, cfg, tok, text, ids, (ppl, emb) = live_llama
    assert cfg.n_layers == testmodel.LLAMA_LIVE_LAYERS and cfg.n_embd == 256
    from pipeinfer_tpu_torch.ops.qmatmul import dequant

    for slot in ("wo", "w_down"):
        assert float(dequant(params["layers"][0][slot]).abs().max()) > 0
    assert np.isfinite(ppl) and ppl > 1 and abs(float(np.linalg.norm(emb)) - 1) < 1e-5


def test_tools_f32_order_stays_inside_the_bars(live_llama):
    """Another f32 order (every quantized matmul moved by 3e-7) moves the
    perplexity by under a quarter of LIVE_PPL_RTOL and the embedding by
    under a tenth of LIVE_EMBED_ATOL."""
    params, cfg, tok, text, ids, (ppl, emb) = live_llama
    with LC.perturbed_matmuls(3e-7):
        ppl2, emb2 = _tools_run(params, cfg, tok, text, ids)
    assert abs(ppl2 / ppl - 1) <= LC.LIVE_PPL_RTOL / 4
    assert np.abs(emb2 - emb).max() <= LC.LIVE_EMBED_ATOL / 10


@pytest.mark.parametrize("name", list(LC.MASK_FAULTS))
def test_each_mask_fault_fails_the_embedding_bar(live_llama, name):
    """Each mask fault moves the embedding past LIVE_EMBED_ATOL and the
    perplexity at all (at 7B width on the card chip_smoke.py also holds
    each past LIVE_PPL_RTOL), and the real mask is back after it."""
    from pipeinfer_tpu_torch.runtime import kv_cache as kv

    params, cfg, tok, text, ids, (ppl, emb) = live_llama
    real = kv.attn_mask
    with LC.mask_fault(name):
        ppl2, emb2 = _tools_run(params, cfg, tok, text, ids)
    assert kv.attn_mask is real
    assert np.abs(emb2 - emb).max() > LC.LIVE_EMBED_ATOL
    assert abs(ppl2 / ppl - 1) > 1e-4
