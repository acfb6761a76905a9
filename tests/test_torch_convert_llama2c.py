"""The port's llama2.c converter (tools/convert_llama2c.py), mirroring the
JAX package's tests/test_convert_llama2c.py without its case that reads a
vocabulary fixture from outside the repo: a synthetic llama2.c .bin
converts, in both packages, to byte-identical GGUF files whose logits on
the port's runtime equal a directly written GGUF's; the shared classifier
and a tokenizer.bin vocabulary carry over."""

import struct

import numpy as np
import pytest
import torch

from pipeinfer_tpu.tools import convert_llama2c as j_convert_llama2c
from pipeinfer_tpu_torch.gguf.reader import GGUFReader
from pipeinfer_tpu_torch.models import load_model
from pipeinfer_tpu_torch.ops.qmatmul import QuantTensor, dequant
from pipeinfer_tpu_torch.runtime.context import Batch, InferenceContext
from pipeinfer_tpu_torch.tools import testmodel
from pipeinfer_tpu_torch.tools.convert_llama2c import convert, read_llama2c

torch.set_num_threads(1)  # several test processes share the machine

DIM, HID, L, H, KV, V, SEQ = 64, 128, 2, 4, 2, 256, 64


def _write_llama2c(path, w, *, shared=True):
    head = DIM // H
    with open(path, "wb") as f:
        f.write(struct.pack("<7i", DIM, HID, L, H, KV, V if shared else -V, SEQ))

        def put(a):
            f.write(np.ascontiguousarray(a, "<f4").tobytes())

        put(w["tok_embd"])
        for name in ("attn_norm", "wq", "wk", "wv", "wo", "ffn_norm", "w_gate", "w_down",
                     "w_up"):
            put(np.stack([w[f"layers.{i}.{name}"] for i in range(L)]))
        put(w["output_norm"])
        put(np.zeros((SEQ, head // 2), np.float32))  # legacy freq_cis
        put(np.zeros((SEQ, head // 2), np.float32))
        if not shared:
            put(w["output"])


@pytest.fixture(scope="module")
def weights():
    rng = np.random.default_rng(9)
    return testmodel.random_llama_weights(
        rng, n_layers=L, n_embd=DIM, n_heads=H, n_kv_heads=KV, n_ff=HID, n_vocab=V)


def _convert_both(bin_path, vocab, out):
    hp = convert(bin_path, vocab, out)
    j_out = out.with_name("j_" + out.name)
    assert j_convert_llama2c.convert(bin_path, vocab, j_out) == hp
    assert out.read_bytes() == j_out.read_bytes(), "the converters wrote different files"
    return hp


def _logits(gguf_path, prompt=(3, 9, 27)):
    params, cfg = load_model(gguf_path, device="cpu")
    ctx = InferenceContext(params, cfg, n_cells=64, cache_dtype=torch.float32, device="cpu")
    b = Batch()
    for i, t in enumerate(prompt):
        b.add(t, i, 0, want_logits=(i == len(prompt) - 1))
    return ctx.decode(b)[-1]


def test_convert_matches_direct_gguf(weights, tmp_path):
    w = dict(weights)
    bin_path = tmp_path / "m.bin"
    _write_llama2c(bin_path, w, shared=False)
    hp, rw = read_llama2c(bin_path)
    assert hp["dim"] == DIM and hp["n_kv_heads"] == KV
    np.testing.assert_array_equal(rw["layers.1.wk"], w["layers.1.wk"])
    out = tmp_path / "m.gguf"
    _convert_both(bin_path, "", out)
    direct = tmp_path / "d.gguf"
    testmodel.write_llama_gguf(direct, w, n_layers=L, n_embd=DIM, n_heads=H, n_kv_heads=KV,
                               n_ff=HID, n_vocab=V, n_ctx=SEQ)
    np.testing.assert_allclose(_logits(out), _logits(direct), rtol=1e-6, atol=1e-6)


def test_convert_shared_classifier(weights, tmp_path):
    bin_path = tmp_path / "s.bin"
    _write_llama2c(bin_path, dict(weights), shared=True)
    out = tmp_path / "s.gguf"
    _convert_both(bin_path, "", out)
    params, _ = load_model(out, device="cpu")
    head = params["output"]
    dense = dequant(head, torch.float32) if isinstance(head, QuantTensor) else head
    np.testing.assert_allclose(dense.numpy(), weights["tok_embd"], atol=1e-6)


def test_convert_with_tokenizer_bin(weights, tmp_path):
    tok_path = tmp_path / "tokenizer.bin"
    with open(tok_path, "wb") as f:
        f.write(struct.pack("<i", 8))
        for i in range(V):
            text = f"t{i}".encode() if i > 2 else b"x"
            f.write(struct.pack("<f", -float(i)))
            f.write(struct.pack("<i", len(text)))
            f.write(text)
    bin_path = tmp_path / "m.bin"
    _write_llama2c(bin_path, dict(weights), shared=True)
    out = tmp_path / "mv.gguf"
    _convert_both(bin_path, str(tok_path), out)
    with GGUFReader(out) as r:
        toks = list(r.metadata["tokenizer.ggml.tokens"])
        assert toks[0] == "<unk>" and toks[1] == "<s>" and toks[2] == "</s>"
        assert toks[5] == "t5"
        assert len(toks) == V
        assert r.metadata["tokenizer.ggml.model"] == "llama"
