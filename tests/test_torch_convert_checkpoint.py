"""The port's reference-checkpoint import (tools/convert_train_checkpoint)
against the JAX package's, on the CPU, on the reference-schema fixtures
of tests/test_convert_checkpoint.py (built in the test, no vocabulary
file): the converted GGUF and LoRA adapter are byte-identical, and the
.opt.npz sidecar, which the port writes with numpy where the JAX package
builds it through optax, is equal leaf by leaf and resumes in the port's
finetune."""

import hashlib

import numpy as np
import pytest

from pipeinfer_tpu.tools import convert_train_checkpoint as j_ctc
from pipeinfer_tpu_torch.gguf.reader import GGUFReader
from pipeinfer_tpu_torch.gguf.writer import GGUFWriter
from pipeinfer_tpu_torch.models import load_model
from pipeinfer_tpu_torch.tools import convert_train_checkpoint as t_ctc
from pipeinfer_tpu_torch.tools import finetune as tft
from pipeinfer_tpu_torch.tools import testmodel

from .test_convert_checkpoint import CFG, _write_train_checkpoint


def _sha(path) -> str:
    return hashlib.sha256(open(path, "rb").read()).hexdigest()


def _npz_equal(a, b):
    da, db = np.load(a), np.load(b)
    assert sorted(da.files) == sorted(db.files)
    for k in da.files:
        assert da[k].dtype == db[k].dtype and da[k].shape == db[k].shape, k
        np.testing.assert_array_equal(da[k], db[k])
    return da


def test_train_model_checkpoint_matches_jax(tmp_path):
    ckpt = tmp_path / "ckpt.gguf"
    weights, m1, m2 = _write_train_checkpoint(ckpt, np.random.default_rng(5))
    j_out, t_out = str(tmp_path / "j.gguf"), str(tmp_path / "t.gguf")
    j_ctc.main([str(ckpt), j_out])
    t_ctc.main([str(ckpt), t_out, "--device", "cpu"])
    assert _sha(t_out) == _sha(j_out)
    data = _npz_equal(t_out + ".opt.npz", j_out + ".opt.npz")
    assert int(data["step"]) == 16 and int(data["leaf_0"]) == 17

    # the sidecar resumes in the port: AdamW's state, moments on their tensors
    params, cfg = load_model(t_out, device="cpu")
    assert cfg.n_layers == CFG["n_layers"] and cfg.n_ff == CFG["n_ff"]
    dense = tft.dense_params(params)
    np.testing.assert_allclose(dense["layers"][1]["w_gate"].numpy(),
                               weights["blk.1.ffn_gate.weight"], rtol=1e-6)
    state, step = tft.load_opt_state(t_out + ".opt.npz",
                                     tft.AdamW(1e-4).init(tft.tree_leaves(dense)))
    assert step == 16 and state.count == 17
    # tree-flatten order: each layer's slots sorted, then output, output_norm, tok_embd
    slots = sorted(dense["layers"][0])
    n_layer = len(slots)
    np.testing.assert_array_equal(state.mu[slots.index("wq")].numpy(), m1["blk.0.attn_q.weight"])
    np.testing.assert_array_equal(state.nu[n_layer + slots.index("w_down")].numpy(),
                                  m2["blk.1.ffn_down.weight"])
    np.testing.assert_array_equal(state.nu[2 * n_layer].numpy(), m2["output.weight"])


def test_train_model_vocab_graft_matches_jax(tmp_path):
    """--vocab-from with a synthetic SPM vocabulary (the JAX package's own
    test needs the reference's fixture): the same file, a working
    tokenizer."""
    from pipeinfer_tpu_torch.tokenizer import tokenizer_from_gguf

    ckpt = tmp_path / "ckpt.gguf"
    _write_train_checkpoint(ckpt, np.random.default_rng(6))
    vocab = tmp_path / "vocab.gguf"
    w = GGUFWriter(vocab, "llama")
    for k, v in testmodel.synthetic_spm_vocab(320).items():
        w.add_kv(k, v)
    w.write()
    j_out, t_out = str(tmp_path / "j.gguf"), str(tmp_path / "t.gguf")
    j_ctc.main([str(ckpt), j_out, "--vocab-from", str(vocab)])
    t_ctc.main([str(ckpt), t_out, "--vocab-from", str(vocab), "--device", "cpu"])
    assert _sha(t_out) == _sha(j_out)
    _npz_equal(t_out + ".opt.npz", j_out + ".opt.npz")
    with GGUFReader(t_out) as r:
        assert tokenizer_from_gguf(r).encode("ab", add_bos=False)


def test_train_model_without_moments(tmp_path):
    """A checkpoint with no Adam moments converts to the model alone."""
    ckpt = tmp_path / "ckpt.gguf"
    w = GGUFWriter(ckpt, "llama")
    w.add_kv("llama.embedding_length", np.uint32(CFG["n_embd"]))
    w.add_kv("llama.block_count", np.uint32(1))
    w.add_kv("llama.attention.head_count", np.uint32(CFG["n_heads"]))
    w.add_kv("llama.feed_forward_length", np.uint32(CFG["n_ff"]))
    w.add_kv("training.type", "train_model")
    rng = np.random.default_rng(8)
    e, f, v = CFG["n_embd"], CFG["n_ff"], CFG["n_vocab"]
    shapes = {"token_embd.weight": (v, e), "output_norm.weight": (e,), "output.weight": (v, e),
              "blk.0.attn_norm.weight": (e,), "blk.0.attn_q.weight": (e, e),
              "blk.0.attn_k.weight": (e, e), "blk.0.attn_v.weight": (e, e),
              "blk.0.attn_output.weight": (e, e), "blk.0.ffn_norm.weight": (e,),
              "blk.0.ffn_gate.weight": (f, e), "blk.0.ffn_down.weight": (e, f),
              "blk.0.ffn_up.weight": (f, e)}
    for name, sh in shapes.items():
        w.add_tensor(name, rng.standard_normal(sh).astype(np.float32))
    w.write()
    j_out, t_out = str(tmp_path / "j.gguf"), str(tmp_path / "t.gguf")
    j_ctc.main([str(ckpt), j_out])
    t_ctc.main([str(ckpt), t_out, "--device", "cpu"])
    assert _sha(t_out) == _sha(j_out)
    assert not (tmp_path / "t.gguf.opt.npz").exists()


def test_finetune_lora_checkpoint_matches_jax(tmp_path):
    rng = np.random.default_rng(7)
    ckpt = tmp_path / "lora_ckpt.gguf"
    rank, e = 4, CFG["n_embd"]
    w = GGUFWriter(ckpt, "llama")
    w.add_kv("training.type", "finetune_lora")
    w.add_kv("training.lora.rank.attn_q", np.uint32(rank))
    w.add_kv("training.iteration_count", np.uint32(9))
    for li in range(2):
        for slot, (n, k) in (("attn_q", (e, e)), ("ffn_gate", (CFG["n_ff"], e))):
            base = f"blk.{li}.{slot}.weight"
            w.add_tensor(base + ".lora_a", rng.standard_normal((rank, k)).astype(np.float32))
            w.add_tensor(base + ".lora_b", rng.standard_normal((n, rank)).astype(np.float32))
    w.add_tensor("blk.0.attn_norm.weight.lora_a", np.ones((1, 1), np.float32))
    w.add_tensor("blk.0.attn_norm.weight.lora_b", np.ones((e, 1), np.float32))
    w.add_tensor("output_norm.weight.lora_a", np.ones((1, 1), np.float32))
    w.add_tensor("output_norm.weight.lora_b", np.ones((e, 1), np.float32))
    w.write()
    for extra in ([], ["--alpha", "8"]):
        j_out, t_out = str(tmp_path / "j.gguf"), str(tmp_path / "t.gguf")
        j_ctc.main([str(ckpt), j_out, *extra])
        t_ctc.main([str(ckpt), t_out, *extra, "--device", "cpu"])
        assert _sha(t_out) == _sha(j_out)
    from pipeinfer_tpu_torch.tools.lora import load_adapter

    alpha, got_rank, got = load_adapter(t_out)
    assert (alpha, got_rank) == (8.0, rank)
    assert set(got) == {(0, "wq"), (0, "w_gate"), (1, "wq"), (1, "w_gate")}


def test_non_checkpoint_rejected(tmp_path):
    plain = tmp_path / "plain.gguf"
    testmodel.build_tiny_llama(plain, n_layers=1, n_embd=32, n_heads=4, n_kv_heads=4, n_ff=48,
                               n_vocab=64)
    with pytest.raises(SystemExit, match="training.type"):
        t_ctc.main([str(plain), str(tmp_path / "x.gguf"), "--device", "cpu"])


def test_the_tools_ask_for_cuda_unless_told_cpu(tmp_path, monkeypatch):
    """Like every entry point of the port, the file tools resolve --device
    (default cuda) and raise without CUDA; their work is host numpy."""
    import torch

    from pipeinfer_tpu_torch.tools import export_lora, quantize

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for entry, argv in ((t_ctc.main, ["c.gguf", "o.gguf"]), (quantize.main, ["a", "b", "q4_k"]),
                        (export_lora.main, ["-m", "a", "-o", "b", "-l", "c"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            entry(argv)
