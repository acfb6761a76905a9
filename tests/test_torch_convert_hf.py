"""The port's HF converter (tools/convert_hf.py), mirroring the JAX
package's tests/test_convert_hf_archs.py: tiny random transformers models
saved with save_pretrained (nothing is downloaded), converted by both
packages' convert_hf into byte-identical GGUF files, and the port's file
run through the port's runtime on the CPU against transformers' logits
(Baichuan's W_pack and Refact's fused tensors, which transformers has no
class for, against the same weights written by hand)."""

import json

import numpy as np
import pytest
import torch

from pipeinfer_tpu.tools import convert_hf as j_convert_hf
from pipeinfer_tpu_torch.gguf.constants import GGMLQuantType
from pipeinfer_tpu_torch.gguf.writer import GGUFWriter
from pipeinfer_tpu_torch.models import load_model
from pipeinfer_tpu_torch.runtime.context import Batch, InferenceContext
from pipeinfer_tpu_torch.tools import convert_hf

tf = pytest.importorskip("transformers")

torch.set_num_threads(1)  # several test processes share the machine

TOKENS = [3, 17, 42, 7, 101, 55]  # test_model_archs.py's


def _convert_both(d, tmp_path, qtype=GGMLQuantType.F32):
    """Convert the checkpoint in d with both packages; assert the files are
    byte-identical and return the port's path."""
    from pipeinfer_tpu.gguf.constants import GGMLQuantType as JQ

    out, j_out = tmp_path / "m.gguf", tmp_path / "j.gguf"
    convert_hf.convert(d, out, qtype, log=lambda *a: None)
    j_convert_hf.convert(d, j_out, JQ[qtype.name], log=lambda *a: None)
    assert out.read_bytes() == j_out.read_bytes(), "the converters wrote different files"
    return out


def _run_port(path, tokens=TOKENS) -> np.ndarray:
    params, cfg = load_model(path, device="cpu")
    ctx = InferenceContext(params, cfg, n_cells=32, cache_dtype=torch.float32, device="cpu")
    b = Batch()
    for i, t in enumerate(tokens):
        b.add(t, i, 0, want_logits=True)
    return np.asarray(ctx.decode(b))


def _check(got, want, tol):
    """test_model_archs.py's bar: max error over max|logit|, same argmax."""
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err / scale < tol, f"logit mismatch {err} (scale {scale})"
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def _falcon7b():
    return tf.FalconForCausalLM(tf.FalconConfig(
        vocab_size=160, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
        num_kv_heads=1, multi_query=True, new_decoder_architecture=False,
        parallel_attn=True, bias=False, alibi=False, layer_norm_epsilon=1e-5))


def _falcon40b():
    return tf.FalconForCausalLM(tf.FalconConfig(
        vocab_size=160, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
        num_kv_heads=2, multi_query=False, new_decoder_architecture=True,
        parallel_attn=True, bias=False, alibi=False, layer_norm_epsilon=1e-5))


def _starcoder():
    return tf.GPTBigCodeForCausalLM(tf.GPTBigCodeConfig(
        vocab_size=160, n_embd=64, n_layer=2, n_head=4, n_inner=256,
        multi_query=True, n_positions=128, layer_norm_epsilon=1e-5,
        activation_function="gelu_pytorch_tanh"))


def _mpt():
    return tf.MptForCausalLM(tf.MptConfig(
        vocab_size=160, d_model=64, n_layers=2, n_heads=4, expansion_ratio=4,
        max_seq_len=128, layer_norm_epsilon=1e-5, no_bias=True,
        attn_config=tf.models.mpt.configuration_mpt.MptAttentionConfig(
            alibi=True, alibi_bias_max=8, attn_impl="torch")))


def _bloom():
    return tf.BloomForCausalLM(tf.BloomConfig(
        vocab_size=160, hidden_size=64, n_layer=2, n_head=4, layer_norm_epsilon=1e-5))


def _stablelm():
    return tf.StableLmForCausalLM(tf.StableLmConfig(
        vocab_size=160, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=4, intermediate_size=256, rope_pct=0.25,
        partial_rotary_factor=0.25, layer_norm_eps=1e-5, use_qkv_bias=False,
        max_position_embeddings=128))


def _persimmon():
    return tf.PersimmonForCausalLM(tf.PersimmonConfig(
        vocab_size=160, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=256, partial_rotary_factor=0.5, layer_norm_eps=1e-5,
        qk_layernorm=True, max_position_embeddings=128, hidden_act="relu2"))


# name -> (model maker, torch seed, logit tolerance): test_convert_hf_archs.py's cases
HF_CASES = {
    "falcon_7b_style": (_falcon7b, 21, 8e-3),
    "falcon_40b_style": (_falcon40b, 22, 8e-3),
    "starcoder": (_starcoder, 23, 8e-3),
    "mpt": (_mpt, 24, 8e-3),
    "bloom": (_bloom, 25, 8e-3),
    "stablelm": (_stablelm, 26, 3e-3),
    "persimmon": (_persimmon, 27, 8e-3),
}


@pytest.mark.parametrize("name", sorted(HF_CASES))
def test_convert_hf_arch(name, tmp_path):
    make, seed, tol = HF_CASES[name]
    torch.manual_seed(seed)
    hf = make().eval()
    d = tmp_path / "hf"
    hf.save_pretrained(d, safe_serialization=True)
    out = _convert_both(d, tmp_path)
    with torch.no_grad():
        want = hf(torch.tensor([TOKENS])).logits[0].numpy()
    _check(_run_port(out), want, tol)


@pytest.mark.parametrize("ftype", ["f16", "q8_0"])
def test_convert_hf_quantized_bytes(ftype, tmp_path):
    """The --ftype outputs (the default f16, and q8_0) are byte-identical
    too, and the port loads and runs them."""
    from pipeinfer_tpu_torch.tools.quantize import FTYPES

    torch.manual_seed(21)
    d = tmp_path / "hf"
    _falcon7b().eval().save_pretrained(d, safe_serialization=True)
    out = _convert_both(d, tmp_path, FTYPES[ftype])
    assert np.isfinite(_run_port(out)).all()


def test_convert_baichuan_wpack(tmp_path):
    """Baichuan's W_pack split and rope permute: a llama model with its
    q/k/v fused into W_pack, converted, against transformers' llama."""
    conf = tf.LlamaConfig(
        vocab_size=160, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=4, intermediate_size=256, rms_norm_eps=1e-5,
        max_position_embeddings=128)
    torch.manual_seed(28)
    hf = tf.LlamaForCausalLM(conf).eval()
    d = tmp_path / "hf"
    d.mkdir()
    sd = {k: v.detach().float() for k, v in hf.state_dict().items()}
    new_sd = {}
    for k, v in sd.items():
        if ".self_attn.q_proj.weight" in k:
            base = k.replace(".q_proj.weight", "")
            new_sd[base + ".W_pack.weight"] = torch.cat(
                [sd[base + ".q_proj.weight"], sd[base + ".k_proj.weight"],
                 sd[base + ".v_proj.weight"]], dim=0)
        elif ".self_attn.k_proj.weight" not in k and ".self_attn.v_proj.weight" not in k:
            new_sd[k] = v
    from safetensors.torch import save_file

    save_file(new_sd, d / "model.safetensors")
    (d / "config.json").write_text(json.dumps({
        "model_type": "baichuan", "architectures": ["BaichuanForCausalLM"],
        "hidden_size": 64, "num_hidden_layers": 2, "num_attention_heads": 4,
        "num_key_value_heads": 4, "intermediate_size": 256, "rms_norm_eps": 1e-5,
        "max_position_embeddings": 128, "vocab_size": 160,
    }))
    out = _convert_both(d, tmp_path)
    with torch.no_grad():
        want = hf(torch.tensor([TOKENS])).logits[0].numpy()
    _check(_run_port(out), want, 3e-3)


def _common_kv(w: GGUFWriter, *, n_embd, n_layers, n_heads, n_kv, n_ff, n_vocab, eps, alibi):
    """test_model_archs.py's _common_kv for an RMS-norm model with ALiBi."""
    from pipeinfer_tpu_torch.gguf.constants import Keys

    w.add_arch_kv(Keys.EMBEDDING_LENGTH, n_embd)
    w.add_arch_kv(Keys.BLOCK_COUNT, n_layers)
    w.add_arch_kv(Keys.HEAD_COUNT, n_heads)
    w.add_arch_kv(Keys.HEAD_COUNT_KV, n_kv)
    w.add_arch_kv(Keys.FEED_FORWARD_LENGTH, n_ff)
    w.add_arch_kv(Keys.CONTEXT_LENGTH, 512)
    w.add_kv("general.vocab_size", n_vocab)
    w.add_arch_kv(Keys.LAYER_NORM_RMS_EPS, float(eps))
    w.add_arch_kv(Keys.MAX_ALIBI_BIAS, float(alibi))


def test_convert_refact(tmp_path):
    """Refact: the fused kv and gate_up tensors split; the port's converted
    file runs as the same weights written by hand."""
    rng = np.random.default_rng(29)
    n_embd, n_head, n_vocab, n_layer = 64, 4, 160, 2
    head_dim = n_embd // n_head
    ff = 256 * ((int(2 * (4 * n_embd) / 3) + 255) // 256)

    def r(*s):
        return (rng.standard_normal(s) * 0.08).astype(np.float32)

    tensors = {
        "transformer.wte.weight": r(n_vocab, n_embd),
        "ln_f.weight": np.ones(n_embd, np.float32),
        "lm_head.weight": r(n_vocab, n_embd),
    }
    for i in range(n_layer):
        p = f"transformer.h.{i}."
        tensors[p + "ln_1.weight"] = np.ones(n_embd, np.float32)
        tensors[p + "attn.q.weight"] = r(n_embd, n_embd)
        tensors[p + "attn.kv.weight"] = r(2 * head_dim, n_embd)
        tensors[p + "attn.c_proj.weight"] = r(n_embd, n_embd)
        tensors[p + "ln_2.weight"] = np.ones(n_embd, np.float32)
        tensors[p + "mlp.gate_up_proj.weight"] = r(2 * ff, n_embd)
        tensors[p + "mlp.c_proj.weight"] = r(n_embd, ff)
    d = tmp_path / "hf"
    d.mkdir()
    from safetensors.numpy import save_file

    save_file(tensors, d / "model.safetensors")
    (d / "config.json").write_text(json.dumps({
        "model_type": "gpt_refact", "n_embd": n_embd, "n_layer": n_layer,
        "n_head": n_head, "n_positions": 128, "layer_norm_epsilon": 1e-5,
        "vocab_size": n_vocab,
    }))
    out = _convert_both(d, tmp_path)

    ref = tmp_path / "ref.gguf"
    w = GGUFWriter(ref, "refact")
    _common_kv(w, n_embd=n_embd, n_layers=n_layer, n_heads=n_head, n_kv=1, n_ff=ff,
               n_vocab=n_vocab, eps=1e-5, alibi=8.0)
    w.add_tensor("token_embd.weight", tensors["transformer.wte.weight"])
    w.add_tensor("output_norm.weight", tensors["ln_f.weight"])
    w.add_tensor("output.weight", tensors["lm_head.weight"])
    for i in range(n_layer):
        p = f"transformer.h.{i}."
        w.add_tensor(f"blk.{i}.attn_norm.weight", tensors[p + "ln_1.weight"])
        w.add_tensor(f"blk.{i}.attn_q.weight", tensors[p + "attn.q.weight"])
        w.add_tensor(f"blk.{i}.attn_k.weight", tensors[p + "attn.kv.weight"][:head_dim])
        w.add_tensor(f"blk.{i}.attn_v.weight", tensors[p + "attn.kv.weight"][head_dim:])
        w.add_tensor(f"blk.{i}.attn_output.weight", tensors[p + "attn.c_proj.weight"])
        w.add_tensor(f"blk.{i}.ffn_norm.weight", tensors[p + "ln_2.weight"])
        w.add_tensor(f"blk.{i}.ffn_gate.weight", tensors[p + "mlp.gate_up_proj.weight"][:ff])
        w.add_tensor(f"blk.{i}.ffn_up.weight", tensors[p + "mlp.gate_up_proj.weight"][ff:])
        w.add_tensor(f"blk.{i}.ffn_down.weight", tensors[p + "mlp.c_proj.weight"])
    w.write()
    np.testing.assert_allclose(_run_port(out), _run_port(ref), rtol=1e-5, atol=1e-5)
