"""`pipeinfer-convert` — HuggingFace checkpoint → GGUF, all 9 architectures
(ref: convert.py for the llama family; convert-hf-to-gguf.py:1 for
falcon/starcoder/refact/bloom/mpt/stablelm/persimmon/baichuan).

Reads config.json + safetensors/pytorch weights from a local model
directory, applies the per-architecture tensor-name mapping and layout
transforms (rope permutation, fused-QKV reorders, gate/up splits), and
writes GGUF (optionally quantized). Tensors stream one at a time — a
Falcon-40B converts without materializing the state dict.

A copy of pipeinfer_tpu.tools.convert_hf, which imports no JAX: the same
GGUF bytes for the same checkpoint, on the host (torch only reads
`pytorch_model.bin` checkpoints).
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path

import numpy as np

from ..gguf.constants import GGMLQuantType, Keys
from ..gguf.writer import GGUFWriter
from .quantize import FTYPES
from .testmodel import permute_for_ggml_rope


def _iter_weights(model_dir: Path):
    """Yield (name, numpy array) from safetensors or torch .bin shards."""
    st_files = sorted(model_dir.glob("*.safetensors"))
    if st_files:
        from safetensors import safe_open  # available via transformers deps

        for f in st_files:
            with safe_open(f, framework="np") as sf:
                for name in sf.keys():
                    yield name, sf.get_tensor(name)
        return
    bin_files = sorted(model_dir.glob("pytorch_model*.bin"))
    if not bin_files:
        raise SystemExit(f"{model_dir}: no safetensors or pytorch_model*.bin found")
    import torch

    for f in bin_files:
        sd = torch.load(f, map_location="cpu", weights_only=True)
        for name, t in sd.items():
            yield name, t.to(torch.float32).numpy()


def _add_tokenizer(w: GGUFWriter, model_dir: Path):
    """Embed an SPM or BPE vocab from tokenizer.json."""
    tj = model_dir / "tokenizer.json"
    if not tj.exists():
        print("warning: no tokenizer.json; GGUF will have no vocab", file=sys.stderr)
        return
    data = json.loads(tj.read_text())
    model = data.get("model", {})
    if model.get("type") == "BPE" and "vocab" in model:
        vocab = model["vocab"]
        tokens = [None] * len(vocab)
        for tok, idx in vocab.items():
            if idx < len(tokens):
                tokens[idx] = tok
        tokens = [t if t is not None else f"<unused{i}>" for i, t in enumerate(tokens)]
        w.add_kv(Keys.TOKENIZER_MODEL, "gpt2")
        w.add_kv(Keys.TOKENIZER_LIST, tokens)
        w.add_kv(
            Keys.TOKENIZER_MERGES,
            [" ".join(m) if isinstance(m, list) else m for m in model.get("merges", [])],
        )
        w.add_kv(Keys.TOKENIZER_TOKEN_TYPE, np.ones(len(tokens), np.int32))
        w.add_kv(Keys.TOKENIZER_SCORES, np.zeros(len(tokens), np.float32))
    else:
        # sentencepiece-style vocab embedded in tokenizer.json
        vocab = model.get("vocab", [])
        if vocab and isinstance(vocab[0], list):
            tokens = [v[0] for v in vocab]
            scores = np.asarray([float(v[1]) for v in vocab], np.float32)
            w.add_kv(Keys.TOKENIZER_MODEL, "llama")
            w.add_kv(Keys.TOKENIZER_LIST, tokens)
            w.add_kv(Keys.TOKENIZER_SCORES, scores)
            ttypes = np.ones(len(tokens), np.int32)
            for i, t in enumerate(tokens):
                if t.startswith("<0x") and t.endswith(">") and len(t) == 6:
                    ttypes[i] = 6  # BYTE
                elif t in ("<s>", "</s>", "<unk>"):
                    ttypes[i] = 3 if t != "<unk>" else 2
            w.add_kv(Keys.TOKENIZER_TOKEN_TYPE, ttypes)


def _hp(cfg: dict, *names, default=None, required=False):
    """First present hyperparameter under any of several (era-dependent)
    config.json names."""
    for n in names:
        if n in cfg:
            return cfg[n]
    if required:
        raise SystemExit(f"config.json missing any of {names}")
    return default


# ---------------------------------------------------------------------------
# per-architecture specs
# ---------------------------------------------------------------------------


class ArchSpec:
    """One architecture: metadata writer + streaming tensor mapper.

    `rules` is a list of (regex, gguf template | None). A None target skips
    the tensor. `transform(spec, gname, m, arr)` may further reshape or
    split; it returns a list of (gguf_name, array).
    """

    gguf_arch: str = ""
    rules: list[tuple[str, str | None]] = []

    def __init__(self, cfg: dict):
        self.cfg = cfg
        self._compiled = [(re.compile(rx + r"$"), tgt) for rx, tgt in self.rules]

    # -- dims used by transforms
    @property
    def n_embd(self):
        return _hp(self.cfg, "hidden_size", "d_model", "n_embd", required=True)

    @property
    def n_layers(self):
        return _hp(self.cfg, "num_hidden_layers", "n_layers", "n_layer", required=True)

    @property
    def n_heads(self):
        return _hp(self.cfg, "num_attention_heads", "n_heads", "n_head", required=True)

    @property
    def n_kv(self):
        return _hp(
            self.cfg, "num_key_value_heads", "num_kv_heads", "n_head_kv",
            default=self.n_heads,
        )

    @property
    def head_dim(self):
        return self.n_embd // self.n_heads

    @property
    def n_ff(self):
        return _hp(self.cfg, "intermediate_size", "n_inner", default=4 * self.n_embd) \
            or 4 * self.n_embd

    @property
    def n_ctx(self):
        return _hp(
            self.cfg, "max_position_embeddings", "n_positions", "max_seq_len",
            "max_sequence_length", "model_max_length", default=2048,
        )

    def metadata(self, w: GGUFWriter):
        raise NotImplementedError

    def map_tensor(self, name: str, arr: np.ndarray):
        for rex, tgt in self._compiled:
            m = rex.match(name)
            if m:
                if tgt is None:
                    return []
                gname = tgt.format(*m.groups())
                return self.transform(gname, m, arr)
        return None  # unmapped

    def transform(self, gname: str, m, arr: np.ndarray):
        return [(gname, arr)]


class LlamaSpec(ArchSpec):
    gguf_arch = "llama"
    rules = [
        (r"model\.embed_tokens\.weight", "token_embd.weight"),
        (r"model\.norm\.weight", "output_norm.weight"),
        (r"lm_head\.weight", "output.weight"),
        (r"model\.layers\.(\d+)\.input_layernorm\.weight", "blk.{0}.attn_norm.weight"),
        (r"model\.layers\.(\d+)\.self_attn\.q_proj\.weight", "blk.{0}.attn_q.weight"),
        (r"model\.layers\.(\d+)\.self_attn\.k_proj\.weight", "blk.{0}.attn_k.weight"),
        (r"model\.layers\.(\d+)\.self_attn\.v_proj\.weight", "blk.{0}.attn_v.weight"),
        (r"model\.layers\.(\d+)\.self_attn\.o_proj\.weight", "blk.{0}.attn_output.weight"),
        (r"model\.layers\.(\d+)\.post_attention_layernorm\.weight", "blk.{0}.ffn_norm.weight"),
        (r"model\.layers\.(\d+)\.mlp\.gate_proj\.weight", "blk.{0}.ffn_gate.weight"),
        (r"model\.layers\.(\d+)\.mlp\.up_proj\.weight", "blk.{0}.ffn_up.weight"),
        (r"model\.layers\.(\d+)\.mlp\.down_proj\.weight", "blk.{0}.ffn_down.weight"),
        (r"model\.layers\.(\d+)\.self_attn\.rotary_emb\.inv_freq", None),
    ]

    def metadata(self, w):
        w.add_arch_kv(Keys.CONTEXT_LENGTH, self.n_ctx)
        w.add_arch_kv(Keys.EMBEDDING_LENGTH, self.n_embd)
        w.add_arch_kv(Keys.BLOCK_COUNT, self.n_layers)
        w.add_arch_kv(Keys.FEED_FORWARD_LENGTH, self.n_ff)
        w.add_arch_kv(Keys.HEAD_COUNT, self.n_heads)
        w.add_arch_kv(Keys.HEAD_COUNT_KV, self.n_kv)
        w.add_arch_kv(Keys.ROPE_DIMENSION_COUNT, self.head_dim)
        w.add_arch_kv(Keys.ROPE_FREQ_BASE, float(self.cfg.get("rope_theta", 10000.0)))
        w.add_arch_kv(Keys.LAYER_NORM_RMS_EPS, float(self.cfg.get("rms_norm_eps", 1e-5)))
        rs = self.cfg.get("rope_scaling") or {}
        if rs.get("type") == "linear" and "factor" in rs:
            w.add_arch_kv(Keys.ROPE_SCALE_LINEAR, float(rs["factor"]))

    def transform(self, gname, m, arr):
        if gname.endswith("attn_q.weight"):
            arr = permute_for_ggml_rope(arr, self.n_heads)
        elif gname.endswith("attn_k.weight"):
            arr = permute_for_ggml_rope(arr, self.n_kv)
        return [(gname, arr)]


class BaichuanSpec(LlamaSpec):
    """Baichuan 7B/13B: llama-shaped but with a fused W_pack [3E, E]
    (ref: convert-hf-to-gguf.py BaichuanModel W_pack unpack+permute)."""

    gguf_arch = "baichuan"
    rules = LlamaSpec.rules + [
        (r"model\.layers\.(\d+)\.self_attn\.W_pack\.weight", "blk.{0}.attn_qkv_packed"),
    ]

    def metadata(self, w):
        super().metadata(w)

    def transform(self, gname, m, arr):
        if gname.endswith("attn_qkv_packed"):
            i = m.group(1)
            e = self.n_embd
            kvd = self.n_kv * self.head_dim
            q, k, v = arr[:e], arr[e : e + kvd], arr[e + kvd : e + 2 * kvd]
            return [
                (f"blk.{i}.attn_q.weight", permute_for_ggml_rope(q, self.n_heads)),
                (f"blk.{i}.attn_k.weight", permute_for_ggml_rope(k, self.n_kv)),
                (f"blk.{i}.attn_v.weight", v),
            ]
        return super().transform(gname, m, arr)


class FalconSpec(ArchSpec):
    """Falcon 7B (multi_query) and 40B/180B (new_decoder_architecture).

    The HF query_key_value fuses n_kv groups of [n_head/n_kv q-heads, k, v];
    the runtime wants contiguous [Q; K; V]
    (ref: convert-hf-to-gguf.py:631-648 FalconModel qkv rearrange)."""

    gguf_arch = "falcon"
    rules = [
        (r"transformer\.word_embeddings\.weight", "token_embd.weight"),
        (r"transformer\.ln_f\.weight", "output_norm.weight"),
        (r"transformer\.ln_f\.bias", "output_norm.bias"),
        (r"lm_head\.weight", "output.weight"),
        # 7B single-norm layout
        (r"transformer\.h\.(\d+)\.input_layernorm\.weight", "blk.{0}.attn_norm.weight"),
        (r"transformer\.h\.(\d+)\.input_layernorm\.bias", "blk.{0}.attn_norm.bias"),
        # 40B dual-norm layout: ln_mlp feeds the FFN branch (attn_norm),
        # ln_attn feeds attention (attn_norm_2) per the runtime traits
        (r"transformer\.h\.(\d+)\.ln_mlp\.weight", "blk.{0}.attn_norm.weight"),
        (r"transformer\.h\.(\d+)\.ln_mlp\.bias", "blk.{0}.attn_norm.bias"),
        (r"transformer\.h\.(\d+)\.ln_attn\.weight", "blk.{0}.attn_norm_2.weight"),
        (r"transformer\.h\.(\d+)\.ln_attn\.bias", "blk.{0}.attn_norm_2.bias"),
        (r"transformer\.h\.(\d+)\.self_attention\.query_key_value\.weight",
         "blk.{0}.attn_qkv.weight"),
        (r"transformer\.h\.(\d+)\.self_attention\.dense\.weight", "blk.{0}.attn_output.weight"),
        (r"transformer\.h\.(\d+)\.mlp\.dense_h_to_4h\.weight", "blk.{0}.ffn_up.weight"),
        (r"transformer\.h\.(\d+)\.mlp\.dense_4h_to_h\.weight", "blk.{0}.ffn_down.weight"),
    ]

    @property
    def n_kv(self):
        if self.cfg.get("new_decoder_architecture"):
            return _hp(self.cfg, "num_kv_heads", "n_head_kv", default=self.n_heads)
        if self.cfg.get("multi_query", True):
            return 1
        return self.n_heads

    def metadata(self, w):
        w.add_arch_kv(Keys.CONTEXT_LENGTH, self.n_ctx)
        w.add_arch_kv(Keys.EMBEDDING_LENGTH, self.n_embd)
        w.add_arch_kv(Keys.BLOCK_COUNT, self.n_layers)
        w.add_arch_kv(Keys.FEED_FORWARD_LENGTH, 4 * self.n_embd)
        w.add_arch_kv(Keys.HEAD_COUNT, self.n_heads)
        w.add_arch_kv(Keys.HEAD_COUNT_KV, self.n_kv)
        w.add_arch_kv(
            Keys.LAYER_NORM_EPS, float(_hp(self.cfg, "layer_norm_epsilon", default=1e-5))
        )

    def transform(self, gname, m, arr):
        if gname.endswith("attn_qkv.weight") and self.cfg.get("new_decoder_architecture"):
            nh, nkv, d = self.n_heads, self.n_kv, self.head_dim
            qkv = arr.reshape(nkv, nh // nkv + 2, d, self.n_embd)
            q = qkv[:, :-2].reshape(nh * d, self.n_embd)
            k = qkv[:, -2].reshape(nkv * d, self.n_embd)
            v = qkv[:, -1].reshape(nkv * d, self.n_embd)
            arr = np.concatenate([q, k, v], axis=0)
        return [(gname, arr)]


class StarCoderSpec(ArchSpec):
    gguf_arch = "starcoder"
    rules = [
        (r"transformer\.wte\.weight", "token_embd.weight"),
        (r"transformer\.wpe\.weight", "position_embd.weight"),
        (r"transformer\.ln_f\.weight", "output_norm.weight"),
        (r"transformer\.ln_f\.bias", "output_norm.bias"),
        (r"lm_head\.weight", "output.weight"),
        (r"transformer\.h\.(\d+)\.ln_1\.weight", "blk.{0}.attn_norm.weight"),
        (r"transformer\.h\.(\d+)\.ln_1\.bias", "blk.{0}.attn_norm.bias"),
        (r"transformer\.h\.(\d+)\.attn\.c_attn\.weight", "blk.{0}.attn_qkv.weight"),
        (r"transformer\.h\.(\d+)\.attn\.c_attn\.bias", "blk.{0}.attn_qkv.bias"),
        (r"transformer\.h\.(\d+)\.attn\.c_proj\.weight", "blk.{0}.attn_output.weight"),
        (r"transformer\.h\.(\d+)\.attn\.c_proj\.bias", "blk.{0}.attn_output.bias"),
        (r"transformer\.h\.(\d+)\.ln_2\.weight", "blk.{0}.ffn_norm.weight"),
        (r"transformer\.h\.(\d+)\.ln_2\.bias", "blk.{0}.ffn_norm.bias"),
        (r"transformer\.h\.(\d+)\.mlp\.c_fc\.weight", "blk.{0}.ffn_up.weight"),
        (r"transformer\.h\.(\d+)\.mlp\.c_fc\.bias", "blk.{0}.ffn_up.bias"),
        (r"transformer\.h\.(\d+)\.mlp\.c_proj\.weight", "blk.{0}.ffn_down.weight"),
        (r"transformer\.h\.(\d+)\.mlp\.c_proj\.bias", "blk.{0}.ffn_down.bias"),
        (r"transformer\.h\.(\d+)\.attn\.masked_bias", None),
        (r"transformer\.h\.(\d+)\.attn\.bias", None),
    ]

    @property
    def n_kv(self):
        return 1 if self.cfg.get("multi_query", True) else self.n_heads

    def metadata(self, w):
        w.add_arch_kv(Keys.CONTEXT_LENGTH, self.n_ctx)
        w.add_arch_kv(Keys.EMBEDDING_LENGTH, self.n_embd)
        w.add_arch_kv(Keys.BLOCK_COUNT, self.n_layers)
        w.add_arch_kv(Keys.FEED_FORWARD_LENGTH, self.n_ff)
        w.add_arch_kv(Keys.HEAD_COUNT, self.n_heads)
        w.add_arch_kv(Keys.HEAD_COUNT_KV, self.n_kv)
        w.add_arch_kv(
            Keys.LAYER_NORM_EPS, float(_hp(self.cfg, "layer_norm_epsilon", default=1e-5))
        )


class MptSpec(ArchSpec):
    gguf_arch = "mpt"
    rules = [
        (r"transformer\.wte\.weight", "token_embd.weight"),
        (r"transformer\.norm_f\.weight", "output_norm.weight"),
        (r"transformer\.blocks\.(\d+)\.norm_1\.weight", "blk.{0}.attn_norm.weight"),
        (r"transformer\.blocks\.(\d+)\.attn\.Wqkv\.weight", "blk.{0}.attn_qkv.weight"),
        (r"transformer\.blocks\.(\d+)\.attn\.out_proj\.weight", "blk.{0}.attn_output.weight"),
        (r"transformer\.blocks\.(\d+)\.norm_2\.weight", "blk.{0}.ffn_norm.weight"),
        (r"transformer\.blocks\.(\d+)\.ffn\.up_proj\.weight", "blk.{0}.ffn_up.weight"),
        (r"transformer\.blocks\.(\d+)\.ffn\.down_proj\.weight", "blk.{0}.ffn_down.weight"),
    ]

    @property
    def n_ff(self):
        return int(self.cfg.get("expansion_ratio", 4)) * self.n_embd

    def metadata(self, w):
        attn = self.cfg.get("attn_config", {}) or {}
        w.add_arch_kv(Keys.CONTEXT_LENGTH, self.n_ctx)
        w.add_arch_kv(Keys.EMBEDDING_LENGTH, self.n_embd)
        w.add_arch_kv(Keys.BLOCK_COUNT, self.n_layers)
        w.add_arch_kv(Keys.FEED_FORWARD_LENGTH, self.n_ff)
        w.add_arch_kv(Keys.HEAD_COUNT, self.n_heads)
        w.add_arch_kv(Keys.HEAD_COUNT_KV, self.n_heads)
        w.add_arch_kv(
            Keys.LAYER_NORM_EPS, float(_hp(self.cfg, "layer_norm_epsilon", default=1e-5))
        )
        if attn.get("alibi", True):
            w.add_arch_kv(Keys.MAX_ALIBI_BIAS, float(attn.get("alibi_bias_max", 8)))
        if attn.get("clip_qkv"):
            w.add_arch_kv(Keys.CLAMP_KQV, float(attn["clip_qkv"]))


class BloomSpec(ArchSpec):
    """Bloom: per-head-interleaved fused qkv → contiguous [Q; K; V]
    (ref: convert-hf-to-gguf.py BloomModel reordering)."""

    gguf_arch = "bloom"
    rules = [
        (r"(?:transformer\.)?word_embeddings\.weight", "token_embd.weight"),
        (r"(?:transformer\.)?word_embeddings_layernorm\.weight", "token_embd_norm.weight"),
        (r"(?:transformer\.)?word_embeddings_layernorm\.bias", "token_embd_norm.bias"),
        (r"(?:transformer\.)?ln_f\.weight", "output_norm.weight"),
        (r"(?:transformer\.)?ln_f\.bias", "output_norm.bias"),
        (r"lm_head\.weight", "output.weight"),
        (r"(?:transformer\.)?h\.(\d+)\.input_layernorm\.weight", "blk.{0}.attn_norm.weight"),
        (r"(?:transformer\.)?h\.(\d+)\.input_layernorm\.bias", "blk.{0}.attn_norm.bias"),
        (r"(?:transformer\.)?h\.(\d+)\.self_attention\.query_key_value\.weight",
         "blk.{0}.attn_qkv.weight"),
        (r"(?:transformer\.)?h\.(\d+)\.self_attention\.query_key_value\.bias",
         "blk.{0}.attn_qkv.bias"),
        (r"(?:transformer\.)?h\.(\d+)\.self_attention\.dense\.weight",
         "blk.{0}.attn_output.weight"),
        (r"(?:transformer\.)?h\.(\d+)\.self_attention\.dense\.bias",
         "blk.{0}.attn_output.bias"),
        (r"(?:transformer\.)?h\.(\d+)\.post_attention_layernorm\.weight",
         "blk.{0}.ffn_norm.weight"),
        (r"(?:transformer\.)?h\.(\d+)\.post_attention_layernorm\.bias",
         "blk.{0}.ffn_norm.bias"),
        (r"(?:transformer\.)?h\.(\d+)\.mlp\.dense_h_to_4h\.weight", "blk.{0}.ffn_up.weight"),
        (r"(?:transformer\.)?h\.(\d+)\.mlp\.dense_h_to_4h\.bias", "blk.{0}.ffn_up.bias"),
        (r"(?:transformer\.)?h\.(\d+)\.mlp\.dense_4h_to_h\.weight", "blk.{0}.ffn_down.weight"),
        (r"(?:transformer\.)?h\.(\d+)\.mlp\.dense_4h_to_h\.bias", "blk.{0}.ffn_down.bias"),
    ]

    def metadata(self, w):
        w.add_arch_kv(Keys.CONTEXT_LENGTH, self.n_ctx)
        w.add_arch_kv(Keys.EMBEDDING_LENGTH, self.n_embd)
        w.add_arch_kv(Keys.BLOCK_COUNT, self.n_layers)
        w.add_arch_kv(Keys.FEED_FORWARD_LENGTH, self.n_ff)
        w.add_arch_kv(Keys.HEAD_COUNT, self.n_heads)
        w.add_arch_kv(Keys.HEAD_COUNT_KV, self.n_heads)
        w.add_arch_kv(
            Keys.LAYER_NORM_EPS, float(_hp(self.cfg, "layer_norm_epsilon", default=1e-5))
        )
        w.add_arch_kv(Keys.MAX_ALIBI_BIAS, 8.0)

    def transform(self, gname, m, arr):
        if "attn_qkv" in gname:
            nh, d = self.n_heads, self.head_dim
            x = arr.reshape(nh, 3, d, -1) if arr.ndim == 2 else arr.reshape(nh, 3, d)
            out = np.concatenate([x[:, 0], x[:, 1], x[:, 2]], axis=0)
            arr = out.reshape(3 * nh * d, -1) if arr.ndim == 2 else out.reshape(-1)
        return [(gname, arr)]


class StableLmSpec(ArchSpec):
    gguf_arch = "stablelm"
    rules = [
        (r"model\.embed_tokens\.weight", "token_embd.weight"),
        (r"model\.norm\.weight", "output_norm.weight"),
        (r"model\.norm\.bias", "output_norm.bias"),
        (r"lm_head\.weight", "output.weight"),
        (r"model\.layers\.(\d+)\.input_layernorm\.weight", "blk.{0}.attn_norm.weight"),
        (r"model\.layers\.(\d+)\.input_layernorm\.bias", "blk.{0}.attn_norm.bias"),
        (r"model\.layers\.(\d+)\.self_attn\.q_proj\.weight", "blk.{0}.attn_q.weight"),
        (r"model\.layers\.(\d+)\.self_attn\.q_proj\.bias", "blk.{0}.attn_q.bias"),
        (r"model\.layers\.(\d+)\.self_attn\.k_proj\.weight", "blk.{0}.attn_k.weight"),
        (r"model\.layers\.(\d+)\.self_attn\.k_proj\.bias", "blk.{0}.attn_k.bias"),
        (r"model\.layers\.(\d+)\.self_attn\.v_proj\.weight", "blk.{0}.attn_v.weight"),
        (r"model\.layers\.(\d+)\.self_attn\.v_proj\.bias", "blk.{0}.attn_v.bias"),
        (r"model\.layers\.(\d+)\.self_attn\.o_proj\.weight", "blk.{0}.attn_output.weight"),
        (r"model\.layers\.(\d+)\.post_attention_layernorm\.weight", "blk.{0}.ffn_norm.weight"),
        (r"model\.layers\.(\d+)\.post_attention_layernorm\.bias", "blk.{0}.ffn_norm.bias"),
        (r"model\.layers\.(\d+)\.mlp\.gate_proj\.weight", "blk.{0}.ffn_gate.weight"),
        (r"model\.layers\.(\d+)\.mlp\.up_proj\.weight", "blk.{0}.ffn_up.weight"),
        (r"model\.layers\.(\d+)\.mlp\.down_proj\.weight", "blk.{0}.ffn_down.weight"),
        (r"model\.layers\.(\d+)\.self_attn\.rotary_emb\.inv_freq", None),
    ]

    def metadata(self, w):
        rope_pct = float(
            _hp(self.cfg, "partial_rotary_factor", "rope_pct", default=0.25)
        )
        w.add_arch_kv(Keys.CONTEXT_LENGTH, self.n_ctx)
        w.add_arch_kv(Keys.EMBEDDING_LENGTH, self.n_embd)
        w.add_arch_kv(Keys.BLOCK_COUNT, self.n_layers)
        w.add_arch_kv(Keys.FEED_FORWARD_LENGTH, self.n_ff)
        w.add_arch_kv(Keys.HEAD_COUNT, self.n_heads)
        w.add_arch_kv(Keys.HEAD_COUNT_KV, self.n_kv)
        w.add_arch_kv(Keys.ROPE_DIMENSION_COUNT, int(self.head_dim * rope_pct))
        w.add_arch_kv(Keys.ROPE_FREQ_BASE, float(self.cfg.get("rope_theta", 10000.0)))
        w.add_arch_kv(
            Keys.LAYER_NORM_EPS, float(_hp(self.cfg, "layer_norm_eps", default=1e-5))
        )


class PersimmonSpec(ArchSpec):
    """Persimmon: per-head-interleaved fused qkv + Q/K layernorm + relu²
    (ref: convert-persimmon-to-gguf.py)."""

    gguf_arch = "persimmon"
    rules = [
        (r"(?:model|language_model\.model)\.embed_tokens\.weight", "token_embd.weight"),
        (r"(?:model|language_model\.model)\.final_layernorm\.weight", "output_norm.weight"),
        (r"(?:model|language_model\.model)\.final_layernorm\.bias", "output_norm.bias"),
        (r"(?:language_model\.)?lm_head\.weight", "output.weight"),
        (r"(?:model|language_model\.model)\.layers\.(\d+)\.input_layernorm\.weight",
         "blk.{0}.attn_norm.weight"),
        (r"(?:model|language_model\.model)\.layers\.(\d+)\.input_layernorm\.bias",
         "blk.{0}.attn_norm.bias"),
        (r"(?:model|language_model\.model)\.layers\.(\d+)\.self_attn\.query_key_value\.weight",
         "blk.{0}.attn_qkv.weight"),
        (r"(?:model|language_model\.model)\.layers\.(\d+)\.self_attn\.query_key_value\.bias",
         "blk.{0}.attn_qkv.bias"),
        (r"(?:model|language_model\.model)\.layers\.(\d+)\.self_attn\.q_layernorm\.weight",
         "blk.{0}.attn_q_norm.weight"),
        (r"(?:model|language_model\.model)\.layers\.(\d+)\.self_attn\.q_layernorm\.bias",
         "blk.{0}.attn_q_norm.bias"),
        (r"(?:model|language_model\.model)\.layers\.(\d+)\.self_attn\.k_layernorm\.weight",
         "blk.{0}.attn_k_norm.weight"),
        (r"(?:model|language_model\.model)\.layers\.(\d+)\.self_attn\.k_layernorm\.bias",
         "blk.{0}.attn_k_norm.bias"),
        (r"(?:model|language_model\.model)\.layers\.(\d+)\.self_attn\.dense\.weight",
         "blk.{0}.attn_output.weight"),
        (r"(?:model|language_model\.model)\.layers\.(\d+)\.self_attn\.dense\.bias",
         "blk.{0}.attn_output.bias"),
        (r"(?:model|language_model\.model)\.layers\.(\d+)\.post_attention_layernorm\.weight",
         "blk.{0}.ffn_norm.weight"),
        (r"(?:model|language_model\.model)\.layers\.(\d+)\.post_attention_layernorm\.bias",
         "blk.{0}.ffn_norm.bias"),
        (r"(?:model|language_model\.model)\.layers\.(\d+)\.mlp\.dense_h_to_4h\.weight",
         "blk.{0}.ffn_up.weight"),
        (r"(?:model|language_model\.model)\.layers\.(\d+)\.mlp\.dense_h_to_4h\.bias",
         "blk.{0}.ffn_up.bias"),
        (r"(?:model|language_model\.model)\.layers\.(\d+)\.mlp\.dense_4h_to_h\.weight",
         "blk.{0}.ffn_down.weight"),
        (r"(?:model|language_model\.model)\.layers\.(\d+)\.mlp\.dense_4h_to_h\.bias",
         "blk.{0}.ffn_down.bias"),
        (r".*rotary_emb\.inv_freq", None),
    ]

    def metadata(self, w):
        rope_pct = float(_hp(self.cfg, "partial_rotary_factor", default=0.5))
        w.add_arch_kv(Keys.CONTEXT_LENGTH, self.n_ctx)
        w.add_arch_kv(Keys.EMBEDDING_LENGTH, self.n_embd)
        w.add_arch_kv(Keys.BLOCK_COUNT, self.n_layers)
        w.add_arch_kv(Keys.FEED_FORWARD_LENGTH, self.n_ff)
        w.add_arch_kv(Keys.HEAD_COUNT, self.n_heads)
        w.add_arch_kv(Keys.HEAD_COUNT_KV, self.n_heads)
        w.add_arch_kv(Keys.ROPE_DIMENSION_COUNT, int(self.head_dim * rope_pct))
        w.add_arch_kv(Keys.ROPE_FREQ_BASE, float(self.cfg.get("rope_theta", 25000.0)))
        w.add_arch_kv(
            Keys.LAYER_NORM_EPS, float(_hp(self.cfg, "layer_norm_eps", default=1e-5))
        )

    def transform(self, gname, m, arr):
        if "attn_qkv" in gname:
            nh, d = self.n_heads, self.head_dim
            x = arr.reshape(nh, 3, d, -1) if arr.ndim == 2 else arr.reshape(nh, 3, d)
            out = np.concatenate([x[:, 0], x[:, 1], x[:, 2]], axis=0)
            arr = out.reshape(3 * nh * d, -1) if arr.ndim == 2 else out.reshape(-1)
        return [(gname, arr)]


class RefactSpec(ArchSpec):
    """Refact-1.6B: MQA with split q / fused kv, gated FFN with the llama
    2/3-rounding (ref: convert-hf-to-gguf.py:694-741 RefactModel)."""

    gguf_arch = "refact"
    rules = [
        (r"transformer\.wte\.weight", "token_embd.weight"),
        (r"ln_f\.weight", "output_norm.weight"),
        (r"transformer\.ln_f\.weight", "output_norm.weight"),
        (r"lm_head\.weight", "output.weight"),
        (r"transformer\.h\.(\d+)\.ln_1\.weight", "blk.{0}.attn_norm.weight"),
        (r"transformer\.h\.(\d+)\.attn\.q\.weight", "blk.{0}.attn_q.weight"),
        (r"transformer\.h\.(\d+)\.attn\.kv\.weight", "blk.{0}.attn_kv_fused"),
        (r"transformer\.h\.(\d+)\.attn\.c_proj\.weight", "blk.{0}.attn_output.weight"),
        (r"transformer\.h\.(\d+)\.ln_2\.weight", "blk.{0}.ffn_norm.weight"),
        (r"transformer\.h\.(\d+)\.mlp\.gate_up_proj\.weight", "blk.{0}.ffn_gate_up_fused"),
        (r"transformer\.h\.(\d+)\.mlp\.linear_3\.weight", "blk.{0}.ffn_down.weight"),
        (r"transformer\.h\.(\d+)\.mlp\.c_proj\.weight", "blk.{0}.ffn_down.weight"),
    ]

    @property
    def n_kv(self):
        return 1

    @property
    def n_ff(self):
        hidden = int(2 * (4 * self.n_embd) / 3)
        return 256 * ((hidden + 255) // 256)

    def metadata(self, w):
        w.add_arch_kv(Keys.CONTEXT_LENGTH, self.n_ctx)
        w.add_arch_kv(Keys.EMBEDDING_LENGTH, self.n_embd)
        w.add_arch_kv(Keys.BLOCK_COUNT, self.n_layers)
        w.add_arch_kv(Keys.FEED_FORWARD_LENGTH, self.n_ff)
        w.add_arch_kv(Keys.HEAD_COUNT, self.n_heads)
        w.add_arch_kv(Keys.HEAD_COUNT_KV, 1)
        w.add_arch_kv(
            Keys.LAYER_NORM_RMS_EPS,
            float(_hp(self.cfg, "layer_norm_epsilon", default=1e-5)),
        )
        w.add_arch_kv(Keys.MAX_ALIBI_BIAS, 8.0)

    def transform(self, gname, m, arr):
        i = m.group(1) if m.groups() else None
        if gname.endswith("attn_kv_fused"):
            kvd = self.head_dim  # n_kv = 1
            return [
                (f"blk.{i}.attn_k.weight", arr[:kvd]),
                (f"blk.{i}.attn_v.weight", arr[kvd:]),
            ]
        if gname.endswith("ffn_gate_up_fused"):
            ff = self.n_ff
            return [
                (f"blk.{i}.ffn_gate.weight", arr[:ff]),
                (f"blk.{i}.ffn_up.weight", arr[ff:]),
            ]
        return [(gname, arr)]


ARCH_SPECS: dict[str, type[ArchSpec]] = {
    "llama": LlamaSpec,
    "mistral": LlamaSpec,
    "baichuan": BaichuanSpec,
    "falcon": FalconSpec,
    "RefinedWeb": FalconSpec,
    "RefinedWebModel": FalconSpec,
    "gpt_bigcode": StarCoderSpec,
    "starcoder": StarCoderSpec,
    "mpt": MptSpec,
    "bloom": BloomSpec,
    "stablelm": StableLmSpec,
    "stablelm_epoch": StableLmSpec,
    "persimmon": PersimmonSpec,
    "gpt_refact": RefactSpec,
    "refact": RefactSpec,
}


def convert(model_dir: str | Path, out_path: str | Path, qtype: GGMLQuantType, log=print):
    model_dir = Path(model_dir)
    cfg = json.loads((model_dir / "config.json").read_text())
    mt = cfg.get("model_type", "")
    spec_cls = ARCH_SPECS.get(mt)
    if spec_cls is None and "baichuan" in str(cfg.get("architectures", "")).lower():
        spec_cls = BaichuanSpec
    if spec_cls is None:
        raise SystemExit(
            f"unsupported model_type {mt!r}; supported: {sorted(set(ARCH_SPECS))}"
        )
    spec = spec_cls(cfg)

    w = GGUFWriter(out_path, spec.gguf_arch)
    spec.metadata(w)
    w.add_kv("general.vocab_size", _hp(cfg, "vocab_size", default=32000))
    _add_tokenizer(w, model_dir)

    seen_output = False
    for name, arr in _iter_weights(model_dir):
        mapped = spec.map_tensor(name, np.asarray(arr, np.float32))
        if mapped is None:
            log(f"  skip {name}")
            continue
        for gname, garr in mapped:
            tq = qtype
            if garr.ndim != 2 or garr.shape[-1] % 256 != 0:
                tq = GGMLQuantType.F32
            w.add_tensor(gname, garr, qtype=tq)
            seen_output = seen_output or gname == "output.weight"
            log(f"  {name} -> {gname} {tuple(garr.shape)} {tq.name}")
    if not seen_output:
        log("  (tied embeddings: no output.weight)")
    w.write()


def main(argv=None):
    p = argparse.ArgumentParser("pipeinfer-convert", description=__doc__)
    p.add_argument("model_dir", help="local HF model directory")
    p.add_argument("out", help="output GGUF path")
    p.add_argument("--ftype", choices=sorted(FTYPES), default="f16")
    p.add_argument("-q", "--quiet", action="store_true")
    args = p.parse_args(argv)
    log = (lambda *a: None) if args.quiet else (lambda *a: print(*a, file=sys.stderr))
    convert(args.model_dir, args.out, FTYPES[args.ftype], log=log)
    return 0


if __name__ == "__main__":
    sys.exit(main())
