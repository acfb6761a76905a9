"""Model hyperparameters, populated from GGUF metadata
(ref: llama.cpp:2203-2386 `llm_load_hparams`)."""

from __future__ import annotations

import dataclasses

from ..gguf.constants import Keys
from ..gguf.reader import GGUFReader


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch: str
    n_vocab: int
    n_embd: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    n_ff: int
    head_dim: int
    rope_dims: int
    rope_mode: str  # "norm" | "neox" | "none"
    rope_base: float = 10000.0
    rope_scale: float = 1.0  # linear scaling (1/factor applied to angles)
    norm_eps: float = 1e-5
    norm_rms: bool = True
    n_ctx_train: int = 2048
    max_alibi_bias: float = 0.0
    clamp_kqv: float = 0.0
    parallel_residual: bool = False
    tok_norm: bool = False  # bloom embedding layernorm
    pos_embd: bool = False  # starcoder learned absolute positions
    ffn_act: str = "auto"  # "auto" (gate->silu else gelu) | "relu2" (persimmon)
    n_ctx_orig: int = 0  # yarn original training context (0 = n_ctx_train)
    # YaRN (ref: llama.h:186-196)
    yarn_ext_factor: float = 0.0
    yarn_attn_factor: float = 1.0
    yarn_beta_fast: float = 32.0
    yarn_beta_slow: float = 1.0

    @property
    def attn_scale(self) -> float:
        return self.head_dim ** -0.5


# per-architecture traits (ref: llama.cpp build_* graph builders —
# rope mode from their ggml_rope_custom calls, alibi from llm_build_kqv
# max_alibi_bias args, residual/norm structure from the builder shape)
_ARCH_TRAITS: dict[str, dict] = {
    "llama": dict(rope_mode="norm"),
    "baichuan": dict(rope_mode="norm"),  # 13B variant switches to alibi below
    "falcon": dict(rope_mode="neox", norm_rms=False, parallel_residual=True),
    "starcoder": dict(rope_mode="none", norm_rms=False, pos_embd=True),
    "persimmon": dict(rope_mode="neox", norm_rms=False, ffn_act="relu2"),
    "refact": dict(rope_mode="none", max_alibi_bias=8.0),
    "bloom": dict(rope_mode="none", norm_rms=False, tok_norm=True, max_alibi_bias=8.0),
    "mpt": dict(rope_mode="none", norm_rms=False, max_alibi_bias=8.0),
    "stablelm": dict(rope_mode="neox", norm_rms=False),
    "gptneox": dict(rope_mode="neox", norm_rms=False),
}
_ROPE_MODE = {k: v.get("rope_mode", "norm") for k, v in _ARCH_TRAITS.items()}


def config_from_gguf(r: GGUFReader) -> ModelConfig:
    arch = r.architecture
    n_embd = int(r.field(Keys.EMBEDDING_LENGTH))
    n_heads = int(r.field(Keys.HEAD_COUNT))
    n_kv = int(r.field(Keys.HEAD_COUNT_KV, n_heads))
    head_dim = n_embd // n_heads
    rope_dims = int(r.field(Keys.ROPE_DIMENSION_COUNT, head_dim) or head_dim)
    scale = r.field(Keys.ROPE_SCALING_FACTOR)
    if scale is None:
        scale = r.field(Keys.ROPE_SCALE_LINEAR)
    rope_scale = 1.0 / float(scale) if scale else 1.0
    scaling_type = str(r.field(Keys.ROPE_SCALING_TYPE, "linear") or "linear")
    # yarn: ext_factor 1 (ref: llama.cpp cparams derivation) + orig ctx len
    yarn_ext = 1.0 if scaling_type == "yarn" else 0.0
    n_ctx_orig = int(r.field(Keys.ROPE_SCALING_ORIG_CTX, 0) or 0)
    eps = r.field(Keys.LAYER_NORM_RMS_EPS)
    rms = eps is not None
    if eps is None:
        eps = r.field(Keys.LAYER_NORM_EPS, 1e-5)
    n_vocab = len(r.metadata.get(Keys.TOKENIZER_LIST, [])) or int(
        r.metadata.get("general.vocab_size", 0)
    )
    if not n_vocab and "token_embd.weight" in r.tensors:
        n_vocab = r.tensors["token_embd.weight"].shape[0]
    traits = dict(_ARCH_TRAITS.get(arch, {}))
    n_layers = int(r.field(Keys.BLOCK_COUNT))
    if arch == "baichuan" and n_layers >= 40:
        # Baichuan-13B drops rope for alibi (ref: build_baichuan MODEL_13B)
        traits.update(rope_mode="none", max_alibi_bias=8.0)
    # metadata overrides traits where present
    if rms or r.field(Keys.LAYER_NORM_RMS_EPS) is not None:
        traits.setdefault("norm_rms", True)
    else:
        traits["norm_rms"] = traits.get("norm_rms", False)
    alibi_md = r.field(Keys.MAX_ALIBI_BIAS)
    if alibi_md is not None:
        traits["max_alibi_bias"] = float(alibi_md)
    return ModelConfig(
        arch=arch,
        n_vocab=n_vocab,
        n_embd=n_embd,
        n_layers=n_layers,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        n_ff=int(r.field(Keys.FEED_FORWARD_LENGTH, 4 * n_embd)),
        head_dim=head_dim,
        rope_dims=rope_dims,
        rope_base=float(r.field(Keys.ROPE_FREQ_BASE, 10000.0) or 10000.0),
        rope_scale=rope_scale,
        norm_eps=float(eps),
        n_ctx_train=int(r.field(Keys.CONTEXT_LENGTH, 2048) or 2048),
        n_ctx_orig=n_ctx_orig,
        yarn_ext_factor=yarn_ext,
        clamp_kqv=float(r.field(Keys.CLAMP_KQV, 0.0) or 0.0),
        **{
            "rope_mode": traits.get("rope_mode", "norm"),
            "norm_rms": traits.get("norm_rms", rms),
            "max_alibi_bias": traits.get("max_alibi_bias", 0.0),
            "parallel_residual": traits.get("parallel_residual", False),
            "tok_norm": traits.get("tok_norm", False),
            "pos_embd": traits.get("pos_embd", False),
            "ffn_act": traits.get("ffn_act", "auto"),
        },
    )
