"""GGUF format constants.

Re-implementation of the GGUF v2/v3 on-disk format used by the reference
(ref: ggml.h:1975-2012 `gguf_type`, ggml.h:232-240 magic/version, and the
public GGUF spec). Independent implementation: enum values are part of the
public file format, not code.
"""

from __future__ import annotations

import enum

GGUF_MAGIC = 0x46554747  # little-endian bytes b"GGUF"
GGUF_DEFAULT_ALIGNMENT = 32
GGUF_VERSION = 3
SUPPORTED_GGUF_VERSIONS = (2, 3)


class GGUFValueType(enum.IntEnum):
    """K/V metadata value types (ref: ggml.h:1989-2005)."""

    UINT8 = 0
    INT8 = 1
    UINT16 = 2
    INT16 = 3
    UINT32 = 4
    INT32 = 5
    FLOAT32 = 6
    BOOL = 7
    STRING = 8
    ARRAY = 9
    UINT64 = 10
    INT64 = 11
    FLOAT64 = 12


class GGMLQuantType(enum.IntEnum):
    """Tensor data types (ref: ggml.h:309-332 `ggml_type`)."""

    F32 = 0
    F16 = 1
    Q4_0 = 2
    Q4_1 = 3
    # 4, 5: removed upstream
    Q5_0 = 6
    Q5_1 = 7
    Q8_0 = 8
    Q8_1 = 9
    Q2_K = 10
    Q3_K = 11
    Q4_K = 12
    Q5_K = 13
    Q6_K = 14
    Q8_K = 15
    I8 = 16
    I16 = 17
    I32 = 18


# Super-block size for k-quants (ref: ggml-quants.h:66-67; we only support
# the standard QK_K=256 build, not GGML_QKK_64).
QK_K = 256
K_SCALE_SIZE = 12

# (block_size_elems, block_size_bytes) per quant type
# (ref: ggml-quants.h struct layouts; ggml.c type_traits)
QUANT_BLOCK_INFO: dict[GGMLQuantType, tuple[int, int]] = {
    GGMLQuantType.F32: (1, 4),
    GGMLQuantType.F16: (1, 2),
    GGMLQuantType.Q4_0: (32, 2 + 16),
    GGMLQuantType.Q4_1: (32, 2 + 2 + 16),
    GGMLQuantType.Q5_0: (32, 2 + 4 + 16),
    GGMLQuantType.Q5_1: (32, 2 + 2 + 4 + 16),
    GGMLQuantType.Q8_0: (32, 2 + 32),
    GGMLQuantType.Q8_1: (32, 4 + 4 + 32),
    GGMLQuantType.Q2_K: (QK_K, QK_K // 16 + QK_K // 4 + 2 + 2),
    GGMLQuantType.Q3_K: (QK_K, QK_K // 8 + QK_K // 4 + 12 + 2),
    GGMLQuantType.Q4_K: (QK_K, 2 + 2 + K_SCALE_SIZE + QK_K // 2),
    GGMLQuantType.Q5_K: (QK_K, 2 + 2 + K_SCALE_SIZE + QK_K // 8 + QK_K // 2),
    GGMLQuantType.Q6_K: (QK_K, QK_K // 2 + QK_K // 4 + QK_K // 16 + 2),
    GGMLQuantType.Q8_K: (QK_K, 4 + QK_K + QK_K // 16 * 2),
    GGMLQuantType.I8: (1, 1),
    GGMLQuantType.I16: (1, 2),
    GGMLQuantType.I32: (1, 4),
}


def type_size(qtype: GGMLQuantType, n_elems: int) -> int:
    """Bytes needed to store `n_elems` elements of `qtype` (row-padded to blocks)."""
    block_elems, block_bytes = QUANT_BLOCK_INFO[qtype]
    if n_elems % block_elems != 0:
        raise ValueError(f"{n_elems} not a multiple of block size {block_elems} for {qtype.name}")
    return n_elems // block_elems * block_bytes


# Standard metadata keys (subset used by the loader; public GGUF naming scheme)
class Keys:
    ARCHITECTURE = "general.architecture"
    NAME = "general.name"
    ALIGNMENT = "general.alignment"
    FILE_TYPE = "general.file_type"
    QUANT_VERSION = "general.quantization_version"

    CONTEXT_LENGTH = "{arch}.context_length"
    EMBEDDING_LENGTH = "{arch}.embedding_length"
    BLOCK_COUNT = "{arch}.block_count"
    FEED_FORWARD_LENGTH = "{arch}.feed_forward_length"
    ROPE_DIMENSION_COUNT = "{arch}.rope.dimension_count"
    ROPE_FREQ_BASE = "{arch}.rope.freq_base"
    ROPE_SCALING_TYPE = "{arch}.rope.scaling.type"
    ROPE_SCALING_FACTOR = "{arch}.rope.scaling.factor"
    ROPE_SCALING_ORIG_CTX = "{arch}.rope.scaling.original_context_length"
    ROPE_SCALE_LINEAR = "{arch}.rope.scale_linear"
    HEAD_COUNT = "{arch}.attention.head_count"
    HEAD_COUNT_KV = "{arch}.attention.head_count_kv"
    LAYER_NORM_EPS = "{arch}.attention.layer_norm_epsilon"
    LAYER_NORM_RMS_EPS = "{arch}.attention.layer_norm_rms_epsilon"
    CLAMP_KQV = "{arch}.attention.clamp_kqv"
    MAX_ALIBI_BIAS = "{arch}.attention.max_alibi_bias"

    TOKENIZER_MODEL = "tokenizer.ggml.model"
    TOKENIZER_LIST = "tokenizer.ggml.tokens"
    TOKENIZER_SCORES = "tokenizer.ggml.scores"
    TOKENIZER_TOKEN_TYPE = "tokenizer.ggml.token_type"
    TOKENIZER_MERGES = "tokenizer.ggml.merges"
    TOKENIZER_BOS_ID = "tokenizer.ggml.bos_token_id"
    TOKENIZER_EOS_ID = "tokenizer.ggml.eos_token_id"
    TOKENIZER_UNK_ID = "tokenizer.ggml.unknown_token_id"
    TOKENIZER_SEP_ID = "tokenizer.ggml.seperator_token_id"
    TOKENIZER_PAD_ID = "tokenizer.ggml.padding_token_id"
    TOKENIZER_ADD_BOS = "tokenizer.ggml.add_bos_token"
    TOKENIZER_ADD_EOS = "tokenizer.ggml.add_eos_token"
    TOKENIZER_FIM_PRE = "tokenizer.ggml.prefix_token_id"
    TOKENIZER_FIM_SUF = "tokenizer.ggml.suffix_token_id"
    TOKENIZER_FIM_MID = "tokenizer.ggml.middle_token_id"
