"""`pipeinfer-convert-llama2c` — Karpathy llama2.c checkpoint → GGUF
(ref: examples/convert-llama2c-to-ggml/convert-llama2c-to-ggml.cpp).
The llama2.c `.bin` is 7 little-endian int32 hparams (dim, hidden_dim,
n_layers, n_heads, n_kv_heads, vocab_size, seq_len; negative vocab_size
means a separate output classifier follows) + f32 weights in fixed order;
weights are already [out, in] row-major with ggml adjacent-pair RoPE, so
no permutation is needed (the reference converter copies verbatim too).
Vocabulary comes from a GGUF model or a llama2.c `tokenizer.bin`
(score + len + bytes records, whitespace escaped to ▁, byte tokens kept
— ref :552-637).

A copy of pipeinfer_tpu.tools.convert_llama2c, which imports no JAX: the
same GGUF bytes for the same checkpoint, on the host."""

from __future__ import annotations

import argparse
import struct
import sys
from pathlib import Path

import numpy as np

UNKNOWN_TOKEN_ID, BOS_TOKEN_ID, EOS_TOKEN_ID = 0, 1, 2


def read_llama2c(path) -> tuple[dict, dict]:
    """Returns (hparams dict, weights dict in our slot names)."""
    with open(path, "rb") as f:
        dim, hidden, n_layers, n_heads, n_kv, vocab, seq_len = struct.unpack(
            "<7i", f.read(28)
        )
        shared_classifier = vocab > 0
        vocab = abs(vocab)
        head = dim // n_heads
        kv_dim = n_kv * head

        def arr(*shape):
            n = int(np.prod(shape))
            a = np.frombuffer(f.read(4 * n), "<f4", n)
            if a.size != n:
                raise ValueError(f"{path}: truncated checkpoint")
            return a.reshape(shape).copy()

        w = {}
        w["tok_embd"] = arr(vocab, dim)
        att_norm = arr(n_layers, dim)
        wq = arr(n_layers, dim, dim)
        wk = arr(n_layers, kv_dim, dim)
        wv = arr(n_layers, kv_dim, dim)
        wo = arr(n_layers, dim, dim)
        ffn_norm = arr(n_layers, dim)
        w1 = arr(n_layers, hidden, dim)  # gate
        w2 = arr(n_layers, dim, hidden)  # down
        w3 = arr(n_layers, hidden, dim)  # up
        w["output_norm"] = arr(dim)
        arr(seq_len, head // 2)  # legacy freq_cis_real (unused)
        arr(seq_len, head // 2)  # legacy freq_cis_imag (unused)
        w["output"] = w["tok_embd"].copy() if shared_classifier else arr(vocab, dim)
        for i in range(n_layers):
            w[f"layers.{i}.attn_norm"] = att_norm[i]
            w[f"layers.{i}.wq"] = wq[i]
            w[f"layers.{i}.wk"] = wk[i]
            w[f"layers.{i}.wv"] = wv[i]
            w[f"layers.{i}.wo"] = wo[i]
            w[f"layers.{i}.ffn_norm"] = ffn_norm[i]
            w[f"layers.{i}.w_gate"] = w1[i]
            w[f"layers.{i}.w_down"] = w2[i]
            w[f"layers.{i}.w_up"] = w3[i]
    hp = dict(dim=dim, hidden=hidden, n_layers=n_layers, n_heads=n_heads,
              n_kv_heads=n_kv, vocab=vocab, seq_len=seq_len)
    return hp, w


def read_tokenizer_bin(path, n_vocab) -> tuple[list[str], list[float], list[int]]:
    """llama2.c tokenizer.bin → (pieces, scores, types) with the reference's
    canonicalization (ref :597-637)."""
    tokens, scores, types = [], [], []
    with open(path, "rb") as f:
        f.read(4)  # max_token_length, unused
        for tid in range(n_vocab):
            (score,) = struct.unpack("<f", f.read(4))
            (ln,) = struct.unpack("<i", f.read(4))
            text = f.read(ln).decode("utf-8", errors="replace")
            ttype = 1  # NORMAL
            if tid == UNKNOWN_TOKEN_ID:
                text, ttype = "<unk>", 2
            elif tid == BOS_TOKEN_ID:
                text, ttype = "<s>", 3
            elif tid == EOS_TOKEN_ID:
                text, ttype = "</s>", 3
            elif not text:
                ttype = 3
            elif len(text) == 6 and text.startswith("<0x") and text.endswith(">"):
                ttype = 6  # BYTE
            text = text.replace(" ", "▁")  # llama_escape_whitespaces
            tokens.append(text)
            scores.append(float(score))
            types.append(ttype)
    return tokens, scores, types


def convert(bin_path, vocab_path, out_path, *, n_ctx: int | None = None):
    from ..gguf.constants import Keys
    from ..gguf.reader import GGUFReader
    from .testmodel import write_llama_gguf

    hp, w = read_llama2c(bin_path)
    extra_kv = {}
    vocab_tokens = None
    if vocab_path:
        try:
            with GGUFReader(vocab_path) as r:
                vocab_tokens = list(r.metadata[Keys.TOKENIZER_LIST])
                for key in (Keys.TOKENIZER_MODEL, Keys.TOKENIZER_SCORES,
                            Keys.TOKENIZER_TOKEN_TYPE):
                    if key in r.metadata:
                        extra_kv[key] = r.metadata[key]
        except ValueError:
            # not a GGUF: assume llama2.c tokenizer.bin (ref :597)
            print(f"assuming llama2.c vocabulary: {vocab_path}", file=sys.stderr)
            tokens, scores, types = read_tokenizer_bin(vocab_path, hp["vocab"])
            vocab_tokens = tokens
            extra_kv[Keys.TOKENIZER_MODEL] = "llama"
            extra_kv[Keys.TOKENIZER_SCORES] = scores
            extra_kv[Keys.TOKENIZER_TOKEN_TYPE] = types
        if vocab_tokens is not None and len(vocab_tokens) != hp["vocab"]:
            if len(vocab_tokens) < hp["vocab"]:
                raise SystemExit(
                    f"error: vocab has {len(vocab_tokens)} tokens, model needs {hp['vocab']}"
                )
            vocab_tokens = vocab_tokens[: hp["vocab"]]

    write_llama_gguf(
        out_path, w,
        n_layers=hp["n_layers"], n_embd=hp["dim"], n_heads=hp["n_heads"],
        n_kv_heads=hp["n_kv_heads"], n_ff=hp["hidden"], n_vocab=hp["vocab"],
        n_ctx=n_ctx or hp["seq_len"],
        vocab_tokens=vocab_tokens, extra_kv=extra_kv or None,
    )
    return hp


def main(argv=None):
    p = argparse.ArgumentParser("pipeinfer-convert-llama2c", description=__doc__)
    p.add_argument("--copy-vocab-from-model", default="",
                   help="GGUF model or llama2.c tokenizer.bin to take the vocab from")
    p.add_argument("--llama2c-model", required=True, help="llama2.c .bin checkpoint")
    p.add_argument("--llama2c-output-model", required=True, help="output GGUF")
    args = p.parse_args(argv)
    hp = convert(args.llama2c_model, args.copy_vocab_from_model,
                 args.llama2c_output_model)
    print(f"converted dim={hp['dim']} layers={hp['n_layers']} vocab={hp['vocab']} "
          f"-> {args.llama2c_output_model}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
