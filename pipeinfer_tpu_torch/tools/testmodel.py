"""Synthetic tiny-model GGUF builders for tests and benchmarks.

The counterpart of the reference's fixture pattern (vocab-only GGUFs,
tests/CMakeLists.txt:25-40) extended to full tiny models, plus an HF→GGUF
weight exporter used for logit-parity tests against transformers.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np

from ..gguf.constants import GGMLQuantType, Keys
from ..gguf.writer import GGUFWriter


def permute_for_ggml_rope(w: np.ndarray, n_head: int) -> np.ndarray:
    """HF rotate-half layout -> ggml adjacent-pair layout for q/k weights
    (the inverse convention of convert.py permute(); independent impl)."""
    out_dim = w.shape[0]
    head_dim = out_dim // n_head
    w4 = w.reshape(n_head, 2, head_dim // 2, -1)
    return np.ascontiguousarray(w4.swapaxes(1, 2).reshape(w.shape))


def write_llama_gguf(
    path: str | Path,
    weights: dict[str, np.ndarray],
    *,
    n_layers: int,
    n_embd: int,
    n_heads: int,
    n_kv_heads: int,
    n_ff: int,
    n_vocab: int,
    rope_base: float = 10000.0,
    norm_eps: float = 1e-5,
    n_ctx: int = 2048,
    qtype: GGMLQuantType = GGMLQuantType.F32,
    quantize_2d_only: bool = True,
    vocab_tokens: list[str] | None = None,
    extra_kv: dict | None = None,
):
    """weights uses our slot names: tok_embd, output, output_norm, and
    layers.<i>.<slot> with slots from models.llama.LAYER_TENSOR_MAP values."""
    w = GGUFWriter(path, "llama")
    w.add_arch_kv(Keys.EMBEDDING_LENGTH, n_embd)
    w.add_arch_kv(Keys.BLOCK_COUNT, n_layers)
    w.add_arch_kv(Keys.HEAD_COUNT, n_heads)
    w.add_arch_kv(Keys.HEAD_COUNT_KV, n_kv_heads)
    w.add_arch_kv(Keys.FEED_FORWARD_LENGTH, n_ff)
    w.add_arch_kv(Keys.CONTEXT_LENGTH, n_ctx)
    w.add_arch_kv(Keys.ROPE_DIMENSION_COUNT, n_embd // n_heads)
    w.add_arch_kv(Keys.ROPE_FREQ_BASE, float(rope_base))
    w.add_arch_kv(Keys.LAYER_NORM_RMS_EPS, float(norm_eps))
    w.add_kv("general.vocab_size", n_vocab)
    if vocab_tokens is not None:
        w.add_kv(Keys.TOKENIZER_LIST, vocab_tokens)
        if not extra_kv or Keys.TOKENIZER_MODEL not in extra_kv:
            w.add_kv(Keys.TOKENIZER_MODEL, "llama")
        if not extra_kv or Keys.TOKENIZER_SCORES not in extra_kv:
            w.add_kv(Keys.TOKENIZER_SCORES, np.zeros(len(vocab_tokens), dtype=np.float32))
        if not extra_kv or Keys.TOKENIZER_TOKEN_TYPE not in extra_kv:
            w.add_kv(Keys.TOKENIZER_TOKEN_TYPE, np.ones(len(vocab_tokens), dtype=np.int32))
    if extra_kv:
        for k, v in extra_kv.items():
            w.add_kv(k, v)

    slot_to_gname = {
        "tok_embd": "token_embd.weight",
        "output_norm": "output_norm.weight",
        "output": "output.weight",
    }
    layer_slot_to_suffix = {
        "attn_norm": "attn_norm.weight",
        "wq": "attn_q.weight",
        "wk": "attn_k.weight",
        "wv": "attn_v.weight",
        "wo": "attn_output.weight",
        "ffn_norm": "ffn_norm.weight",
        "w_gate": "ffn_gate.weight",
        "w_down": "ffn_down.weight",
        "w_up": "ffn_up.weight",
    }
    for name, arr in weights.items():
        if name.startswith("layers."):
            _, idx, slot = name.split(".")
            gname = f"blk.{idx}.{layer_slot_to_suffix[slot]}"
        else:
            gname = slot_to_gname[name]
        qt = qtype
        if quantize_2d_only and (arr.ndim != 2 or arr.shape[-1] % 256 != 0):
            qt = GGMLQuantType.F32
        w.add_tensor(gname, arr.astype(np.float32), qtype=qt)
    w.write()


def random_llama_weights(
    rng: np.random.Generator,
    *,
    n_layers: int,
    n_embd: int,
    n_heads: int,
    n_kv_heads: int,
    n_ff: int,
    n_vocab: int,
    scale: float = 0.08,
) -> dict[str, np.ndarray]:
    head_dim = n_embd // n_heads
    kv_dim = n_kv_heads * head_dim

    def r(*shape):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    w = {
        "tok_embd": r(n_vocab, n_embd),
        "output_norm": np.ones(n_embd, np.float32),
        "output": r(n_vocab, n_embd),
    }
    for i in range(n_layers):
        w[f"layers.{i}.attn_norm"] = np.ones(n_embd, np.float32)
        w[f"layers.{i}.wq"] = r(n_embd, n_embd)
        w[f"layers.{i}.wk"] = r(kv_dim, n_embd)
        w[f"layers.{i}.wv"] = r(kv_dim, n_embd)
        w[f"layers.{i}.wo"] = r(n_embd, n_embd)
        w[f"layers.{i}.ffn_norm"] = np.ones(n_embd, np.float32)
        w[f"layers.{i}.w_gate"] = r(n_ff, n_embd)
        w[f"layers.{i}.w_up"] = r(n_ff, n_embd)
        w[f"layers.{i}.w_down"] = r(n_embd, n_ff)
    return w


BENCH_SCALES = {
    # llama-2 7B exact shapes (ref: BASELINE.md 7B+1.1B primary config);
    # draft = the target's lower stack (5/32 layers ~= the 1.1B/7B cost
    # ratio of the TinyLlama pairing)
    "7b": dict(
        target=dict(n_layers=32, n_embd=4096, n_heads=32, n_kv_heads=32,
                    n_ff=11008, n_vocab=32000),
        draft_layers=5,
    ),
    # llama-2 13B exact shapes (ref: BASELINE.json XWinLM-13B + 7B-class
    # draft config); draft = lower 12/40 layers ~= the 7B/13B cost ratio
    "13b": dict(
        target=dict(n_layers=40, n_embd=5120, n_heads=40, n_kv_heads=40,
                    n_ff=13824, n_vocab=32000),
        draft_layers=12,
    ),
    # ~220M toy (round-1 bench scale; fast CI-able sanity runs)
    "toy": dict(
        target=dict(n_layers=12, n_embd=1024, n_heads=16, n_kv_heads=8,
                    n_ff=2816, n_vocab=32000),
        draft_layers=3,
    ),
    # unit-test scale: the same margin/eps design at seconds-per-run CPU
    # cost (known per-token acceptance ~1-eps for estimator tests)
    "nano": dict(
        target=dict(n_layers=4, n_embd=256, n_heads=4, n_kv_heads=2,
                    n_ff=512, n_vocab=2048),
        draft_layers=2,
    ),
}


def synthetic_spm_vocab(n_vocab: int, seed: int = 0) -> dict:
    """Tokenizer metadata of a synthetic SentencePiece (llama) vocabulary
    of exactly n_vocab tokens, made from `seed`: <unk>, <s> and </s>, the
    256 byte tokens <0x00>..<0xFF> (byte fallback), "▁" and the 26 lowercase
    letters, then unique "▁"-pieces with descending scores, each one a
    shorter piece plus one letter (so SPM's bigram merges can reach every
    piece). Anything else (capitals, digits, punctuation) falls back to
    byte tokens."""
    from ..tokenizer.vocab import TokenType as T

    letters = "abcdefghijklmnopqrstuvwxyz"
    tokens = ["<unk>", "<s>", "</s>"] + [f"<0x{b:02X}>" for b in range(256)]
    types = [T.UNKNOWN, T.CONTROL, T.CONTROL] + [T.BYTE] * 256
    pieces = ["▁"] + list(letters) + ["▁" + c for c in letters]
    seen = set(pieces)
    rng = np.random.default_rng(seed)
    while len(tokens) + len(pieces) < n_vocab:
        # grow one of the "▁"-pieces (pieces[27:]) by a letter
        cand = pieces[27 + rng.integers(len(pieces) - 27)] + letters[rng.integers(26)]
        if cand not in seen:
            seen.add(cand)
            pieces.append(cand)
    pieces = pieces[: n_vocab - len(tokens)]
    scores = [0.0] * len(tokens) + [-float(i) for i in range(len(pieces))]
    return {
        Keys.TOKENIZER_MODEL: "llama",
        Keys.TOKENIZER_LIST: tokens + pieces,
        Keys.TOKENIZER_SCORES: np.asarray(scores, np.float32),
        Keys.TOKENIZER_TOKEN_TYPE: np.asarray(types + [T.NORMAL] * len(pieces), np.int32),
        Keys.TOKENIZER_UNK_ID: 0,
        Keys.TOKENIZER_BOS_ID: 1,
        Keys.TOKENIZER_EOS_ID: 2,
    }


FIM_PIECES = ("▁<PRE>", "▁<SUF>", "▁<MID>")  # CodeLlama's fill-in-middle specials


def with_fim_ids(src: str | Path, dst: str | Path) -> Path:
    """A copy of the GGUF model `src` (tensors byte for byte) whose
    vocabulary's last three tokens are the fill-in-middle specials
    FIM_PIECES, as control tokens, with the prefix, suffix and middle ids
    in its metadata: the vocabulary infill (cli.main --fim-prefix /
    --fim-suffix, cli.infill) needs. Written to dst; returns dst."""
    from ..gguf.reader import GGUFReader
    from ..tokenizer.vocab import TokenType

    with GGUFReader(src) as r:
        meta = {k: v for k, v in r.metadata.items() if k not in (Keys.ARCHITECTURE, Keys.ALIGNMENT)}
        tokens = list(meta[Keys.TOKENIZER_LIST])
        types = np.array(meta[Keys.TOKENIZER_TOKEN_TYPE], np.int32)
        ids = range(len(tokens) - 3, len(tokens))
        for i, piece in zip(ids, FIM_PIECES):
            tokens[i] = piece
            types[i] = TokenType.CONTROL
        meta[Keys.TOKENIZER_LIST] = tokens
        meta[Keys.TOKENIZER_TOKEN_TYPE] = types
        for key, i in zip((Keys.TOKENIZER_FIM_PRE, Keys.TOKENIZER_FIM_SUF,
                           Keys.TOKENIZER_FIM_MID), ids):
            meta[key] = i
        w = GGUFWriter(Path(dst), r.architecture)
        for key, val in meta.items():
            w.add_kv(key, val)
        for name, info in r.tensors.items():
            w.add_tensor(name, bytes(r.tensor_bytes(name)), shape=info.shape, qtype=info.qtype)
        w.write()
    return Path(dst)


def build_bench_pair(
    tgt_path: str | Path,
    dft_path: str | Path,
    *,
    scale: str = "7b",
    eps: float = 0.0,
    qtype: GGMLQuantType = GGMLQuantType.Q4_K,
    seed: int = 42,
    vocab: bool = False,
    log=lambda *a: None,
):
    """Synthetic benchmark pair at production shapes.

    The target's lower `draft_layers` form the draft model. Every layer's
    residual contribution is zeroed (wo, w_down = 0 — still quantized,
    streamed, and multiplied at full FLOPs/bytes; XLA cannot fold runtime
    buffer contents), and the output head is built so token t maps to
    perm[t] with a large deterministic logit margin: output[perm[t]] =
    L * normalize(embed[t]). Random dense weights would give near-uniform
    logits whose argmax flips under the tiny numeric differences between
    the draft's device-resident chain program and the target's batched
    verify program — acceptance would measure XLA reduction order, not
    speculation (the round-1 "67.7% acceptance with a bit-exact draft"
    mystery).

    eps controls DRAFT QUALITY deterministically: the draft model's output
    head uses a permutation that disagrees with the target's on an
    eps-fraction of tokens, so per-token acceptance is ~(1-eps), the
    target itself stays margin-clean (greedy output identical to the
    sequential baseline by construction), and eps>0 exercises divergence,
    cancellation, and the dead-work meter at any scale. (An earlier design
    eps-perturbed the target's upper layers — that degrades the TARGET
    into near-uniform logits, measuring numeric jitter again.)

    Upper layers share ONE template layer's weights — identical content,
    distinct HBM buffers, so per-step FLOPs and memory traffic are exactly
    those of a dense model while the host only quantizes ~2 unique layers
    (7B quantize in ~1 min, not ~30).

    vocab: also write a synthetic SPM vocabulary of n_vocab tokens
    (synthetic_spm_vocab) into both files, so the CLIs can tokenize."""
    from ..quant.formats import quantize

    sc = BENCH_SCALES[scale]
    shape = sc["target"]
    dl = sc["draft_layers"]
    n_layers = shape["n_layers"]
    rng = np.random.default_rng(seed)
    e, ff, v = shape["n_embd"], shape["n_ff"], shape["n_vocab"]
    kv_dim = shape["n_kv_heads"] * (e // shape["n_heads"])

    def r(*s):
        return (rng.standard_normal(s, dtype=np.float32) * 0.08)

    def layer_slots():
        return {
            "attn_norm": np.ones(e, np.float32),
            "wq": r(e, e), "wk": r(kv_dim, e), "wv": r(kv_dim, e),
            "wo": np.zeros((e, e), np.float32),
            "ffn_norm": np.ones(e, np.float32),
            "w_gate": r(ff, e), "w_up": r(ff, e),
            "w_down": np.zeros((e, ff), np.float32),
        }

    draft_layer = layer_slots()  # shared by ALL lower (draft) layers
    upper = layer_slots()

    embed = r(v, e)
    u = embed / np.linalg.norm(embed, axis=1, keepdims=True)
    perm = rng.permutation(v)
    # residual stream stays embed[t]; logits[j] = output[j]·RMSNorm(embed[t])
    # = 0.5*sqrt(e)*(u[argsort(perm)][j]·u[t]), peaked at j=perm[t] with
    # margin ~0.5*sqrt(e)*(1 - max cross-correlation) >> any numeric jitter
    output = (0.5 * u[np.argsort(perm)]).astype(np.float32)
    # draft head: same margin design over perm_d, which disagrees with perm
    # on ~eps of the vocabulary (per-token acceptance ~ 1-eps)
    if eps:
        n_bad = max(1, int(round(eps * v)))
        bad = rng.choice(v, size=n_bad, replace=False)
        perm_d = perm.copy()
        perm_d[bad] = perm[np.roll(bad, 1)]
        output_d = (0.5 * u[np.argsort(perm_d)]).astype(np.float32)
    else:
        output_d = output
    globals_ = {"tok_embd": embed, "output_norm": np.ones(e, np.float32),
                "output": output}
    globals_d = dict(globals_, output=output_d)

    memo: dict[int, bytes] = {}
    vocab_kv = synthetic_spm_vocab(v, seed) if vocab else {}

    def qbytes(arr):
        key = id(arr)
        if key not in memo:
            qt = qtype if (arr.ndim == 2 and arr.shape[-1] % 256 == 0) else GGMLQuantType.F32
            memo[key] = (qt, np.asarray(quantize(arr, qt)).tobytes())
        return memo[key]

    def write(path, layers, cfg_layers, globals_):
        w = GGUFWriter(path, "llama")
        w.add_arch_kv(Keys.EMBEDDING_LENGTH, e)
        w.add_arch_kv(Keys.BLOCK_COUNT, cfg_layers)
        w.add_arch_kv(Keys.HEAD_COUNT, shape["n_heads"])
        w.add_arch_kv(Keys.HEAD_COUNT_KV, shape["n_kv_heads"])
        w.add_arch_kv(Keys.FEED_FORWARD_LENGTH, ff)
        w.add_arch_kv(Keys.CONTEXT_LENGTH, 4096)
        w.add_arch_kv(Keys.ROPE_DIMENSION_COUNT, e // shape["n_heads"])
        w.add_arch_kv(Keys.ROPE_FREQ_BASE, 10000.0)
        w.add_arch_kv(Keys.LAYER_NORM_RMS_EPS, 1e-5)
        w.add_kv("general.vocab_size", v)
        for key, val in vocab_kv.items():
            w.add_kv(key, val)
        slot_suffix = {
            "attn_norm": "attn_norm.weight", "wq": "attn_q.weight",
            "wk": "attn_k.weight", "wv": "attn_v.weight", "wo": "attn_output.weight",
            "ffn_norm": "ffn_norm.weight", "w_gate": "ffn_gate.weight",
            "w_down": "ffn_down.weight", "w_up": "ffn_up.weight",
        }
        for name, arr in globals_.items():
            gname = {"tok_embd": "token_embd.weight", "output_norm": "output_norm.weight",
                     "output": "output.weight"}[name]
            qt, payload = qbytes(arr)
            w.add_tensor(gname, payload, shape=arr.shape, qtype=qt)
        for li, lw in enumerate(layers):
            for slot, arr in lw.items():
                qt, payload = qbytes(arr)
                w.add_tensor(f"blk.{li}.{slot_suffix[slot]}", payload,
                             shape=arr.shape, qtype=qt)
        w.write()

    import time as _t

    t0 = _t.time()
    write(tgt_path, [draft_layer] * dl + [upper] * (n_layers - dl), n_layers, globals_)
    write(dft_path, [draft_layer] * dl, dl, globals_d)
    log(f"built {scale} bench pair in {_t.time() - t0:.1f}s "
        f"(eps={eps}, {n_layers}L target / {dl}L draft)")
    return Path(tgt_path), Path(dft_path)


LLAMA_LIVE_LAYERS = 2


def build_llama_live(path: str | Path, like: str | Path, *, n_layers: int = LLAMA_LIVE_LAYERS,
                     seed: int = 7, log=lambda *a: None) -> Path:
    """A live llama model of the widths of `like` (a build_bench_pair
    target): its metadata, vocabulary, token embedding, output norm and
    head as they are in `like`, and n_layers copies of one random layer
    whose projections, attn_output and ffn_down too, are non-zero and drawn
    at 1/sqrt(fan_in), quantized to `like`'s ffn_down format. Attention and
    the FFN then reach the logits, and the attention scores of the normed
    activations spread by about one, so attention stays soft (as in
    build_mpt_bench_pair's live model)."""
    from ..quant.formats import quantize
    from ..gguf.reader import GGUFReader

    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    with GGUFReader(like) as r:
        arch = r.architecture
        meta = {k: v for k, v in r.metadata.items() if k not in (Keys.ARCHITECTURE, Keys.ALIGNMENT)}
        e = int(meta[Keys.EMBEDDING_LENGTH.format(arch=arch)])
        ff = int(meta[Keys.FEED_FORWARD_LENGTH.format(arch=arch)])
        kv_dim = e // int(meta[Keys.HEAD_COUNT.format(arch=arch)]) * int(
            meta[Keys.HEAD_COUNT_KV.format(arch=arch)])
        qt = r.tensors["blk.0.ffn_down.weight"].qtype
        meta[Keys.BLOCK_COUNT.format(arch=arch)] = n_layers
        w = GGUFWriter(Path(path), arch)
        for key, val in meta.items():
            w.add_kv(key, val)
        for name in ("token_embd.weight", "output_norm.weight", "output.weight"):
            info = r.tensors[name]
            w.add_tensor(name, bytes(r.tensor_bytes(name)), shape=info.shape, qtype=info.qtype)

    def proj(n_out, fan_in):
        arr = rng.standard_normal((n_out, fan_in), dtype=np.float32) / np.float32(fan_in ** 0.5)
        return np.asarray(quantize(arr, qt)).tobytes(), (n_out, fan_in)

    layer = {"attn_q.weight": proj(e, e), "attn_k.weight": proj(kv_dim, e),
             "attn_v.weight": proj(kv_dim, e), "attn_output.weight": proj(e, e),
             "ffn_gate.weight": proj(ff, e), "ffn_up.weight": proj(ff, e),
             "ffn_down.weight": proj(e, ff)}
    for li in range(n_layers):
        for norm in ("attn_norm.weight", "ffn_norm.weight"):
            w.add_tensor(f"blk.{li}.{norm}", np.ones(e, np.float32))
        for name, (payload, shape) in layer.items():
            w.add_tensor(f"blk.{li}.{name}", payload, shape=shape, qtype=qt)
    w.write()
    log(f"built a {n_layers}-layer live llama of {Path(like).name}'s widths in "
        f"{time.perf_counter() - t0:.1f}s")
    return Path(path)


def build_tiny_llama(
    path: str | Path,
    *,
    seed: int = 0,
    n_layers: int = 2,
    n_embd: int = 64,
    n_heads: int = 4,
    n_kv_heads: int = 2,
    n_ff: int = 128,
    n_vocab: int = 256,
    qtype: GGMLQuantType = GGMLQuantType.F32,
    vocab_from: str | Path | None = None,
    weights: dict[str, np.ndarray] | None = None,
) -> Path:
    """Random tiny model; with vocab_from, embeds a real SPM vocab (e.g. the
    reference's ggml-vocab-llama.gguf fixture) so tokenization works."""
    vocab_tokens = None
    vocab_extra = {}
    if vocab_from is not None:
        from ..gguf.constants import Keys
        from ..gguf.reader import GGUFReader

        with GGUFReader(vocab_from) as r:
            vocab_tokens = list(r.metadata[Keys.TOKENIZER_LIST])
            vocab_extra = {
                Keys.TOKENIZER_SCORES: np.asarray(r.metadata[Keys.TOKENIZER_SCORES], np.float32),
                Keys.TOKENIZER_TOKEN_TYPE: np.asarray(
                    r.metadata[Keys.TOKENIZER_TOKEN_TYPE], np.int32
                ),
                Keys.TOKENIZER_MODEL: r.metadata[Keys.TOKENIZER_MODEL],
            }
            for k in (Keys.TOKENIZER_BOS_ID, Keys.TOKENIZER_EOS_ID, Keys.TOKENIZER_UNK_ID):
                if k in r.metadata:
                    vocab_extra[k] = r.metadata[k]
        n_vocab = len(vocab_tokens)

    rng = np.random.default_rng(seed)
    if weights is None:
        weights = random_llama_weights(
            rng,
            n_layers=n_layers,
            n_embd=n_embd,
            n_heads=n_heads,
            n_kv_heads=n_kv_heads,
            n_ff=n_ff,
            n_vocab=n_vocab,
        )
    write_llama_gguf(
        path,
        weights,
        n_layers=n_layers,
        n_embd=n_embd,
        n_heads=n_heads,
        n_kv_heads=n_kv_heads,
        n_ff=n_ff,
        n_vocab=n_vocab,
        qtype=qtype,
        vocab_tokens=vocab_tokens,
        extra_kv=vocab_extra,
    )
    return Path(path)


# ---------------------------------------------------------------------------
# the other architectures (models/generic.py)
# ---------------------------------------------------------------------------

# Per-architecture tensor sets and metadata, as llama.cpp's llm_load_tensors
# reads them: "norm" LayerNorm (with "norm_b": biases) or RMSNorm, "qkv"
# fused attn_qkv or split attn_q/k/v, "ffn" gated (ffn_gate) or
# sequential (ffn_up/ffn_down), "bias": biases on every projection,
# "qkv_bias": biases on the split q/k/v only, "rope_frac": the share of
# the head width rotated (ROPE_DIMENSION_COUNT).
ARCH_LAYOUTS = {
    "baichuan": dict(norm="rms", qkv=False, ffn="gated"),
    "refact": dict(norm="rms", qkv=False, ffn="gated"),
    "falcon": dict(norm="ln", norm_b=True, qkv=True, ffn="seq"),
    "starcoder": dict(norm="ln", norm_b=True, qkv=True, ffn="seq", bias=True, pos_embd=True),
    "persimmon": dict(norm="ln", norm_b=True, qkv=True, ffn="seq", bias=True, qk_norm=True,
                      rope_frac=0.5),
    "bloom": dict(norm="ln", norm_b=True, qkv=True, ffn="seq", bias=True, tok_norm=True),
    "mpt": dict(norm="ln", qkv=True, ffn="seq"),
    "stablelm": dict(norm="ln", norm_b=True, qkv=False, ffn="gated", qkv_bias=True,
                     rope_frac=0.25),
    "gptneox": dict(norm="ln", norm_b=True, qkv=True, ffn="seq", bias=True, rope_frac=0.25),
}


def random_arch_weights(rng: np.random.Generator, arch: str, *, n_layers: int, n_embd: int,
                        n_heads: int, n_kv_heads: int, n_ff: int, n_vocab: int, n_ctx: int = 512,
                        attn_norm_2: bool = False, scale: float = 0.08) -> dict[str, np.ndarray]:
    """Random weights of a model of `arch` under their GGUF tensor names
    (token_embd.weight, blk.<i>.attn_qkv.bias, ...). Norm weights are 1 +
    noise, biases small. attn_norm_2: Falcon-40B's second attention norm."""
    lay = ARCH_LAYOUTS[arch]
    head_dim = n_embd // n_heads
    kv_dim = n_kv_heads * head_dim

    def r(*shape, s=scale):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    def norm(name, width):
        out = {f"{name}.weight": 1.0 + r(width, s=0.1)}
        if lay.get("norm_b"):
            out[f"{name}.bias"] = r(width, s=0.05)
        return out

    def proj(name, n_out, n_in, bias=lay.get("bias", False)):
        out = {f"{name}.weight": r(n_out, n_in)}
        if bias:
            out[f"{name}.bias"] = r(n_out, s=0.05)
        return out

    w = {"token_embd.weight": r(n_vocab, n_embd, s=1.0), "output.weight": r(n_vocab, n_embd)}
    w.update(norm("output_norm", n_embd))
    if lay.get("tok_norm"):
        w.update(norm("token_embd_norm", n_embd))
    if lay.get("pos_embd"):
        w["position_embd.weight"] = r(n_ctx, n_embd, s=0.5)
    for i in range(n_layers):
        b = f"blk.{i}."
        w.update(norm(b + "attn_norm", n_embd))
        if attn_norm_2:
            w.update(norm(b + "attn_norm_2", n_embd))
        if lay["qkv"]:
            w.update(proj(b + "attn_qkv", n_embd + 2 * kv_dim, n_embd))
        else:
            qb = lay.get("bias", False) or lay.get("qkv_bias", False)
            w.update(proj(b + "attn_q", n_embd, n_embd, qb))
            w.update(proj(b + "attn_k", kv_dim, n_embd, qb))
            w.update(proj(b + "attn_v", kv_dim, n_embd, qb))
        if lay.get("qk_norm"):
            w[b + "attn_q_norm.weight"] = 1.0 + r(head_dim, s=0.1)
            w[b + "attn_q_norm.bias"] = r(head_dim, s=0.05)
            w[b + "attn_k_norm.weight"] = 1.0 + r(head_dim, s=0.1)
            w[b + "attn_k_norm.bias"] = r(head_dim, s=0.05)
        w.update(proj(b + "attn_output", n_embd, n_embd))
        if arch != "falcon":  # falcon's FFN reads the attention norm
            w.update(norm(b + "ffn_norm", n_embd))
        if lay["ffn"] == "gated":
            w.update(proj(b + "ffn_gate", n_ff, n_embd))
        w.update(proj(b + "ffn_up", n_ff, n_embd))
        w.update(proj(b + "ffn_down", n_embd, n_ff))
    return w


def write_arch_gguf(path: str | Path, arch: str, weights: dict[str, np.ndarray], *,
                    n_layers: int, n_embd: int, n_heads: int, n_kv_heads: int, n_ff: int,
                    n_vocab: int, n_ctx: int = 512, norm_eps: float = 1e-5,
                    max_alibi_bias: float | None = None, clamp_kqv: float | None = None,
                    qtype: GGMLQuantType = GGMLQuantType.F32, head_qtype=None,
                    vocab_kv: dict | None = None) -> Path:
    """A GGUF of `arch` from weights under GGUF tensor names. 2-D weights
    whose width is a multiple of 256 take `qtype` (output.weight
    `head_qtype`, default `qtype`); the rest, and the learned positions
    (indexed as dense rows), stay F32. A (qtype, payload bytes, shape)
    tuple is written as it is."""
    lay = ARCH_LAYOUTS[arch]
    head_dim = n_embd // n_heads
    w = GGUFWriter(path, arch)
    w.add_arch_kv(Keys.EMBEDDING_LENGTH, n_embd)
    w.add_arch_kv(Keys.BLOCK_COUNT, n_layers)
    w.add_arch_kv(Keys.HEAD_COUNT, n_heads)
    w.add_arch_kv(Keys.HEAD_COUNT_KV, n_kv_heads)
    w.add_arch_kv(Keys.FEED_FORWARD_LENGTH, n_ff)
    w.add_arch_kv(Keys.CONTEXT_LENGTH, n_ctx)
    if lay["norm"] == "rms":
        w.add_arch_kv(Keys.LAYER_NORM_RMS_EPS, float(norm_eps))
    else:
        w.add_arch_kv(Keys.LAYER_NORM_EPS, float(norm_eps))
    if "rope_frac" in lay:
        w.add_arch_kv(Keys.ROPE_DIMENSION_COUNT, int(head_dim * lay["rope_frac"]))
    if max_alibi_bias is not None:
        w.add_arch_kv(Keys.MAX_ALIBI_BIAS, float(max_alibi_bias))
    if clamp_kqv is not None:
        w.add_arch_kv(Keys.CLAMP_KQV, float(clamp_kqv))
    w.add_kv("general.vocab_size", n_vocab)
    for key, val in (vocab_kv or {}).items():
        w.add_kv(key, val)
    for name, arr in weights.items():
        if isinstance(arr, tuple):  # pre-quantized (qtype, payload, shape)
            qt, payload, shape = arr
            w.add_tensor(name, payload, shape=shape, qtype=qt)
            continue
        qt = (head_qtype or qtype) if name == "output.weight" else qtype
        if arr.ndim != 2 or arr.shape[-1] % 256 != 0 or name == "position_embd.weight":
            qt = GGMLQuantType.F32
        w.add_tensor(name, arr.astype(np.float32), qtype=qt)
    w.write()
    return Path(path)


def build_tiny_arch(path: str | Path, arch: str, *, seed: int = 0, n_layers: int = 2,
                    n_embd: int = 64, n_heads: int = 4, n_kv_heads: int | None = None,
                    n_ff: int = 128, n_vocab: int = 256, attn_norm_2: bool = False,
                    qtype: GGMLQuantType = GGMLQuantType.F32, **kv) -> Path:
    """A random tiny model of `arch` (one of ARCH_LAYOUTS) from `seed`;
    extra keywords go to write_arch_gguf (max_alibi_bias, clamp_kqv, ...)."""
    n_kv_heads = n_heads if n_kv_heads is None else n_kv_heads
    shape = dict(n_layers=n_layers, n_embd=n_embd, n_heads=n_heads, n_kv_heads=n_kv_heads,
                 n_ff=n_ff, n_vocab=n_vocab)
    weights = random_arch_weights(np.random.default_rng(seed), arch, attn_norm_2=attn_norm_2,
                                  **shape)
    return write_arch_gguf(path, arch, weights, qtype=qtype, **shape, **kv)


MPT_SCALES = {
    # mosaicml/mpt-7b's config.json: d_model 4096, n_heads 32, n_layers 32,
    # expansion_ratio 4, vocab_size 50432, alibi with alibi_bias_max 8,
    # no_bias; the draft is the lower 5 layers, as for the llama 7b pair
    "mpt7b": dict(target=dict(n_layers=32, n_embd=4096, n_heads=32, n_kv_heads=32, n_ff=16384,
                              n_vocab=50432), draft_layers=5),
    # the same design at unit-test widths (head_dim 128, as MPT-7B's)
    "mpt_nano": dict(target=dict(n_layers=4, n_embd=256, n_heads=2, n_kv_heads=2, n_ff=1024,
                                 n_vocab=2048), draft_layers=2),
}
MPT_LIVE_LAYERS = 2


def build_mpt_bench_pair(tgt_path: str | Path, dft_path: str | Path, *, scale: str = "mpt7b",
                         eps: float = 0.0, seed: int = 42, vocab: bool = False,
                         live_path: str | Path | None = None, n_layers: int | None = None,
                         log=lambda *a: None):
    """The MPT-7B counterpart of build_bench_pair: mosaicml/mpt-7b's widths
    (MPT_SCALES["mpt7b"]; "mpt_nano" for tests), quantized as llama.cpp's Q4_K_M quantizes the head (every
    weight Q4_K, output.weight Q6_K); LayerNorm without biases, a fused
    attn_qkv, a GELU FFN of ffn_up and ffn_down, ALiBi (max bias 8).

    The same cuts as build_bench_pair: random weights from `seed`,
    attn_output and ffn_down zero (still quantized and streamed), so the
    residual stays the token's embedding and the head maps token t to
    perm[t] with a wide margin; the embedding rows are made zero-mean, so
    that LayerNorm (which subtracts the row mean) equals RMSNorm on them and
    the margin survives. The draft is the target's lower `draft_layers`
    layers, its head disagreeing with the target's on an eps share of
    tokens. Upper layers share one template layer's weights. n_layers cuts
    the target to that many layers (default: the scale's, at least the
    draft's); the pair's greedy stream does not depend on it.

    live_path: also write a MPT_LIVE_LAYERS-layer model of the same widths,
    embedding and head whose attn_output and ffn_down are random and
    non-zero, so that attention (and ALiBi) reaches the logits. Every
    projection is drawn at 1/sqrt(fan_in), so the attention scores of the
    normed activations spread by about one and attention stays soft: a
    one-ulp difference upstream then moves the live logits by little, and
    a wrong cell or slope by much more (tools/live_check.py)."""
    from ..quant.formats import quantize

    shape = MPT_SCALES[scale]["target"]
    rng = np.random.default_rng(seed)
    e, ff, v = shape["n_embd"], shape["n_ff"], shape["n_vocab"]

    def proj(n_out, fan_in):
        return rng.standard_normal((n_out, fan_in), dtype=np.float32) / np.float32(fan_in ** 0.5)

    def layer():
        return {"attn_norm.weight": np.ones(e, np.float32), "attn_qkv.weight": proj(3 * e, e),
                "attn_output.weight": np.zeros((e, e), np.float32),
                "ffn_norm.weight": np.ones(e, np.float32), "ffn_up.weight": proj(ff, e),
                "ffn_down.weight": np.zeros((e, ff), np.float32)}

    draft_layer, upper = layer(), layer()
    embed = rng.standard_normal((v, e), dtype=np.float32) * 0.08
    embed -= embed.mean(axis=1, keepdims=True)
    u = embed / np.linalg.norm(embed, axis=1, keepdims=True)
    perm = rng.permutation(v)
    output = (0.5 * u[np.argsort(perm)]).astype(np.float32)
    if eps:
        n_bad = max(1, int(round(eps * v)))
        bad = rng.choice(v, size=n_bad, replace=False)
        perm_d = perm.copy()
        perm_d[bad] = perm[np.roll(bad, 1)]
        output_d = (0.5 * u[np.argsort(perm_d)]).astype(np.float32)
    else:
        output_d = output
    vocab_kv = synthetic_spm_vocab(v, seed) if vocab else {}
    memo: dict[int, tuple] = {}

    def q(arr, qt):
        if arr.ndim != 2:
            return arr
        if id(arr) not in memo:
            memo[id(arr)] = (qt, np.asarray(quantize(arr, qt)).tobytes(), arr.shape)
        return memo[id(arr)]

    def write(path, layers, head):
        weights = {"token_embd.weight": q(embed, GGMLQuantType.Q4_K),
                   "output_norm.weight": np.ones(e, np.float32),
                   "output.weight": q(head, GGMLQuantType.Q6_K)}
        for li, lw in enumerate(layers):
            for name, arr in lw.items():
                weights[f"blk.{li}.{name}"] = q(arr, GGMLQuantType.Q4_K)
        write_arch_gguf(path, "mpt", weights, **dict(shape, n_layers=len(layers)), n_ctx=2048,
                        max_alibi_bias=8.0, vocab_kv=vocab_kv)

    import time as _t

    t0 = _t.time()
    n, dl = n_layers or shape["n_layers"], MPT_SCALES[scale]["draft_layers"]
    if n < dl:
        raise ValueError(f"a {n}-layer target cannot hold its {dl}-layer draft")
    write(tgt_path, [draft_layer] * dl + [upper] * (n - dl), output)
    write(dft_path, [draft_layer] * dl, output_d)
    if live_path is not None:
        live = dict(draft_layer, **{"attn_output.weight": proj(e, e),
                                    "ffn_down.weight": proj(e, ff)})
        write(live_path, [live] * MPT_LIVE_LAYERS, output)
    log(f"built the {scale} pair in {_t.time() - t0:.1f}s (eps={eps}, {n}L target / {dl}L draft"
        + (f", {MPT_LIVE_LAYERS}L live model)" if live_path is not None else ")"))
    return Path(tgt_path), Path(dft_path)


# ---------------------------------------------------------------------------
# the CLIP tower + LLaVA projector (models/clip.py)
# ---------------------------------------------------------------------------

CLIP_SCALES = {
    # openai/clip-vit-large-patch14-336 (LLaVA-1.5's tower: quick_gelu, 576
    # patches) and LLaVA-1.5-7B's projector to llama-2-7B's n_embd 4096
    "vit_l14_336": dict(image_size=336, patch_size=14, hidden=1024, n_heads=16, n_ff=4096,
                        n_layers=24, proj_dim=768, n_embd=4096),
    # unit-test scale (the JAX package's tests/test_llava.py tower)
    "nano": dict(image_size=32, patch_size=8, hidden=32, n_heads=4, n_ff=64, n_layers=3,
                 proj_dim=32, n_embd=64),
}


def random_clip_weights(scale: str = "nano", seed: int = 0, *, n_embd: int | None = None,
                        hidden_act: str = "quick_gelu"):
    """(HF-like vision config, HF CLIPVisionModel state dict, projector
    {mm0_w, mm0_b, mm2_w, mm2_b}) of a random CLIP tower and LLaVA
    projector at CLIP_SCALES[scale], projecting to n_embd (default the
    scale's), made from `seed`: convert_clip.write_mmproj's arguments.
    Every projection is drawn at 1/sqrt(fan_in), so each block's attention
    stays soft and the patches, not the learned positions, dominate the
    output: different images give different embeddings. hidden_act "gelu"
    makes the file say use_gelu (the tanh-approximate GELU) instead of
    quick_gelu. Needs no transformers."""
    import types

    sc = dict(CLIP_SCALES[scale])
    n_embd = n_embd or sc["n_embd"]
    rng = np.random.default_rng(seed)
    hid, ff, ps = sc["hidden"], sc["n_ff"], sc["patch_size"]
    n_pos = (sc["image_size"] // ps) ** 2 + 1

    def proj(n_out, fan_in):
        return rng.standard_normal((n_out, fan_in), dtype=np.float32) / np.float32(fan_in ** 0.5)

    def small(*shape, s=0.02):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(s)

    def ln():
        return 1 + small(hid), small(hid)

    state = {
        "embeddings.patch_embedding.weight": proj(hid, 3 * ps * ps).reshape(hid, 3, ps, ps),
        "embeddings.class_embedding": small(hid, s=0.1),
        "embeddings.position_embedding.weight": small(n_pos, hid, s=0.1),
    }
    state["pre_layrnorm.weight"], state["pre_layrnorm.bias"] = ln()
    state["post_layernorm.weight"], state["post_layernorm.bias"] = ln()
    for i in range(sc["n_layers"]):
        pre = f"encoder.layers.{i}."
        for name, (n_out, fan_in) in (("self_attn.q_proj", (hid, hid)),
                                      ("self_attn.k_proj", (hid, hid)),
                                      ("self_attn.v_proj", (hid, hid)),
                                      ("self_attn.out_proj", (hid, hid)),
                                      ("mlp.fc1", (ff, hid)), ("mlp.fc2", (hid, ff))):
            state[pre + name + ".weight"] = proj(n_out, fan_in)
            state[pre + name + ".bias"] = small(n_out)
        for name in ("layer_norm1", "layer_norm2"):
            state[pre + name + ".weight"], state[pre + name + ".bias"] = ln()
    cfg = types.SimpleNamespace(
        hidden_act=hidden_act, image_size=sc["image_size"], patch_size=ps, hidden_size=hid,
        intermediate_size=ff, num_hidden_layers=sc["n_layers"],
        num_attention_heads=sc["n_heads"], layer_norm_eps=1e-5, projection_dim=sc["proj_dim"])
    mm = dict(mm0_w=proj(n_embd, hid), mm0_b=small(n_embd), mm2_w=proj(n_embd, n_embd),
              mm2_b=small(n_embd))
    return cfg, state, mm


def build_mmproj(path: str | Path, scale: str = "nano", seed: int = 0, *,
                 n_embd: int | None = None, hidden_act: str = "quick_gelu") -> Path:
    """random_clip_weights(scale, seed, ...) written through
    convert_clip.write_mmproj, as the converter writes a real checkpoint:
    an mmproj GGUF for models/clip.load_mmproj."""
    from .convert_clip import write_mmproj

    cfg, state, mm = random_clip_weights(scale, seed, n_embd=n_embd, hidden_act=hidden_act)
    write_mmproj(path, cfg=cfg, state=state, **mm)
    return Path(path)
