"""Synthetic tiny-model GGUF builders for tests and benchmarks.

The counterpart of the reference's fixture pattern (vocab-only GGUFs,
tests/CMakeLists.txt:25-40) extended to full tiny models, plus an HF→GGUF
weight exporter used for logit-parity tests against transformers.
"""

from __future__ import annotations

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


def build_bench_pair(
    tgt_path: str | Path,
    dft_path: str | Path,
    *,
    scale: str = "7b",
    eps: float = 0.0,
    qtype: GGMLQuantType = GGMLQuantType.Q4_K,
    seed: int = 42,
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
    (7B quantize in ~1 min, not ~30)."""
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
