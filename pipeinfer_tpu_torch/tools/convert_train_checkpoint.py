"""`python -m pipeinfer_tpu_torch.tools.convert_train_checkpoint` — import
reference training checkpoints. Port of
pipeinfer_tpu.tools.convert_train_checkpoint, whose optimizer sidecar it
writes with numpy in the same layout. A file conversion on the host:
`--device` is resolved as by every entry point of the port (without CUDA,
pass --device cpu); nothing here runs on it.

Counterpart of the reference's checkpoint converters + the GGUF training
checkpoint format itself (ref:
examples/train-text-from-scratch/convert-train-checkpoint-to-gguf.py,
examples/finetune/convert-finetune-checkpoint-to-gguf.py, and the
`training.*` / `optimizer.*` keys written by common/train.cpp). A user of
the reference holding a train or finetune checkpoint GGUF can carry it
over:

- `training.type == "train_model"` → a plain inference GGUF (runnable by
  every tool here) plus an `.opt.npz` optimizer sidecar holding the Adam
  first/second moments mapped per-tensor, so `tools.finetune --resume`
  continues the optimization. The reference stores moments as ONE flat
  f32 buffer over all parameters in registration order
  (ref: train-text-from-scratch.cpp:124-147 set_param_model); the slices
  are reshaped back onto the named tensors here.
- `training.type == "finetune_lora"` → a LoRA adapter GGUF in this
  framework's format (`adapter.type = "lora"`), usable with
  `cli.main --lora`, `tools.export_lora`, and resumable LoRA
  training. Norm/embedding LoRA factors (rank-1 in the reference's
  finetune defaults) have no counterpart in this runtime's adapter
  application and are reported + skipped.

The checkpoint GGUFs carry no tokenizer; pass --vocab-from to graft the
`tokenizer.ggml.*` tables of any other GGUF into the converted model.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..device import resolve

# flat Adam-moment parameter order (ref: train-text-from-scratch.cpp
# set_param_model :124-147 — tok_embd, norm, output, then per layer)
_GLOBAL_ORDER = ("token_embd.weight", "output_norm.weight", "output.weight")
_LAYER_ORDER = (
    "attn_norm.weight", "attn_q.weight", "attn_k.weight", "attn_v.weight",
    "attn_output.weight", "ffn_norm.weight", "ffn_gate.weight",
    "ffn_down.weight", "ffn_up.weight",
)

_OPT_TENSORS = {
    "optimizer.adam.first_moments",
    "optimizer.adam.second_moments",
    "optimizer.adam.past_loss_values",
}

_GGUF_TO_SLOT = {
    "attn_norm.weight": "attn_norm",
    "attn_q.weight": "wq",
    "attn_k.weight": "wk",
    "attn_v.weight": "wv",
    "attn_output.weight": "wo",
    "ffn_norm.weight": "ffn_norm",
    "ffn_gate.weight": "w_gate",
    "ffn_down.weight": "w_down",
    "ffn_up.weight": "w_up",
}

def _moment_slices(r, names: list[str], flat: np.ndarray) -> dict[str, np.ndarray]:
    """Slice the flat f32 moment buffer back onto named tensors.

    ggml's flat buffer is the parameters' own memory in registration
    order; a tensor's memory equals the C-order of its GGUF-read (numpy)
    shape, so reshape is a view-exact inverse."""
    out = {}
    off = 0
    for name in names:
        shape = r.tensors[name].shape
        n = int(np.prod(shape))
        if off + n > flat.size:
            raise SystemExit(
                f"error: optimizer moment buffer too short at {name} "
                f"(need {off + n}, have {flat.size})"
            )
        out[name] = flat[off : off + n].reshape(shape)
        off += n
    if off != flat.size:
        print(
            f"warning: {flat.size - off} trailing moment values unused "
            "(parameter set mismatch?)",
            file=sys.stderr,
        )
    return out


def _param_order(r) -> list[str]:
    names = [n for n in _GLOBAL_ORDER if n in r.tensors]
    li = 0
    while f"blk.{li}.attn_q.weight" in r.tensors:
        names += [f"blk.{li}.{s}" for s in _LAYER_ORDER if f"blk.{li}.{s}" in r.tensors]
        li += 1
    return names


def convert_train_model(ckpt: str, out: str, *, vocab_from: str = "",
                        lr: float = 1e-4, log=print) -> None:
    """train_model checkpoint → inference GGUF + resumable .opt.npz. `lr`
    is unused: AdamW's state holds none (the JAX package builds its
    template with it)."""
    from ..gguf.reader import GGUFReader
    from .finetune import vocab_kv
    from .testmodel import write_llama_gguf

    with GGUFReader(ckpt) as r:
        md = r.metadata
        arch = md.get("general.architecture", "llama")
        if arch != "llama":
            raise SystemExit(f"error: train_model checkpoints are llama-family (got {arch})")
        n_embd = int(md["llama.embedding_length"])
        n_layers = int(md["llama.block_count"])
        n_heads = int(md["llama.attention.head_count"])
        n_kv = int(md.get("llama.attention.head_count_kv", n_heads))
        n_ff = int(md["llama.feed_forward_length"])
        rope_dims = int(md.get("llama.rope.dimension_count", n_embd // n_heads))
        eps = float(md.get("llama.attention.layer_norm_rms_epsilon", 1e-5))
        n_ctx = int(md.get("llama.context_length", 2048))
        n_vocab = r.tensors["token_embd.weight"].shape[0]

        weights = {}
        for name in _GLOBAL_ORDER:
            if name in r.tensors:
                slot = {"token_embd.weight": "tok_embd",
                        "output_norm.weight": "output_norm",
                        "output.weight": "output"}[name]
                weights[slot] = np.asarray(r.tensor(name), np.float32)
        for li in range(n_layers):
            for suffix, slot in _GGUF_TO_SLOT.items():
                name = f"blk.{li}.{suffix}"
                if name in r.tensors:
                    weights[f"layers.{li}.{slot}"] = np.asarray(r.tensor(name), np.float32)

        extra_kv = {}
        if vocab_from:
            extra_kv.update(vocab_kv(vocab_from))
        if rope_dims != n_embd // n_heads:
            extra_kv["llama.rope.dimension_count"] = np.uint32(rope_dims)

        write_llama_gguf(
            out, weights,
            n_layers=n_layers, n_embd=n_embd, n_heads=n_heads,
            n_kv_heads=n_kv, n_ff=n_ff, n_vocab=n_vocab,
            norm_eps=eps, n_ctx=n_ctx, extra_kv=extra_kv or None,
        )
        log(f"{out}: {len(weights)} tensors "
            f"({n_layers}L x {n_embd}d, vocab {n_vocab})")

        # ---- optimizer moments → optax adamw sidecar --------------------
        if "optimizer.adam.first_moments" not in r.tensors:
            opt_type = md.get("optimizer.type", "<none>")
            log(f"no adam moments in checkpoint (optimizer.type={opt_type}); "
                "skipping .opt.npz")
            return
        n_iter = int(md.get("optimizer.iteration_count",
                            md.get("training.iteration_count", 0)))
        order = _param_order(r)
        mom1 = _moment_slices(r, order, np.asarray(
            r.tensor("optimizer.adam.first_moments"), np.float32).ravel())
        mom2 = _moment_slices(r, order, np.asarray(
            r.tensor("optimizer.adam.second_moments"), np.float32).ravel())

    from .finetune import AdamState, save_opt_state, tree_leaves

    def tree_of(tensors: dict[str, np.ndarray]):
        """Assemble {tok_embd, output_norm, output, layers:[{slot:...}]}
        matching dense_params' structure for the converted model (a moment
        missing from `tensors` takes the weight's values, as the JAX
        package's conversion does)."""

        def get(name, like):
            return np.asarray(tensors.get(name, like), np.float32)

        t = {
            "tok_embd": get("token_embd.weight", weights["tok_embd"]),
            "output_norm": get("output_norm.weight", weights["output_norm"]),
            "output": get("output.weight", weights["output"]),
            "layers": [],
        }
        for li in range(n_layers):
            lp = {}
            for suffix, slot in _GGUF_TO_SLOT.items():
                key = f"layers.{li}.{slot}"
                if key in weights:
                    lp[slot] = get(f"blk.{li}.{suffix}", weights[key])
            t["layers"].append(lp)
        return t

    # the optax.adamw state the JAX package writes, leaf for leaf: the
    # update count, then the first and the second moments in tree-flatten
    # order (numpy only: a file conversion touches no device)
    zeros = [np.zeros_like(x) for x in tree_leaves(tree_of({}))]
    mu = tree_leaves(tree_of(mom1)) if mom1 else zeros
    nu = tree_leaves(tree_of(mom2)) if mom2 else zeros
    state = AdamState(n_iter, mu, nu)
    save_opt_state(state, max(n_iter - 1, 0), out + ".opt.npz")
    log(f"{out}.opt.npz: adam moments at iteration {n_iter} "
        f"(resume: python -m pipeinfer_tpu_torch.tools.finetune --resume {out} ...)")


def convert_finetune_lora(ckpt: str, out: str, *, alpha: float = 0.0,
                          log=print) -> None:
    """finetune_lora checkpoint → adapter GGUF in this framework's format."""
    from ..gguf.constants import GGUFValueType
    from ..gguf.reader import GGUFReader
    from ..gguf.writer import GGUFWriter

    kept, skipped = 0, []
    with GGUFReader(ckpt) as r:
        md = r.metadata
        rank = int(md.get("training.lora.rank.attn_q",
                          md.get("training.lora.rank.ffn_gate", 0)))
        pairs: dict[str, tuple[np.ndarray, np.ndarray]] = {}
        for name in r.tensors:
            if not name.endswith(".lora_a"):
                continue
            base = name[: -len(".lora_a")]
            b_name = base + ".lora_b"
            if b_name not in r.tensors:
                skipped.append(base)
                continue
            a = np.asarray(r.tensor(name), np.float32)
            b = np.asarray(r.tensor(b_name), np.float32)
            parts = base.split(".")
            is_layer = (
                len(parts) == 4 and parts[0] == "blk"
                and f"{parts[2]}.weight" in _GGUF_TO_SLOT
                and parts[2] != "attn_norm" and parts[2] != "ffn_norm"
            )
            if not is_layer:
                skipped.append(base)  # norm/embd factors: no runtime slot
                continue
            pairs[base] = (a, b)
            if not rank:
                rank = a.shape[0]

        if not pairs:
            raise SystemExit("error: no convertible lora_a/lora_b matmul pairs found")
        if not alpha:
            alpha = float(rank)  # scale 1.0 unless told otherwise

        w = GGUFWriter(out, arch=md.get("general.architecture", "llama"))
        w.add_kv("adapter.type", "lora")
        w.add_kv("adapter.lora.alpha", float(alpha), GGUFValueType.FLOAT32)
        w.add_kv("adapter.lora.rank", int(rank), GGUFValueType.UINT32)
        for k in ("training.iteration_count", "training.sample_count",
                  "training.token_count"):
            if k in md:
                w.add_kv(k, md[k])
        for base, (a, b) in sorted(pairs.items()):
            w.add_tensor(base + ".lora_a", a)
            w.add_tensor(base + ".lora_b", b)
            kept += 1
        w.write()
    log(f"{out}: {kept} LoRA pairs (rank {rank}, alpha {alpha:g})")
    if skipped:
        log(f"skipped {len(skipped)} non-matmul factors (no runtime "
            f"counterpart): {', '.join(sorted(skipped)[:6])}"
            + ("..." if len(skipped) > 6 else ""))


def main(argv=None) -> int:
    p = argparse.ArgumentParser("pipeinfer-convert-checkpoint", description=__doc__)
    p.add_argument("checkpoint", help="reference training-checkpoint GGUF")
    p.add_argument("out", help="output GGUF (model or adapter)")
    p.add_argument("--vocab-from", default="",
                   help="GGUF whose tokenizer.ggml.* tables to graft in")
    p.add_argument("--alpha", type=float, default=0.0,
                   help="LoRA alpha for finetune_lora checkpoints "
                        "(default: rank, i.e. scale 1.0)")
    p.add_argument("--lr", type=float, default=1e-4,
                   help="accepted as the JAX package's tool takes it; the optimizer "
                        "state holds no learning rate (give it to tools.finetune --lr)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)
    resolve(args.device)

    from ..gguf.reader import GGUFReader

    with GGUFReader(args.checkpoint) as r:
        ttype = r.metadata.get("training.type", "")
    log = lambda s: print(s, file=sys.stderr)  # noqa: E731
    if ttype == "train_model":
        convert_train_model(args.checkpoint, args.out,
                            vocab_from=args.vocab_from, lr=args.lr, log=log)
    elif ttype == "finetune_lora":
        convert_finetune_lora(args.checkpoint, args.out, alpha=args.alpha, log=log)
    else:
        raise SystemExit(
            f"error: not a training checkpoint (training.type={ttype!r}); "
            "expected 'train_model' or 'finetune_lora'"
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
