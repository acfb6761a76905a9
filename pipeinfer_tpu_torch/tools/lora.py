"""LoRA adapters: training, saving, and applying
(ref: examples/finetune trains LoRA checkpoints via common/train.cpp;
examples/export-lora/export-lora.cpp merges adapters into a base GGUF;
common.cpp:1056-1070 applies --lora/--lora-scaled at model load). Port of
pipeinfer_tpu.tools.lora.

Adapter file format: a GGUF whose tensors are `<base>.lora_a` [r, K] /
`<base>.lora_b` [N, r] pairs named after the base model tensor they adapt
(`blk.0.attn_q.weight.lora_a`, …) with `adapter.type = "lora"` and
`adapter.lora.alpha` metadata — the effective delta is
`(alpha / r) * B @ A`. Training keeps the dense base frozen and
differentiates only the A/B factors through the full batched forward."""

from __future__ import annotations

import argparse
import sys
import time
from typing import Sequence

import numpy as np
import torch

from .finetune import AdamW, _np, batch_at, tree_leaves, value_and_grad

SLOT2GGUF = {
    "wq": "attn_q",
    "wk": "attn_k",
    "wv": "attn_v",
    "wo": "attn_output",
    "w_gate": "ffn_gate",
    "w_up": "ffn_up",
    "w_down": "ffn_down",
}
GGUF2SLOT = {v: k for k, v in SLOT2GGUF.items()}
DEFAULT_TARGETS = ("wq", "wk", "wv", "wo")


def init_lora(params, rank: int, targets: Sequence[str], seed: int = 0):
    """A ~ N(0, 1/r) [r, K], B = 0 [N, r] per targeted layer slot (delta
    starts at zero, standard LoRA init), on the device of the slot's
    weight; A is drawn by numpy's default_rng(seed) in the JAX package's
    order, so it is that package's A bit for bit."""
    from ..ops.qmatmul import QuantTensor

    rng = np.random.default_rng(seed)
    lora = []
    for lp in params["layers"]:
        entry = {}
        for slot in targets:
            if slot not in lp:
                continue
            w = lp[slot]
            n, k = w.shape
            a = (rng.standard_normal((rank, k)) / rank).astype(np.float32)
            b = np.zeros((n, rank), np.float32)
            dev = w.qs.device if isinstance(w, QuantTensor) else w.device
            entry[slot] = (torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev))
        lora.append(entry)
    return lora


def merge_lora(params, lora, scale: float):
    """Dense params with targeted slots replaced by W + scale * B @ A.
    Differentiable in (A, B); W enters as a constant (detached)."""
    out = dict(params)
    layers = []
    for lp, entry in zip(params["layers"], lora):
        nlp = dict(lp)
        for slot, (a, b) in entry.items():
            w = nlp[slot].detach().to(torch.float32)
            nlp[slot] = w + scale * (b @ a)
        layers.append(nlp)
    out["layers"] = layers
    return out


def train_lora(
    params,  # dense f32 base (tools.finetune.dense_params)
    cfg,
    token_stream: np.ndarray,
    *,
    rank: int = 8,
    alpha: float = 16.0,
    targets: Sequence[str] = DEFAULT_TARGETS,
    seq_len: int = 128,
    batch: int = 4,
    steps: int = 100,
    lr: float = 1e-3,
    log=print,
    seed: int = 0,
):
    """Train LoRA factors over the frozen base with AdamW (optax.adamw's
    update). Batches come from one default_rng(seed) across steps, as in
    the JAX package. Returns (lora, losses)."""
    from ..models.train import lm_loss

    scale = alpha / rank
    lora = init_lora(params, rank, targets, seed)
    leaves = tree_leaves(lora)
    opt = AdamW(lr)
    opt_state = opt.init(leaves)

    rng = np.random.default_rng(seed)
    n_chunks = len(token_stream) - seq_len - 1
    losses = []
    t0 = time.time()
    for step in range(steps):
        starts = rng.integers(0, n_chunks, batch)
        toks = batch_at(token_stream, starts, seq_len)
        loss, grads = value_and_grad(lambda: lm_loss(merge_lora(params, lora, scale), cfg, toks),
                                     leaves)
        opt_state = opt.update(leaves, grads, opt_state)
        losses.append(float(loss))
        if step % 10 == 0 or step == steps - 1:
            log(f"step {step}: loss {losses[-1]:.4f} ({time.time()-t0:.1f}s)")
    return lora, losses


def save_adapter(path, lora, *, rank: int, alpha: float):
    from ..gguf.constants import GGUFValueType
    from ..gguf.writer import GGUFWriter

    w = GGUFWriter(path, arch="llama")
    w.add_kv("adapter.type", "lora")
    w.add_kv("adapter.lora.alpha", float(alpha), GGUFValueType.FLOAT32)
    w.add_kv("adapter.lora.rank", int(rank), GGUFValueType.UINT32)
    for i, entry in enumerate(lora):
        for slot, (a, b) in entry.items():
            base = f"blk.{i}.{SLOT2GGUF[slot]}.weight"
            w.add_tensor(f"{base}.lora_a", _np(a).astype(np.float32))
            w.add_tensor(f"{base}.lora_b", _np(b).astype(np.float32))
    w.write()


def load_adapter(path):
    """Returns (alpha, rank, {(layer, slot): (A, B)}) with numpy factors."""
    from ..gguf.reader import GGUFReader

    with GGUFReader(path) as r:
        if r.metadata.get("adapter.type") != "lora":
            raise ValueError(f"{path} is not a LoRA adapter gguf")
        alpha = float(r.metadata["adapter.lora.alpha"])
        rank = int(r.metadata["adapter.lora.rank"])
        pairs: dict[tuple[int, str], list] = {}
        for name in r.tensors:
            if not name.endswith((".lora_a", ".lora_b")):
                continue
            base, kind = name.rsplit(".", 1)
            parts = base.split(".")  # blk.{i}.{gguf}.weight
            if parts[0] != "blk" or parts[-1] != "weight":
                continue
            layer = int(parts[1])
            slot = GGUF2SLOT.get(".".join(parts[2:-1]))
            if slot is None:
                continue
            arr = np.array(r.tensor(name), np.float32)
            pairs.setdefault((layer, slot), [None, None])[0 if kind == "lora_a" else 1] = arr
    for key, (a, b) in pairs.items():
        if a is None or b is None:
            raise ValueError(f"adapter missing lora_a/lora_b pair for {key}")
    return alpha, rank, pairs


def apply_lora(params, adapter_path, scale: float | None = None):
    """Merge an adapter into loaded model params (ref: the --lora load-time
    merge, common.cpp:1056-1070). Targeted quantized weights become dense
    f32 on their device (the reference warns quantized+lora degrades; we
    dequantize); every other slot keeps its layout and its kernel."""
    from ..ops.qmatmul import QuantTensor, dequant

    alpha, rank, pairs = load_adapter(adapter_path)
    s = (alpha / rank) if scale is None else scale * (alpha / rank)
    layers = [dict(lp) for lp in params["layers"]]
    for (layer, slot), (a, b) in pairs.items():
        w = layers[layer][slot]
        dense = dequant(w, torch.float32) if isinstance(w, QuantTensor) else w.to(torch.float32)
        a_t, b_t = (torch.from_numpy(x).to(dense.device) for x in (a, b))
        layers[layer][slot] = (dense + float(np.float32(s)) * (b_t @ a_t)).contiguous()
    out = dict(params)
    out["layers"] = layers
    return out


def main(argv=None):
    """`pipeinfer-lora` — train a LoRA adapter on a text corpus."""
    p = argparse.ArgumentParser("pipeinfer-lora", description=__doc__.split("\n\n")[0])
    p.add_argument("-m", "--model", required=True, help="base GGUF model")
    p.add_argument("-f", "--file", required=True, help="training text")
    p.add_argument("-o", "--out", required=True, help="output adapter GGUF")
    p.add_argument("--rank", type=int, default=8)
    p.add_argument("--alpha", type=float, default=16.0)
    p.add_argument("--targets", default="wq,wk,wv,wo",
                   help=f"layer slots to adapt ({','.join(SLOT2GGUF)})")
    p.add_argument("--seq-len", type=int, default=128)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)

    from ..gguf.reader import GGUFReader
    from ..models import load_model
    from ..tokenizer import tokenizer_from_gguf
    from .finetune import dense_params

    params, cfg = load_model(args.model, device=args.device, fuse=False)  # split slots
    with GGUFReader(args.model) as r:
        tok = tokenizer_from_gguf(r)
    stream = np.asarray(tok.encode(open(args.file).read(), add_bos=True), np.int32)
    if len(stream) < args.seq_len + 2:
        raise SystemExit(f"corpus too short: {len(stream)} tokens")

    targets = tuple(t for t in args.targets.split(",") if t)
    bad = [t for t in targets if t not in SLOT2GGUF]
    if bad:
        raise SystemExit(f"unknown target slots: {bad} (valid: {list(SLOT2GGUF)})")
    params = dense_params(params)
    lora, losses = train_lora(
        params, cfg, stream,
        rank=args.rank, alpha=args.alpha, targets=targets,
        seq_len=args.seq_len, batch=args.batch, steps=args.steps, lr=args.lr,
        log=lambda s: print(s, file=sys.stderr),
    )
    save_adapter(args.out, lora, rank=args.rank, alpha=args.alpha)
    print(f"final loss {losses[-1]:.4f} -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
