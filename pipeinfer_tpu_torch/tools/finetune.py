"""`python -m pipeinfer_tpu_torch.tools.finetune` — full fine-tune or
train-from-scratch for the llama family
(ref: examples/finetune + examples/train-text-from-scratch + the
checkpoint machinery in common/train.cpp). Port of
pipeinfer_tpu.tools.finetune:

- loads a GGUF model as f32 master weights on the device (quantized
  weights are dequantized; use --init-random with size flags to train from
  scratch);
- AdamW (the update of optax.adamw, written out: AdamW below) on the
  causal-LM loss over a tokenized text corpus, with per-layer
  rematerialization;
- periodic checkpoints: model back to GGUF (resumable by every other tool)
  plus optimizer state in an .npz sidecar, the JAX package's file both
  ways.

The output GGUFs carry the source model's tokenizer tables, so `--resume`
and the CLIs read them (the JAX package writes none).
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from pathlib import Path

import numpy as np
import torch

_VOCAB_KEYS_PREFIX = "tokenizer.ggml."


def _np(t) -> np.ndarray:
    """A tensor (any device) or array as a host f32-or-own-dtype array."""
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def tree_leaves(tree) -> list:
    """The leaves of a params (or LoRA) tree in JAX's tree-flatten order:
    dict keys sorted, lists and tuples in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def vocab_kv(path) -> dict:
    """The tokenizer.ggml.* metadata of a GGUF file."""
    from ..gguf.reader import GGUFReader

    with GGUFReader(path) as r:
        return {k: v for k, v in r.metadata.items() if k.startswith(_VOCAB_KEYS_PREFIX)}


def dense_params(params):
    """QuantTensor -> dense f32 tensors on the weights' device (training
    needs real gradients). A new tree: drop the quantized one to free its
    planes (`params = dense_params(params)`)."""
    from ..ops.qmatmul import QuantTensor, dequant

    def conv(w):
        if isinstance(w, QuantTensor):
            return dequant(w, torch.float32).contiguous()
        return w.detach().to(torch.float32, copy=True)

    out = {k: conv(v) for k, v in params.items() if k != "layers"}
    out["layers"] = [{k: conv(v) for k, v in lp.items()} for lp in params["layers"]]
    return out


def save_gguf(params, cfg, path, extra_kv: dict | None = None):
    """The params as an f32 llama GGUF; extra_kv (such as vocab_kv of the
    source model) is added to its metadata."""
    from ..tools.testmodel import write_llama_gguf

    w = {
        "tok_embd": _np(params["tok_embd"]).astype(np.float32),
        "output_norm": _np(params["output_norm"]).astype(np.float32),
        "output": _np(params["output"]).astype(np.float32),
    }
    for i, lp in enumerate(params["layers"]):
        for slot, arr in lp.items():
            w[f"layers.{i}.{slot}"] = _np(arr).astype(np.float32)
    write_llama_gguf(
        path, w,
        n_layers=cfg.n_layers, n_embd=cfg.n_embd, n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads, n_ff=cfg.n_ff, n_vocab=cfg.n_vocab,
        rope_base=cfg.rope_base, norm_eps=cfg.norm_eps, n_ctx=cfg.n_ctx_train,
        extra_kv=extra_kv or None,
    )


# ---------------------------------------------------------------------------
# AdamW: optax.adamw(lr) with its defaults, over tensors
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class AdamState:
    """optax's ScaleByAdamState: the update count and the first and second
    moments, one per parameter leaf in tree_leaves order."""

    count: int
    mu: list
    nu: list


class AdamW:
    """What optax.adamw(lr) computes, with optax's defaults (b1 0.9, b2
    0.999, eps 1e-8, eps_root 0, weight_decay 1e-4 on every leaf):
    moments; bias correction by 1 - b^count; mu_hat / (sqrt(nu_hat) + eps);
    + weight_decay * p; * -lr; added to p. All in the leaves' f32."""

    B1, B2, EPS, WEIGHT_DECAY = 0.9, 0.999, 1e-8, 1e-4

    def __init__(self, lr: float):
        self.lr = lr

    def init(self, leaves: list) -> AdamState:
        return AdamState(0, [torch.zeros_like(p) for p in leaves],
                         [torch.zeros_like(p) for p in leaves])

    @torch.no_grad()
    def update(self, leaves: list, grads: list, state: AdamState) -> AdamState:
        """One step. The leaves and the state's moments are updated in place
        (b * m + (1 - b) * g is optax's (1 - b) * g + b * m, bit for bit);
        returns the state with the new count."""
        count = min(state.count + 1, 2**31 - 1)  # optax's safe int32 increment
        for p, g, m, v in zip(leaves, grads, state.mu, state.nu):
            m.mul_(self.B1).add_((1 - self.B1) * g)
            v.mul_(self.B2).add_((1 - self.B2) * (g * g))
            bc1 = 1 - torch.tensor(self.B1, dtype=torch.float32, device=p.device) ** count
            bc2 = 1 - torch.tensor(self.B2, dtype=torch.float32, device=p.device) ** count
            u = (m / bc1) / (torch.sqrt(v / bc2) + self.EPS)
            u += self.WEIGHT_DECAY * p
            p.add_(u * -self.lr)
        return AdamState(count, state.mu, state.nu)


def save_opt_state(opt_state: AdamState, step: int, path: str):
    """Optimizer-state checkpoint (ref: common/train.cpp opt context
    serialization — AdamW moments + step counter) in the JAX package's
    layout: `step` (int64), then optax's state leaves in tree-flatten order:
    leaf_0 the update count (int32), then every first moment, then every
    second moment."""
    leaves = [np.int32(opt_state.count)] + [_np(x) for x in opt_state.mu] + \
        [_np(x) for x in opt_state.nu]
    np.savez(path, step=np.int64(step), **{f"leaf_{i}": x for i, x in enumerate(leaves)})


def load_opt_state(path: str, opt_state_template: AdamState):
    """Restore an optimizer state saved by save_opt_state (either
    package's) into the leaves' devices, dtypes and shapes of
    `opt_state_template` (AdamW.init on matching params). Returns (state,
    step)."""
    data = np.load(path)
    n = len(opt_state_template.mu)

    def leaf(i, like):
        arr = data[f"leaf_{i}"]
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(f"{path}: leaf_{i} has shape {arr.shape}, the params "
                             f"{tuple(like.shape)}")
        return torch.from_numpy(arr).to(device=like.device, dtype=like.dtype)

    mu = [leaf(1 + i, x) for i, x in enumerate(opt_state_template.mu)]
    nu = [leaf(1 + n + i, x) for i, x in enumerate(opt_state_template.nu)]
    return AdamState(int(data["leaf_0"]), mu, nu), int(data["step"])


def _clone(tree):
    """A copy of a params tree, every tensor detached and cloned."""
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone(v) for v in tree)
    return tree.detach().clone()


def batch_at(token_stream: np.ndarray, starts, seq_len: int) -> torch.Tensor:
    return torch.from_numpy(np.stack([token_stream[s : s + seq_len + 1] for s in starts]))


def value_and_grad(loss_fn, leaves: list):
    """(loss_fn() detached, its gradient with respect to each of `leaves`):
    the leaves require grad for this call only."""
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss = loss_fn()
        grads = torch.autograd.grad(loss, leaves)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    return loss.detach(), grads


def train(
    params,
    cfg,
    token_stream: np.ndarray,
    *,
    seq_len: int = 128,
    batch: int = 4,
    steps: int = 100,
    lr: float = 1e-4,
    ckpt_every: int = 0,
    ckpt_path: str = "",
    log=print,
    seed: int = 0,
    resume_opt: str = "",
    extra_kv: dict | None = None,
):
    """Train a copy of `params` (dense f32, dense_params) for steps [start,
    steps), start 0 or the step after a resumed checkpoint's. Returns
    (params, losses). extra_kv goes into each checkpoint's metadata."""
    from ..models.train import lm_loss

    params = _clone(params)
    leaves = tree_leaves(params)
    opt = AdamW(lr)
    opt_state = opt.init(leaves)
    start_step = 0
    if resume_opt:
        opt_state, last_step = load_opt_state(resume_opt, opt_state)
        start_step = last_step + 1
        log(f"resumed optimizer state at step {start_step}")
    n_chunks = len(token_stream) - seq_len - 1
    losses = []
    t0 = time.time()
    for step in range(start_step, steps):
        # per-step rng: the batch at step k is identical whether or not the
        # run was resumed mid-stream (reproducible resume)
        rng = np.random.default_rng((seed, step))
        starts = rng.integers(0, n_chunks, batch)
        toks = batch_at(token_stream, starts, seq_len)
        loss, grads = value_and_grad(lambda: lm_loss(params, cfg, toks), leaves)
        opt_state = opt.update(leaves, grads, opt_state)
        del grads
        losses.append(float(loss))
        if step % 10 == 0 or step == steps - 1:
            log(f"step {step}: loss {losses[-1]:.4f} ({time.time()-t0:.1f}s)")
        if ckpt_every and ckpt_path and (step + 1) % ckpt_every == 0:
            save_gguf(params, cfg, ckpt_path, extra_kv)
            save_opt_state(opt_state, step, str(ckpt_path) + ".opt.npz")
            log(f"checkpoint -> {ckpt_path} (+.opt.npz)")
    return params, losses


def main(argv=None):
    p = argparse.ArgumentParser("pipeinfer-finetune", description=__doc__.split("\n\n")[0])
    p.add_argument("-m", "--model", help="base GGUF model (omit with --init-random)")
    p.add_argument("-f", "--file", required=True, help="training text")
    p.add_argument("-o", "--out", required=True, help="output GGUF")
    p.add_argument("--init-random", action="store_true", help="train from scratch")
    p.add_argument("--vocab-from", default="", help="vocab gguf for --init-random")
    p.add_argument("--n-layers", type=int, default=4)
    p.add_argument("--n-embd", type=int, default=256)
    p.add_argument("--n-heads", type=int, default=8)
    p.add_argument("--n-ff", type=int, default=512)
    p.add_argument("--seq-len", type=int, default=128)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--ckpt-every", type=int, default=0)
    p.add_argument("--resume", default="",
                   help="checkpoint GGUF to resume from (model + .opt.npz)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)

    from ..gguf.reader import GGUFReader
    from ..models import load_model
    from ..tokenizer import tokenizer_from_gguf

    if args.resume:
        args.model = args.resume
    if args.init_random:
        import tempfile

        from ..tools import testmodel

        vocab_src = args.vocab_from or args.model
        if not vocab_src:
            raise SystemExit("--init-random needs --vocab-from or -m for the vocabulary")
        tmp = Path(tempfile.mkdtemp()) / "init.gguf"
        testmodel.build_tiny_llama(
            tmp, n_layers=args.n_layers, n_embd=args.n_embd, n_heads=args.n_heads,
            n_kv_heads=args.n_heads, n_ff=args.n_ff, vocab_from=vocab_src,
        )
        model_path = tmp
    else:
        model_path = args.model
    params, cfg = load_model(model_path, device=args.device, fuse=False)  # split slots
    with GGUFReader(model_path) as r:
        tok = tokenizer_from_gguf(r)

    text = open(args.file).read()
    stream = np.asarray(tok.encode(text, add_bos=True), np.int32)
    if len(stream) < args.seq_len + 2:
        raise SystemExit(f"corpus too short: {len(stream)} tokens")
    params = dense_params(params)
    kv = vocab_kv(model_path)
    params, losses = train(
        params, cfg, stream,
        seq_len=args.seq_len, batch=args.batch, steps=args.steps, lr=args.lr,
        ckpt_every=args.ckpt_every, ckpt_path=args.out,
        log=lambda s: print(s, file=sys.stderr),
        resume_opt=(args.resume + ".opt.npz") if args.resume else "",
        extra_kv=kv,
    )
    save_gguf(params, cfg, args.out, kv)
    print(f"final loss {losses[-1]:.4f} -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
