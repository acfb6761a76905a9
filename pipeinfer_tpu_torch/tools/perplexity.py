"""`python -m pipeinfer_tpu_torch.tools.perplexity` — perplexity over a
text file (ref: examples/perplexity/perplexity.cpp): tokenize the corpus,
evaluate in windows of n_ctx with the second half scored (the reference's
default half-window conditioning), report running PPL. Used for
quantization quality parity checks.

Torch counterpart of pipeinfer_tpu.tools.perplexity: each window is one
step of n_ctx rows whose full logits come back to the host."""

from __future__ import annotations

import argparse
import math
import sys

import numpy as np

from ..cli.main import build_context
from ..runtime.context import Batch


def perplexity(ctx, tok, text: str, n_ctx: int = 512, stride: int | None = None, log=None):
    ids = tok.encode(text, add_bos=True)
    if len(ids) < n_ctx:
        raise SystemExit(f"corpus too short: {len(ids)} tokens < n_ctx {n_ctx}")
    stride = stride or n_ctx // 2
    nll = 0.0
    n_scored = 0
    for start in range(0, len(ids) - n_ctx, n_ctx):
        window = ids[start : start + n_ctx]
        ctx.clear_cache()
        b = Batch()
        for i, t in enumerate(window):
            b.add(t, i, 0, want_logits=True)
        logits = ctx.decode(b)
        # score the second half of the window given the first
        logp = logits - _logsumexp(logits)
        for i in range(stride, n_ctx - 1):
            nll -= float(logp[i, window[i + 1]])
            n_scored += 1
        if log:
            log(f"[{start + n_ctx}/{len(ids)}] ppl = {math.exp(nll / max(n_scored, 1)):.4f}")
    return math.exp(nll / max(n_scored, 1)), n_scored


def _logsumexp(x: np.ndarray) -> np.ndarray:
    m = x.max(axis=-1, keepdims=True)
    return m + np.log(np.exp(x - m).sum(axis=-1, keepdims=True))


def main(argv=None):
    p = argparse.ArgumentParser("pipeinfer-perplexity", description=__doc__.split("\n\n")[0])
    p.add_argument("-m", "--model", required=True)
    p.add_argument("-f", "--file", required=True, help="text corpus")
    p.add_argument("-c", "--ctx-size", type=int, default=512)
    p.add_argument("--stride", type=int, default=0)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)
    ctx, tok = build_context(args.model, args.ctx_size + 8, device=args.device)
    with open(args.file) as f:
        text = f.read()
    ppl, n = perplexity(
        ctx,
        tok,
        text,
        n_ctx=args.ctx_size,
        stride=args.stride or None,
        log=lambda s: print(s, file=sys.stderr),
    )
    print(f"ppl = {ppl:.4f} over {n} tokens")
    return 0


if __name__ == "__main__":
    sys.exit(main())
