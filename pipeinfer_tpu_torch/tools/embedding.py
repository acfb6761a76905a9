"""`python -m pipeinfer_tpu_torch.tools.embedding` — sentence embeddings
(ref: examples/embedding): mean-pooled, L2-normalized final hidden states
(post output-norm, pre-head).

Torch counterpart of pipeinfer_tpu.tools.embedding: one step of the
architecture's forward with output_hidden, over an f32 cache."""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..device import resolve
from ..gguf.reader import GGUFReader
from ..models import load_model
from ..models.loader import forward_for_arch
from ..runtime import kv_cache as kv
from ..tokenizer import tokenizer_from_gguf


def embed_text(params, cfg, text_ids: list[int]) -> np.ndarray:
    """The unit-norm embedding [n_embd] of text_ids, on the device params
    live on."""
    dev = params["output_norm"].device
    cache = kv.create(cfg.n_layers, len(text_ids) + 8, cfg.n_kv_heads, cfg.head_dim,
                      torch.float32, device=dev)
    t = len(text_ids)

    def ar():
        return torch.arange(t, dtype=torch.int32, device=dev)

    hidden, _ = forward_for_arch(cfg.arch)(
        params,
        cfg,
        cache,
        torch.tensor(text_ids, dtype=torch.int32, device=dev),
        ar(),
        torch.zeros(t, dtype=torch.int32, device=dev),
        ar(),
        torch.ones(t, dtype=torch.bool, device=dev),
        output_hidden=True,
    )
    emb = hidden.cpu().numpy().mean(axis=0)
    return emb / (np.linalg.norm(emb) + 1e-8)


def main(argv=None):
    p = argparse.ArgumentParser("pipeinfer-embedding", description=__doc__.split("\n\n")[0])
    p.add_argument("-m", "--model", required=True)
    p.add_argument("-p", "--prompt", default="")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)
    params, cfg = load_model(args.model, device=resolve(args.device))
    with GGUFReader(args.model) as r:
        tok = tokenizer_from_gguf(r)
    ids = tok.encode(args.prompt, add_bos=True)
    emb = embed_text(params, cfg, ids)
    print(" ".join(f"{x:.6f}" for x in emb))
    return 0


if __name__ == "__main__":
    sys.exit(main())
