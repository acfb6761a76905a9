"""Context state serialization + session files.

Torch counterpart of pipeinfer_tpu.runtime.state (ref: llama.cpp
llama_get_state_size :9362-9400, llama_copy_state_data :9445-9568,
llama_set_state_data :9570+, session files :9700-9783 used by
--prompt-cache; exercised by examples/save-load-state).

State = the full KV cache (cells + per-cell pos/seq bitmask) plus the host
allocation mirror; sessions add the token history so prompts can be
resumed without re-prefilling. Format: npz (numpy), magic/versioned, the
JAX package's own: a file either package writes, the other loads. A bf16
cache is stored as raw 16-bit payloads (npz has no bf16), the seq words as
uint32.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from . import kv_cache as kv
from .context import InferenceContext

SESSION_MAGIC = "pipeinfer-session"
SESSION_VERSION = 1

def _host_payload(t: torch.Tensor) -> np.ndarray:
    """A cache slab as numpy: f32/f16 as they are, bf16 as its uint16 bits."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _device_slab(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """A stored slab back as a host tensor of `dtype` (uint16 = bf16 bits)."""
    if a.dtype == np.uint16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).to(dtype)
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def state_arrays(ctx: InferenceContext) -> dict[str, np.ndarray]:
    c = ctx.cache
    return {
        "k": _host_payload(c.k),
        "v": _host_payload(c.v),
        "pos": c.pos.cpu().numpy(),
        "seq": c.seq.cpu().numpy().view(np.uint32),
        "h_pos": ctx.h_pos,
        "h_seq": ctx.h_seq,  # [C, SEQ_WORDS] uint32
    }


def save_state(ctx: InferenceContext, path: str | Path, tokens: list[int] | None = None):
    """Serialize KV cache + metadata (+ optional token history = session)
    to `path` as given (the JAX package's np.savez_compressed(path) adds
    ".npz" to a name without it, so its --prompt-cache s.bin never finds
    its own file again)."""
    meta = {
        "magic": SESSION_MAGIC,
        "version": SESSION_VERSION,
        "n_cells": ctx.n_cells,
        "n_layers": ctx.cfg.n_layers,
        "cache_dtype": str(ctx.cache.k.dtype).removeprefix("torch."),  # numpy's name
    }
    arrays = state_arrays(ctx)
    if tokens is not None:
        arrays["tokens"] = np.asarray(tokens, np.int32)
    with open(path, "wb") as f:
        np.savez_compressed(f, meta=json.dumps(meta), **arrays)


def load_state(ctx: InferenceContext, path: str | Path) -> list[int] | None:
    """Restore KV cache + metadata into ctx's own tensors. Returns the token
    history if present. Then rebuilds what a step reads from the host: the
    mirrors, the cache's hot bound, and an empty trash cell."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        if meta.get("magic") != SESSION_MAGIC:
            raise ValueError(f"{path}: not a pipeinfer session/state file")
        if meta["version"] > SESSION_VERSION:
            raise ValueError(f"{path}: unsupported session version {meta['version']}")
        if meta["n_cells"] != ctx.n_cells or meta["n_layers"] != ctx.cfg.n_layers:
            raise ValueError(
                f"{path}: shape mismatch (cells {meta['n_cells']} vs {ctx.n_cells}, "
                f"layers {meta['n_layers']} vs {ctx.cfg.n_layers})"
            )
        h_seq = z["h_seq"]
        if h_seq.ndim == 1:  # legacy uint64-scalar mirror (SEQ_WORDS == 2)
            h_seq = h_seq.view(np.uint64)
            words = np.zeros((h_seq.shape[0], kv.SEQ_WORDS), np.uint32)
            words[:, 0] = (h_seq & np.uint64(0xFFFFFFFF)).astype(np.uint32)
            if kv.SEQ_WORDS > 1:
                words[:, 1] = (h_seq >> np.uint64(32)).astype(np.uint32)
            h_seq = words
        elif h_seq.shape[1] != kv.SEQ_WORDS:
            raise ValueError(
                f"{path}: session saved with SEQ_WORDS={h_seq.shape[1]}, "
                f"runtime has {kv.SEQ_WORDS}"
            )
        c = ctx.cache
        c.k.copy_(_device_slab(z["k"], c.k.dtype))
        c.v.copy_(_device_slab(z["v"], c.v.dtype))
        c.pos.copy_(torch.from_numpy(z["pos"].astype(np.int32)))
        c.seq.copy_(torch.from_numpy(z["seq"].astype(np.uint32).view(np.int32)))
        ctx.h_pos = z["h_pos"].astype(np.int64)
        ctx.h_seq = h_seq.astype(np.uint32)
        tokens = z["tokens"].tolist() if "tokens" in z else None
    # the trash cell takes padding rows' writes and must stay invisible
    c.pos[ctx.trash_cell] = -1
    c.seq[ctx.trash_cell] = 0
    ctx.h_pos[ctx.trash_cell] = -1
    ctx.h_seq[ctx.trash_cell] = 0
    ctx._refresh_hot()
    return tokens
