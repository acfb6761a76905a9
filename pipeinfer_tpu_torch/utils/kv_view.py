"""KV-cache introspection for debugging speculation rollback.

Counterpart of `llama_kv_cache_view` + `dump_kv_cache_view_seqs`
(ref: llama.h view API, common/common.h:230-232; instantiated throughout
speculative.cpp as the rollback debugging aid). Renders cells as one
character per cell showing sequence membership — the same visual the
reference prints."""

from __future__ import annotations

import numpy as np


def view(ctx) -> dict:
    """Summarize a context's cache occupancy from the host mirror."""
    used = int((ctx.h_pos >= 0).sum())
    from ..runtime import kv_cache as kv

    seqs = {}
    for s in range(32 * kv.SEQ_WORDS):
        cnt = int(kv.host_member(ctx.h_seq, s).sum())
        if cnt:
            seqs[s] = cnt
    return {
        "n_cells": ctx.n_cells,
        "used_cells": used,
        "max_pos": int(ctx.h_pos.max(initial=-1)),
        "cells_per_seq": seqs,
    }


def dump_seqs(ctx, row_size: int = 64) -> str:
    """One char per cell: '.' free, digit/letter = single sequence id,
    '+' = shared by multiple sequences (ref: dump_kv_cache_view_seqs)."""
    chars = []
    alphabet = "0123456789abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ@#"
    for i in range(ctx.n_cells):
        if ctx.h_pos[i] < 0:
            chars.append(".")
            continue
        bits = 0
        for w in range(ctx.h_seq.shape[1]):
            bits |= int(ctx.h_seq[i, w]) << (32 * w)
        n = bin(bits).count("1")
        if n > 1:
            chars.append("+")
        else:
            # slots past the alphabet (SEQ_WORDS > 2 widens to 128+) wrap
            chars.append(alphabet[(bits.bit_length() - 1) % len(alphabet)])
    lines = [
        "".join(chars[i : i + row_size]) for i in range(0, len(chars), row_size)
    ]
    summary = view(ctx)
    head = (
        f"cells {summary['used_cells']}/{summary['n_cells']} "
        f"max_pos {summary['max_pos']} seqs {summary['cells_per_seq']}"
    )
    return head + "\n" + "\n".join(lines)
