"""KV high-water-mark bounding in the port: tests/test_hot_cells.py's two
tests. Attention streams only the occupied prefix of the cell pool
(KVCache.hot): generation from a large pool is token-exact against the
same pool with bounding off (and against the JAX package's decoding of the
same file), and the bucket tracks occupancy."""

import numpy as np

from pipeinfer_tpu_torch.runtime.context import Batch

from .test_torch_sync_spec import CFG, N_PREDICT, PROMPT, build, jctx, tctx


def _greedy(ctx, prompt, n, batch=Batch):
    b = batch()
    for i, t in enumerate(prompt):
        b.add(t, i, 0, want_logits=(i == len(prompt) - 1))
    logits = ctx.decode(b)[-1]
    out, pos = [], len(prompt)
    cur = int(np.argmax(logits))
    for _ in range(n):
        out.append(cur)
        b = batch()
        b.add(cur, pos, 0, want_logits=True)
        cur = int(np.argmax(ctx.decode(b)[-1]))
        pos += 1
    return out


def test_big_pool_token_exact(tmp_path):
    from pipeinfer_tpu.runtime.context import Batch as JBatch

    m = build(tmp_path / "hot.gguf", seed=7, **CFG)
    # the SAME pool size with bounding off (pools of other sizes may sum
    # in another order)
    ref = tctx(m, 4096)
    ref._refresh_hot = lambda: None
    want = _greedy(ref, list(PROMPT), N_PREDICT)
    assert ref.cache.hot == 0

    big = tctx(m, 4096)
    got = _greedy(big, list(PROMPT), N_PREDICT)
    assert big.cache.hot == 512, big.cache.hot  # bounded, not the full pool
    assert got == want, f"hot-bounded decode diverges: {got} vs {want}"
    assert got == _greedy(jctx(m, 4096), list(PROMPT), N_PREDICT, JBatch)


def test_hot_bucket_tracks_occupancy(tmp_path):
    m = build(tmp_path / "hot2.gguf", seed=7, **CFG)
    ctx = tctx(m, 4096)
    ctx.h_pos[1000] = 5  # an occupied cell past the first bucket
    ctx._refresh_hot()
    assert ctx.cache.hot == 1024
    ctx.h_pos[3000] = 6
    ctx._refresh_hot()
    assert ctx.cache.hot == 0  # the next bucket would cover the pool: off
    ctx.h_pos[:] = -1
    ctx.h_pos[3] = 0
    ctx._refresh_hot()
    assert ctx.cache.hot == 512  # shrinks back after cells free up

    small = tctx(m, 256)
    small._refresh_hot()
    assert small.cache.hot == 0  # small pools skip the machinery
