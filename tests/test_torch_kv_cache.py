"""The port's KV cell cache against the JAX package's: the same random
cache through the writes and every seq op gives the same positions and
membership words bit for bit, and the same K after the re-rotating shifts
(f32 caches, atol 1e-6)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pipeinfer_tpu.runtime import kv_cache as jkv
from pipeinfer_tpu_torch.runtime import kv_cache as tkv

L_, KVH, C, D, W = 2, 2, 64, 16, 4


def _caches(rng, w=W):
    k = rng.standard_normal((L_, KVH, C, D)).astype(np.float32)
    v = rng.standard_normal((L_, KVH, C, D)).astype(np.float32)
    pos = np.where(rng.random(C) < 0.8, rng.integers(0, 40, C), -1).astype(np.int32)
    seq = np.zeros((C, w), np.uint32)
    ids = [s for s in (0, 1, 5, 31, 33, 70, 127) if s < 32 * w]
    for i in np.nonzero(pos >= 0)[0]:
        for s in rng.choice(ids, size=rng.integers(1, 4), replace=False):
            seq[i, s // 32] |= np.uint32(1) << np.uint32(s % 32)
    j = jkv.KVCache(k=jnp.asarray(k), v=jnp.asarray(v), pos=jnp.asarray(pos),
                    seq=jnp.asarray(seq))
    t = tkv.KVCache(k=torch.from_numpy(k.copy()), v=torch.from_numpy(v.copy()),
                    pos=torch.from_numpy(pos.copy()),
                    seq=torch.from_numpy(seq.view(np.int32).copy()))
    return j, t


def _same(j, t, k_atol=0.0):
    np.testing.assert_array_equal(t.pos.numpy(), np.asarray(j.pos))
    np.testing.assert_array_equal(t.seq.numpy().view(np.uint32), np.asarray(j.seq))
    np.testing.assert_allclose(t.k.numpy(), np.asarray(j.k), atol=k_atol, rtol=0)
    np.testing.assert_array_equal(t.v.numpy(), np.asarray(j.v))


OPS = {
    "seq_rm": (lambda m, c: m.seq_rm(c, 33, 5, 30)),
    "seq_rm_open_end": (lambda m, c: m.seq_rm(c, 127, 10, -1)),
    "seq_cp": (lambda m, c: m.seq_cp(c, 5, 70, 0, 25)),
    "seq_cp_bit31": (lambda m, c: m.seq_cp(c, 1, 31, 3, -1)),
    "seq_keep": (lambda m, c: m.seq_keep(c, 33)),
    "rm_tail": (lambda m, c: m.rm_tail(c, 17)),
    "clear": (lambda m, c: m.clear(c)),
}


@pytest.mark.parametrize("op", list(OPS))
def test_seq_ops_match(rng, op):
    j, t = _caches(rng)
    j = OPS[op](jkv, j)
    assert OPS[op](tkv, t) is t  # in place
    _same(j, t)


def test_writes_match(rng):
    j, t = _caches(rng, w=tkv.SEQ_WORDS)  # writes build SEQ_WORDS-wide rows
    cells = np.array([3, 9, 63, 63], np.int32)  # two padding rows on the trash cell
    pos = np.array([50, 51, 0, 0], np.int32)
    seq = np.array([33, 33, 0, 0], np.int32)
    valid = np.array([True, True, False, False])
    kn = rng.standard_normal((4, KVH, D)).astype(np.float32)
    vn = rng.standard_normal((4, KVH, D)).astype(np.float32)
    kn[3], vn[3] = kn[2], vn[2]  # duplicate writes agree, whichever lands
    j = jkv.write_meta(j, *map(jnp.asarray, (cells, pos, seq, valid)))
    j = jkv.write_tokens(j, 1, jnp.asarray(cells), jnp.asarray(kn), jnp.asarray(vn))
    tkv.write_meta(t, *map(torch.from_numpy, (cells, pos, seq, valid)))
    tkv.write_tokens(t, 1, torch.from_numpy(cells), torch.from_numpy(kn), torch.from_numpy(vn))
    _same(j, t)
    tp, ts = np.array([45, 52], np.int32), np.array([1, 33], np.int32)
    np.testing.assert_array_equal(
        tkv.attn_mask(t, torch.from_numpy(tp), torch.from_numpy(ts)).numpy(),
        np.asarray(jkv.attn_mask(j, jnp.asarray(tp), jnp.asarray(ts))))


@pytest.mark.parametrize("mode", ["norm", "neox"])
def test_shifts_match(rng, mode):
    j, t = _caches(rng)
    kw = dict(rope_dims=D, rope_mode=mode, freq_base=10000.0, freq_scale=1.0)
    j = jkv.seq_shift(j, 33, 5, 30, -7, **kw)
    tkv.seq_shift(t, 33, 5, 30, -7, **kw)
    _same(j, t, k_atol=1e-6)
    cells = np.array([1, 4, 8, C - 1], np.int32)
    j = jkv.shift_cells(j, jnp.asarray(cells), 3, C - 1, **kw)
    tkv.shift_cells(t, torch.from_numpy(cells), 3, C - 1, **kw)
    _same(j, t, k_atol=1e-6)


def test_hot_bucket_and_round_pool():
    h_pos = np.full(4096, -1)
    h_pos[:700] = 1
    assert tkv.hot_bucket(h_pos, 4095) == jkv.hot_bucket(h_pos, 4095) == 1024
    assert [tkv.round_pool(n) for n in (100, 513, 1024)] == \
        [jkv.round_pool(n) for n in (100, 513, 1024)] == [100, 1024, 1024]
    np.testing.assert_array_equal(tkv.alibi_slopes(12, 8.0).numpy(),
                                  np.asarray(jkv.alibi_slopes(12, 8.0)))
