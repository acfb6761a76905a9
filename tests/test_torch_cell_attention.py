"""The port's cell-attention kernel (its plain PyTorch version, which the
CPU runs) against the JAX package's Pallas kernel in interpret mode and
against the dense kv_cache.attention path, on the same numpy inputs: tree
masks over several seq words, a static layer of a 4-D cache, a hot bound
below the pool, ALiBi and padded rows. f32, atol 1e-5 (online vs
one-pass softmax and summation order)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pipeinfer_tpu.ops.cell_attention import cell_attention as j_cell_attention
from pipeinfer_tpu.runtime import kv_cache as jkv
from pipeinfer_tpu_torch.ops import cell_attention as tca
from pipeinfer_tpu_torch.runtime import kv_cache as tkv

ATOL = 1e-5
L_, H, KVH, D = 2, 8, 2, 64


def _inputs(rng, t, c, n_words, hot):
    used = hot or c // 2  # occupied prefix; cells beyond it stay free
    q = rng.standard_normal((t, H, D)).astype(np.float32)
    kc = rng.standard_normal((L_, KVH, c, D)).astype(np.float32)
    vc = rng.standard_normal((L_, KVH, c, D)).astype(np.float32)
    pos = np.full(c, -1, np.int32)
    pos[:used] = np.arange(used)
    seq = np.zeros((c, n_words), np.uint32)
    # seq ids in every word: 0, 33, 66, 99 for W=4 (ids >= 64 in words 2, 3),
    # and each cell also in one of the low ids
    ids = [w * 33 for w in range(n_words)]
    for i in range(used):
        s = ids[int(rng.integers(0, n_words))]
        seq[i, s // 32] |= np.uint32(1) << np.uint32(s % 32)
        seq[i, 0] |= np.uint32(1) << np.uint32(int(rng.integers(0, 3)))
    tok_pos = rng.integers(5, used, t).astype(np.int32)
    tok_seq = np.array([ids[i % n_words] for i in range(t)], np.int32)
    valid = np.ones(t, bool)
    if t > 1:
        valid[-1] = False  # a padding row
    return q, kc, vc, pos, seq, tok_pos, tok_seq, valid


def _port(q, kc, vc, pos, seq, tok_pos, tok_seq, valid, alibi, hot, layer=1):
    before = tca.cell_attention.launches
    out = tca.cell_attention(
        torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc), torch.from_numpy(pos),
        torch.from_numpy(seq.view(np.int32)), torch.from_numpy(tok_pos),
        torch.from_numpy(tok_seq), torch.from_numpy(valid), layer=layer, scale=D ** -0.5,
        alibi=None if alibi is None else torch.from_numpy(alibi), hot=hot).numpy()
    assert tca.cell_attention.launches == before  # CPU: the plain version
    return out


CASES = [(t, c, w, hot, ali)
         for t in (1, 4, 9) for c in (512, 1024) for w in (2, 4)
         for hot, ali in ((0, False), (c // 2, False), (c // 2, True))]


@pytest.mark.parametrize("t,c,n_words,hot,use_alibi", CASES)
def test_plain_matches_pallas_interpret_and_dense(rng, t, c, n_words, hot, use_alibi):
    q, kc, vc, pos, seq, tok_pos, tok_seq, valid = _inputs(rng, t, c, n_words, hot)
    alibi = np.array(jkv.alibi_slopes(H, 8.0)) if use_alibi else None
    scale = D ** -0.5
    got = _port(q, kc, vc, pos, seq, tok_pos, tok_seq, valid, alibi, hot)

    kw = dict(layer=1, scale=scale, block_c=256, interpret=True, hot=hot,
              alibi=None if alibi is None else jnp.asarray(alibi))
    want = np.asarray(j_cell_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(pos), jnp.asarray(seq),
        jnp.asarray(tok_pos), jnp.asarray(tok_seq), jnp.asarray(valid), **kw))
    np.testing.assert_allclose(got[valid], want[valid], atol=ATOL, rtol=0)

    # the dense path of the JAX package over the same layer
    cache = jkv.KVCache(k=jnp.asarray(kc), v=jnp.asarray(vc), pos=jnp.asarray(pos),
                        seq=jnp.asarray(seq))
    mask = jkv.attn_mask(cache, jnp.asarray(tok_pos), jnp.asarray(tok_seq))
    dense = np.asarray(jkv.attention(
        jnp.asarray(q), jnp.asarray(kc[1]), jnp.asarray(vc[1]), mask, scale=scale,
        alibi=kw["alibi"], cache_pos=jnp.asarray(pos) if use_alibi else None))
    np.testing.assert_allclose(got[valid], dense[valid], atol=ATOL, rtol=0)


def test_port_dense_attention_matches_plain_kernel(rng):
    """The port's own dense path (kv_cache.attend off the flash branch)
    agrees with its flash kernel's plain version."""
    t, c = 4, 512
    q, kc, vc, pos, seq, tok_pos, tok_seq, valid = _inputs(rng, t, c, 2, 0)
    cache = tkv.KVCache(k=torch.from_numpy(kc), v=torch.from_numpy(vc),
                        pos=torch.from_numpy(pos), seq=torch.from_numpy(seq.view(np.int32)))
    tp, ts = torch.from_numpy(tok_pos), torch.from_numpy(tok_seq)
    mask = tkv.attn_mask(cache, tp, ts)
    dense = tkv.attend(torch.from_numpy(q), cache, 1, mask, tp, ts, torch.from_numpy(valid),
                       scale=D ** -0.5).numpy()
    flash = _port(q, kc, vc, pos, seq, tok_pos, tok_seq, valid, None, 0)
    np.testing.assert_allclose(dense[valid], flash[valid], atol=ATOL, rtol=0)


def test_masking_is_load_bearing(rng):
    """A token whose seq lives in word 3 must see other cells than the same
    token on seq 0 (the uint32 word is shifted logically, bit 31 included)."""
    t, c = 4, 512
    q, kc, vc, pos, seq, tok_pos, tok_seq, valid = _inputs(rng, t, c, 4, 0)
    seq[:, 3] |= np.uint32(1) << np.uint32(31)  # seq id 127 on every cell
    a = _port(q, kc, vc, pos, seq, tok_pos, np.full(t, 127, np.int32), valid, None, 0)
    b = _port(q, kc, vc, pos, seq, tok_pos, np.zeros(t, np.int32), valid, None, 0)
    assert not np.allclose(a[valid], b[valid])


@pytest.mark.parametrize("use_alibi", [False, True])
def test_padding_rows_give_zero_on_both_paths(rng, use_alibi):
    """A padding row sees no cell and comes out 0, in the flash kernel's
    plain version and in the dense path (whose mask hides every cell from
    it, as models/llama.forward builds it); the JAX package's softmax
    spreads such a row over the pool instead, so only valid rows are held
    against it."""
    t, c = 4, 512
    q, kc, vc, pos, seq, tok_pos, tok_seq, valid = _inputs(rng, t, c, 2, 0)
    valid[1] = valid[3] = False
    alibi = np.linspace(0.05, 0.4, H, dtype=np.float32) if use_alibi else None
    cache = tkv.KVCache(k=torch.from_numpy(kc), v=torch.from_numpy(vc),
                        pos=torch.from_numpy(pos), seq=torch.from_numpy(seq.view(np.int32)))
    tp, ts, tv = torch.from_numpy(tok_pos), torch.from_numpy(tok_seq), torch.from_numpy(valid)
    mask = torch.where(tv[:, None], tkv.attn_mask(cache, tp, ts), tkv.MASK_VALUE)
    dense = tkv.attend(torch.from_numpy(q), cache, 1, mask, tp, ts, tv, scale=D ** -0.5,
                       alibi=None if alibi is None else torch.from_numpy(alibi)).numpy()
    flash = _port(q, kc, vc, pos, seq, tok_pos, tok_seq, valid, alibi, 0)
    assert not dense[~valid].any() and not flash[~valid].any()
    np.testing.assert_allclose(dense[valid], flash[valid], atol=ATOL, rtol=0)
    assert np.abs(flash[valid]).max() > 0
