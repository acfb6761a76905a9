"""A CPU rehearsal of the cell-attention kernel's split and merge
(pipeinfer_tpu_torch/csrc/cell_attention.cu). A torch emulation cuts the
cells exactly as the kernel does: the wrapper's ``plan`` into splits, each
split's cells into lane groups that take CELLS_PER_STEP cells per block step
(cells past the split's end score -inf), an online softmax per group with
its max starting at NEG, the block's merge of its groups, then the merge of
the splits. It is held against the JAX package's Pallas kernel in interpret
mode and the port's plain version on the same numpy inputs, at the edges the
split creates: a split that is all masked, one beyond every token's
position, a hot bound with NaN past it, padded rows, a row that sees no
cell, ALiBi over masked cells, seq ids in words 2 and 3, GQA with G = 4.
A padded row comes out 0 in the port, and the JAX kernel spreads it over
the pool, so the JAX kernel is held to the valid rows only. f32, atol 1e-5
(summation order). The plan itself is checked at the shapes
chip_smoke.py times."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pipeinfer_tpu.ops.cell_attention import cell_attention as j_cell_attention
from pipeinfer_tpu.runtime import kv_cache as jkv
from pipeinfer_tpu_torch.ops import cell_attention as tca

ATOL = 1e-5
D, C = 64, 1024


def _emulate(q, kc, vc, pos, seq, tok_pos, tok_seq, valid, *, layer, scale, alibi, c):
    """The kernel's arithmetic, cut as the kernel cuts it."""
    t, h, d = q.shape
    kvh = kc.shape[1]
    g = h // kvh
    cut = tca.plan(t, h, kvh, d, c)
    k, v = kc[layer, :, :c].float(), vc[layer, :, :c].float()  # [KVH, c, D]
    cpos = pos[:c].long()
    words = seq[:c].long()[:, tok_seq.long() // 32].T  # [T, c]
    bit = (words >> (tok_seq.long() % 32)[:, None]) & 1
    vis = (bit != 0) & (cpos[None] <= tok_pos.long()[:, None]) & (cpos[None] >= 0)
    s = torch.einsum("tkgd,kcd->tkgc", q.reshape(t, kvh, g, d), k) * scale
    s = s + torch.where(vis, 0.0, tca.NEG)[:, None, None, :]
    if alibi is not None:
        s = s + alibi.reshape(kvh, g)[None, :, :, None] * cpos.clamp_min(0).float()
    s = s.masked_fill(~valid[:, None, None, None], -torch.inf)  # a padding row weighs no cell
    ng = tca.THREADS // cut.group_lanes
    u = tca.CELLS_PER_STEP
    parts = []
    for i in range(cut.n_splits):
        c0, c1 = i * cut.split, min((i + 1) * cut.split, c)
        n_steps = -(-(c1 - c0) // (ng * u))
        idx = c0 + torch.arange(n_steps * ng * u).reshape(n_steps, ng, u)  # (step, group, cell)
        here = idx < c1
        idx = idx.clamp_max(c - 1)
        sg = torch.where(here, s[..., idx], -torch.inf)  # [T, KVH, G, step, group, U]
        vg = v[:, idx] * here[..., None]  # [KVH, step, group, U, D]
        m = torch.full((t, kvh, g, ng), tca.NEG)
        l = torch.zeros(t, kvh, g, ng)
        acc = torch.zeros(t, kvh, g, ng, d)
        for st in range(n_steps):
            m_next = torch.maximum(m, sg[..., st, :, :].amax(-1))
            alpha = torch.exp(m - m_next)
            p = torch.exp(sg[..., st, :, :] - m_next[..., None])
            l = alpha * l + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum("tkgnu,knud->tkgnd", p, vg[:, st])
            m = m_next
        mb = m.amax(-1)  # the block merges its groups
        w = torch.exp(m - mb[..., None])
        parts.append((mb, (l * w).sum(-1), (acc * w[..., None]).sum(-2)))
    m_all = torch.stack([p[0] for p in parts])  # then the splits merge
    mx = m_all.amax(0)
    w = torch.exp(m_all - mx)
    l_sum = sum(p[1] * wi for p, wi in zip(parts, w))
    acc = sum(p[2] * wi[..., None] for p, wi in zip(parts, w))
    return (acc / torch.where(l_sum == 0, 1.0, l_sum)[..., None]).reshape(t, h, d)


def _inputs(rng, t, h, kvh, n_words, hot=0, used=C // 2):
    q = rng.standard_normal((t, h, D)).astype(np.float32)
    kc = rng.standard_normal((2, kvh, C, D)).astype(np.float32)
    vc = rng.standard_normal((2, kvh, C, D)).astype(np.float32)
    pos = np.full(C, -1, np.int32)
    pos[:used] = np.arange(used)
    seq = np.zeros((C, n_words), np.uint32)
    seq[:used, 0] = 1 | (rng.integers(0, 2, used).astype(np.uint32) << np.uint32(1))
    tok_pos = rng.integers(used // 2, used, t).astype(np.int32)
    tok_seq = rng.integers(0, 2, t).astype(np.int32)
    valid = np.ones(t, bool)
    return dict(q=q, kc=kc, vc=vc, pos=pos, seq=seq, tok_pos=tok_pos, tok_seq=tok_seq,
                valid=valid, hot=hot, alibi=None)


def _masked_split(x, cut):  # every cell of split 1 in no seq
    x["seq"][cut.split:2 * cut.split] = 0


def _beyond_tok_pos(x, cut):  # only split 0 holds cells at or before any token's position
    x["tok_pos"][:] = np.minimum(x["tok_pos"], cut.split - 1)


def _hot(x, cut):  # stream [0, 512); NaN past it must never be read
    x["hot"] = C // 2
    x["kc"][:, :, C // 2:] = np.nan
    x["vc"][:, :, C // 2:] = np.nan


def _padded(x, cut):
    x["valid"][-1] = False


def _no_visible_row(x, cut):  # seq id 2 is in no cell
    x["tok_seq"][0] = 2


def _alibi_masked(x, cut):
    x["alibi"] = np.array(jkv.alibi_slopes(x["q"].shape[1], 8.0), np.float32)
    _masked_split(x, cut)
    x["valid"][-1] = False


def _words_2_3(x, cut):  # seq ids 66 (word 2) and 99 (word 3, bit 3) on alternate cells
    x["seq"][0:C // 2:2, 2] = np.uint32(1) << np.uint32(2)
    x["seq"][1:C // 2:2, 3] = np.uint32(1) << np.uint32(3)
    x["tok_seq"][:] = np.array([66, 99])[np.arange(len(x["tok_seq"])) % 2]


CASES = {  # name -> (t, h, kvh, n_words, edit)
    "masked_split": (4, 8, 2, 2, _masked_split),
    "beyond_tok_pos": (1, 8, 2, 2, _beyond_tok_pos),
    "hot": (4, 8, 2, 2, _hot),
    "padded": (3, 8, 2, 2, _padded),
    "no_visible_row": (2, 8, 2, 2, _no_visible_row),
    "alibi_masked": (4, 8, 2, 2, _alibi_masked),
    "words_2_3": (4, 8, 2, 4, _words_2_3),
    "gqa4": (2, 16, 4, 2, _padded),
    "t1_mha": (1, 8, 8, 2, _masked_split),
}


@pytest.mark.parametrize("case", list(CASES))
def test_split_merge_matches_pallas_interpret_and_plain(rng, case):
    t, h, kvh, n_words, edit = CASES[case]
    x = _inputs(rng, t, h, kvh, n_words)
    c = C // 2 if edit is _hot else C
    cut = tca.plan(t, h, kvh, D, c)
    assert cut.n_splits > 2  # the edges below fall on split boundaries
    edit(x, cut)
    scale = D ** -0.5
    tt = {k: torch.from_numpy(v) for k, v in x.items()
          if isinstance(v, np.ndarray) and k != "seq"}
    seq_t = torch.from_numpy(x["seq"].view(np.int32))
    args = (tt["q"], tt["kc"], tt["vc"], tt["pos"], seq_t, tt["tok_pos"], tt["tok_seq"],
            tt["valid"])
    alibi = tt.get("alibi")
    got = _emulate(*args, layer=1, scale=scale, alibi=alibi, c=c).numpy()
    assert np.isfinite(got).all()

    plain = tca._cell_attention_plain(*args, 1, scale, alibi, c).numpy()
    np.testing.assert_allclose(got, plain, atol=ATOL, rtol=0)
    before = tca.cell_attention.launches
    port = tca.cell_attention(*args, layer=1, scale=scale, alibi=alibi, hot=x["hot"]).numpy()
    assert tca.cell_attention.launches == before  # CPU: the plain version
    np.testing.assert_array_equal(port, plain)

    want = np.asarray(j_cell_attention(
        *(jnp.asarray(x[k]) for k in ("q", "kc", "vc", "pos", "seq", "tok_pos", "tok_seq",
                                      "valid")),
        layer=1, scale=scale, block_c=256, interpret=True, hot=x["hot"],
        alibi=None if alibi is None else jnp.asarray(x["alibi"])))
    ok = x["valid"]
    np.testing.assert_allclose(got[ok], want[ok], atol=ATOL, rtol=0)
    assert not got[~ok].any()


# (t, h, kvh, d, c): the shapes chip_smoke.py times, the toy and nano heads,
# prefill rows, and ranges too short for more than one split
PLAN_SHAPES = [(t, 32, 32, 128, c) for t in (1, 4, 33) for c in (512, 1024, 2048, 4096, 8192)] \
    + [(t, 16, 8, 64, c) for t in (1, 4, 9) for c in (512, 1024)] \
    + [(t, 8, 2, 64, c) for t in (1, 4, 9) for c in (32, 96, 512, 1024)] \
    + [(512, 32, 32, 128, 8192), (1, 32, 8, 128, 4096), (2, 4, 4, 32, 160), (4, 8, 8, 16, 512)]


@pytest.mark.parametrize("t,h,kvh,d,c", PLAN_SHAPES)
def test_plan_covers_the_cells_in_multiples_of_32(t, h, kvh, d, c):
    cut = tca.plan(t, h, kvh, d, c)
    assert cut.split % 32 == 0 and cut.split >= min(c, tca.MIN_SPLIT)
    bounds = [(i * cut.split, min((i + 1) * cut.split, c)) for i in range(cut.n_splits)]
    assert bounds[0][0] == 0 and bounds[-1][1] == c
    assert all(b0 < b1 and (b1 - b0) % 32 == 0 for b0, b1 in bounds)
    assert all(bounds[i][1] == bounds[i + 1][0] for i in range(len(bounds) - 1))
    tg = t * (h // kvh)
    assert cut.rows in (1, 2, 4) and cut.rows * cut.row_tiles >= tg > cut.rows * (cut.row_tiles - 1)
    assert 8 * cut.group_lanes >= d and cut.group_lanes in (4, 8, 16)
    assert tca.CELLS_PER_STEP * cut.rows <= cut.group_lanes  # one (cell, row) pair per lane
    assert cut.blocks == cut.n_splits * cut.row_tiles * kvh


@pytest.mark.parametrize("t,c,least", [(1, 4096, 256), (4, 4096, 256), (1, 2048, 256),
                                       (1, 1024, 128), (4, 1024, 128), (1, 512, 128)])
def test_plan_fills_the_card_at_the_main_path_shapes(t, c, least):
    """32 KV heads of 128 (the 7B pair): at T = 1 one block per KV head
    would leave 100 of 132 SMs idle; the splits give several waves."""
    assert tca.plan(t, 32, 32, 128, c).blocks >= least
