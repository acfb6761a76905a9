"""The port's session state (runtime/state.py) on the CPU, mirroring the JAX
package's tests/test_state_and_tools.py:33-58 for a bf16 and an f32 cache:
a save/load round trip continues exactly as the live context does, a file
of another shape is refused, and session files cross between the packages
(the JAX package saves and the port loads, and the other way round) and
continue to the same greedy tokens."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pipeinfer_tpu.models import load_model as j_load
from pipeinfer_tpu.runtime import state as j_state
from pipeinfer_tpu.runtime.context import Batch as JBatch
from pipeinfer_tpu.runtime.context import InferenceContext as JContext
from pipeinfer_tpu_torch.models import load_model
from pipeinfer_tpu_torch.runtime import kv_cache as kv
from pipeinfer_tpu_torch.runtime import state as rstate
from pipeinfer_tpu_torch.runtime.context import Batch, InferenceContext
from pipeinfer_tpu_torch.tools import testmodel

torch.set_num_threads(1)  # several test processes share the machine

CFG = dict(n_layers=2, n_embd=64, n_heads=4, n_kv_heads=2, n_ff=128, n_vocab=300)
PROMPT = [5, 9, 23, 41]
DTYPES = {"bf16": (torch.bfloat16, jnp.bfloat16), "f32": (torch.float32, jnp.float32)}


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    p = tmp_path_factory.mktemp("torch_state") / "m.gguf"
    testmodel.build_tiny_llama(p, seed=3, **CFG)
    return p


@pytest.fixture(scope="module")
def model(path):
    return load_model(path, device="cpu")


def _ctx(model, dtype, n_cells=32):
    return InferenceContext(*model, n_cells=n_cells, cache_dtype=DTYPES[dtype][0], device="cpu")


def _decode_tokens(ctx, tokens, pos0=0, batch=Batch):
    b = batch()
    for i, t in enumerate(tokens):
        b.add(t, pos0 + i, 0, want_logits=True)
    return np.asarray(ctx.decode(b))


def _greedy(ctx, first, pos0, n, batch=Batch):
    """n greedy tokens after `first` (decoded at pos0), one step each."""
    out, tok = [], first
    for i in range(n):
        tok = int(np.argmax(_decode_tokens(ctx, [tok], pos0 + i, batch)[0]))
        out.append(tok)
    return out


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_state_round_trip(model, dtype, tmp_path):
    """ref: examples/save-load-state round-trip check. The restored cache
    holds the saved bits, so the continuation's logits are equal (no
    tolerance), and the host mirrors and the hot bound are rebuilt."""
    ctx = _ctx(model, dtype)
    _decode_tokens(ctx, PROMPT)
    rstate.save_state(ctx, tmp_path / "s.npz", tokens=PROMPT)

    ctx2 = _ctx(model, dtype)
    toks = rstate.load_state(ctx2, tmp_path / "s.npz")
    assert toks == PROMPT
    for a, b in ((ctx.cache.k, ctx2.cache.k), (ctx.cache.v, ctx2.cache.v),
                 (ctx.cache.pos, ctx2.cache.pos), (ctx.cache.seq, ctx2.cache.seq)):
        assert torch.equal(a, b)
    assert ctx2.cache.k.dtype == DTYPES[dtype][0]
    np.testing.assert_array_equal(ctx2.h_pos, ctx.h_pos)
    np.testing.assert_array_equal(ctx2.h_seq, ctx.h_seq)
    assert ctx2.h_seq.dtype == np.uint32 and ctx2.h_pos.dtype == np.int64

    want = _decode_tokens(ctx, [7], pos0=4)  # continue from the live context
    got = _decode_tokens(ctx2, [7], pos0=4)
    np.testing.assert_array_equal(got, want)
    assert _greedy(ctx2, 7, 5, 6) == _greedy(ctx, 7, 5, 6)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_state_shape_mismatch(model, dtype, tmp_path):
    ctx = _ctx(model, dtype)
    rstate.save_state(ctx, tmp_path / "s.npz")
    ctx2 = _ctx(model, dtype, n_cells=64)
    with pytest.raises(ValueError, match="shape mismatch"):
        rstate.load_state(ctx2, tmp_path / "s.npz")


def test_load_rebuilds_what_a_step_reads(model, tmp_path):
    """After a load the trash cell is empty on the device and in the mirror
    (a saved file may hold a padding row's write there), and the hot bound
    covers the restored cells of a pool over 512 cells."""
    ctx = _ctx(model, "f32", n_cells=1024)
    _decode_tokens(ctx, PROMPT)
    ctx.cache.pos[ctx.trash_cell] = 3  # as a padding row might leave it
    ctx.cache.seq[ctx.trash_cell, 0] = 1
    rstate.save_state(ctx, tmp_path / "s.npz")
    ctx2 = _ctx(model, "f32", n_cells=1024)
    ctx2.cache.hot = 0
    rstate.load_state(ctx2, tmp_path / "s.npz")
    assert int(ctx2.cache.pos[ctx2.trash_cell]) == -1
    assert int(ctx2.cache.seq[ctx2.trash_cell].abs().sum()) == 0
    assert ctx2.cache.hot == kv.hot_bucket(ctx2.h_pos, ctx2.trash_cell) == 512


def test_legacy_mirror_and_seq_words(model, tmp_path):
    """The legacy uint64-scalar mirror loads into SEQ_WORDS words; a mirror
    of another word count is refused with the JAX package's message."""
    ctx = _ctx(model, "f32")
    _decode_tokens(ctx, PROMPT)
    rstate.save_state(ctx, tmp_path / "s.npz")
    with np.load(tmp_path / "s.npz") as z:
        arrays = {k: z[k] for k in z.files}
    legacy = dict(arrays, h_seq=arrays["h_seq"].copy().view(np.uint64).reshape(-1))
    np.savez_compressed(tmp_path / "legacy.npz", **legacy)
    ctx2 = _ctx(model, "f32")
    rstate.load_state(ctx2, tmp_path / "legacy.npz")
    np.testing.assert_array_equal(ctx2.h_seq, ctx.h_seq)
    wide = dict(arrays, h_seq=np.zeros((ctx.n_cells, kv.SEQ_WORDS + 1), np.uint32))
    np.savez_compressed(tmp_path / "wide.npz", **wide)
    with pytest.raises(ValueError, match=f"SEQ_WORDS={kv.SEQ_WORDS + 1}"):
        rstate.load_state(_ctx(model, "f32"), tmp_path / "wide.npz")


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_session_files_cross_packages(path, model, dtype, writer, tmp_path):
    """A session one package writes, the other loads: the cache bits, pos,
    seq words and mirrors arrive unchanged, and both packages continue to
    the same 8 greedy tokens from it."""
    t_dtype, j_dtype = DTYPES[dtype]
    jmodel = j_load(path)
    f = tmp_path / "s.npz"
    jctx = JContext(*jmodel, n_cells=32, cache_dtype=j_dtype)
    pctx = _ctx(model, dtype)
    src, dst, load = ((jctx, pctx, rstate.load_state) if writer == "jax"
                      else (pctx, jctx, j_state.load_state))
    _decode_tokens(src, PROMPT, batch=JBatch if src is jctx else Batch)
    (j_state if writer == "jax" else rstate).save_state(src, f, tokens=PROMPT)
    assert load(dst, f) == PROMPT
    np.testing.assert_array_equal(np.asarray(dst.h_pos), np.asarray(src.h_pos))
    np.testing.assert_array_equal(np.asarray(dst.h_seq), np.asarray(src.h_seq))
    jc, pc = jctx.cache, pctx.cache
    np.testing.assert_array_equal(np.asarray(jc.pos), pc.pos.numpy())
    np.testing.assert_array_equal(np.asarray(jc.seq), pc.seq.numpy().view(np.uint32))
    for j_slab, t_slab in ((jc.k, pc.k), (jc.v, pc.v)):
        np.testing.assert_array_equal(np.asarray(j_slab, np.float32), t_slab.float().numpy())
    want = _greedy(jctx, 7, 4, 8, batch=JBatch)
    assert _greedy(pctx, 7, 4, 8) == want
