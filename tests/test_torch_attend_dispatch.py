"""attend's choice between the flash cell kernel and the dense path.

The cell kernel takes head widths that are a multiple of 8 and at most 128
(``ops.cell_attention.supports``); ``attend`` asks the same predicate, so a
llama whose heads are 100 wide (n_embd 3200 over 32 heads, OpenLLaMA-3B's
shape) takes the dense path on the card instead of raising. The decision is
checked with the card's branch forced on (``on_cuda=True``), and a tiny
D = 100 llama runs at a 512-cell pool through the port with the JAX
package's greedy stream."""

import numpy as np
import pytest

from pipeinfer_tpu.gguf.constants import GGMLQuantType as JQ
from pipeinfer_tpu.models import load_model as j_load
from pipeinfer_tpu.runtime.context import Batch as JBatch
from pipeinfer_tpu.runtime.context import InferenceContext as JContext
from pipeinfer_tpu.tools import testmodel
from pipeinfer_tpu_torch.models import load_model
from pipeinfer_tpu_torch.ops import cell_attention as tca
from pipeinfer_tpu_torch.runtime import kv_cache as tkv
from pipeinfer_tpu_torch.runtime.context import Batch, InferenceContext


@pytest.mark.parametrize("d,want", [(100, False), (128, True), (64, True), (136, False),
                                    (60, False)])
def test_dispatch_follows_the_kernel_predicate(d, want):
    """Card branch forced: a 512-cell pool at T = 1 goes to the kernel
    exactly when the kernel takes the head width."""
    assert tca.supports(d, 512, 32, 32) is want
    assert tkv.use_cell_kernel(1, 32, 32, d, 512, 0, on_cuda=True) is want
    assert tkv.use_cell_kernel(1, 32, 32, d, 512, 0, on_cuda=False) is False


def test_dispatch_keeps_its_thresholds_for_supported_heads():
    """D = 128: the pool size, the hot mark and T still decide as before."""
    assert tkv.use_cell_kernel(1, 32, 32, 128, 1024, 512, on_cuda=True)
    assert not tkv.use_cell_kernel(1, 32, 32, 128, 256, 0, on_cuda=True)  # short pool
    assert not tkv.use_cell_kernel(tkv.FLASH_SMALL_T + 1, 32, 32, 128, 1024, 0, on_cuda=True)
    assert tkv.use_cell_kernel(tkv.FLASH_SMALL_T + 1, 32, 32, 128, tkv.FLASH_MIN_CELLS_BIG, 0,
                               on_cuda=True)
    assert tkv.use_cell_kernel(1, 32, 8, 128, 1024, 0, on_cuda=True)  # GQA groups of 4


def test_f32_cache_takes_the_cell_kernel(monkeypatch, rng):
    """The kernel reads an f32 cache (--cache-dtype f32) as the JAX
    package's does: attend's choice does not look at the cache dtype, and
    with the card's branch forced it hands the f32 cache to the kernel's
    wrapper (the plain version here), which agrees with the Pallas kernel
    in interpret mode on the same cache."""
    import jax.numpy as jnp
    import torch

    from pipeinfer_tpu.ops.cell_attention import cell_attention as j_cell_attention

    t, h, kvh, d, c, used = 1, 8, 2, 64, 512, 300
    q = rng.standard_normal((t, h, d)).astype(np.float32)
    kc = rng.standard_normal((2, kvh, c, d)).astype(np.float32)
    vc = rng.standard_normal((2, kvh, c, d)).astype(np.float32)
    pos = np.full(c, -1, np.int32)
    pos[:used] = rng.permutation(used)
    seq = np.zeros((c, tkv.SEQ_WORDS), np.uint32)
    seq[:used, 0] = 1
    tok_pos, tok_seq, valid = np.full(t, used, np.int32), np.zeros(t, np.int32), np.ones(t, bool)
    alibi = np.asarray(tkv.alibi_slopes(h, 8.0))
    seen = []
    real = tkv.cell_attention

    def spy(q_, k_, *a, **kw):
        seen.append(k_.dtype)
        return real(q_, k_, *a, **kw)

    monkeypatch.setattr(tkv, "cell_attention", spy)
    monkeypatch.setattr(tkv, "use_cell_kernel", lambda *a: True)  # the card's branch
    cache = tkv.KVCache(k=torch.from_numpy(kc), v=torch.from_numpy(vc), pos=torch.from_numpy(pos),
                        seq=torch.from_numpy(seq.view(np.int32)))
    tp, ts = torch.from_numpy(tok_pos), torch.from_numpy(tok_seq)
    got = tkv.attend(torch.from_numpy(q), cache, 1, tkv.attn_mask(cache, tp, ts), tp, ts,
                     torch.from_numpy(valid), scale=d ** -0.5,
                     alibi=torch.from_numpy(alibi)).numpy()
    assert seen == [torch.float32]
    want = np.asarray(j_cell_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(pos), jnp.asarray(seq),
        jnp.asarray(tok_pos), jnp.asarray(tok_seq), jnp.asarray(valid), layer=1,
        scale=d ** -0.5, block_c=256, interpret=True, alibi=jnp.asarray(alibi)))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_supports_edges():
    """The other limits of the predicate (the wrapper raises on each)."""
    for d in (100, 136, 60):
        assert not tca.supports(d, 1024, 8, 8)
    assert not tca.supports(128, 1000, 8, 8)  # cells not a multiple of BLOCK_C
    assert not tca.supports(128, 1024, 6, 4)  # heads not whole GQA groups


def _greedy(ctx, batch, prompt, n):
    for i, t in enumerate(prompt):
        batch.add(t, i, 0, want_logits=(i == len(prompt) - 1))
    logits = ctx.decode(batch)[-1]
    out, n_past = [], len(prompt)
    for _ in range(n):
        tok = int(np.argmax(logits))
        out.append(tok)
        batch.clear()
        batch.add(tok, n_past, 0)
        logits = ctx.decode(batch)[0]
        n_past += 1
    return out


def test_d100_llama_at_512_cells_matches_jax(tmp_path):
    """n_embd 200 over 2 heads (D = 100), f32 weights (200 is no multiple
    of the 256-wide quant blocks), a 512-cell pool: the port's greedy
    stream equals the JAX package's."""
    path = testmodel.build_tiny_llama(tmp_path / "d100.gguf", seed=5, n_layers=2, n_embd=200,
                                      n_heads=2, n_kv_heads=2, n_ff=320, n_vocab=256,
                                      qtype=JQ.F32)
    prompt = [1, 17, 200, 33, 5, 9, 71, 44]
    jparams, jcfg = j_load(path)
    tparams, tcfg = load_model(path, device="cpu")
    assert tcfg.head_dim == 100
    want = _greedy(JContext(jparams, jcfg, n_cells=512), JBatch(), prompt, 24)
    got = _greedy(InferenceContext(tparams, tcfg, n_cells=512, device="cpu"), Batch(), prompt, 24)
    assert len(set(want)) > 1  # not a degenerate stream
    assert got == want
    assert not tkv.use_cell_kernel(1, tcfg.n_heads, tcfg.n_kv_heads, tcfg.head_dim, 512, 0,
                                   on_cuda=True)
