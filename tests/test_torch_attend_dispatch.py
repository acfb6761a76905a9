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
