"""The live-model check's bar against what it must let through and what it
must catch, on the CPU at unit-test widths (the mpt_nano live model: 2
layers, n_embd 256, 2 heads of 128, ALiBi max bias 8).

tools/live_check.LIVE_RTOL bounds the card-against-CPU spread of the live
model's logits in chip_smoke.py. Here another f32 summation order
(every quantized matmul's output moved by 3e-7 relative) must stay well
inside it, and each of live_check.FAULTS (cells dropped, positions read
one cell off, ALiBi slopes one head off) must land outside it."""

import numpy as np
import pytest
import torch

from pipeinfer_tpu_torch.models import load_model
from pipeinfer_tpu_torch.tools import live_check as LC
from pipeinfer_tpu_torch.tools import testmodel


@pytest.fixture(scope="module")
def live(tmp_path_factory):
    d = tmp_path_factory.mktemp("live_check")
    testmodel.build_mpt_bench_pair(d / "t.gguf", d / "d.gguf", scale="mpt_nano", seed=42,
                                   live_path=d / "live.gguf")
    params, cfg = load_model(d / "live.gguf", device="cpu")
    toks = LC.live_tokens(cfg.n_vocab, 42)
    return params, cfg, toks, LC.run_live(params, cfg, toks, torch.device("cpu"))


def test_another_f32_order_stays_inside_the_bar(live):
    """At most a tenth of the bar: the card's kernels sum in other orders."""
    params, cfg, toks, want = live
    assert want.shape == (LC.PREFILL + LC.STEPS, cfg.n_vocab) and np.isfinite(want).all()
    with LC.perturbed_matmuls(3e-7):
        got = LC.run_live(params, cfg, toks, torch.device("cpu"))
    assert 0 < LC.spread(got, want) <= LC.LIVE_RTOL / 10


@pytest.mark.parametrize("name", list(LC.FAULTS))
def test_each_fault_fails_the_bar(live, name):
    params, cfg, toks, want = live
    with LC.fault(name):
        got = LC.run_live(params, cfg, toks, torch.device("cpu"))
    assert LC.spread(got, want) > LC.LIVE_RTOL


def test_fault_routes_single_token_steps_through_the_cell_kernel(live, monkeypatch):
    """Under a fault the single-token steps reach the kernel's wrapper (its
    plain version here), so the fault sits where the card's kernel reads
    its inputs; with the fault a no-op the logits equal the plain run's."""
    params, cfg, toks, want = live
    calls = []
    monkeypatch.setitem(LC.FAULTS, "none", lambda pos, tok_pos, alibi: (calls.append(1) or pos,
                                                                          alibi))
    with LC.fault("none"):
        got = LC.run_live(params, cfg, toks, torch.device("cpu"))
    assert len(calls) == LC.STEPS * cfg.n_layers
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
