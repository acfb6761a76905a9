"""The check that decides ``correct``, driven through a whole run at
unit-test widths on the CPU (the look for a card skipped): sound runs
pass, and each fault a one-chip serving cell can have, planted under the
timed path, turns ``correct`` false; the control (the reference at int4
activations in the program's place) reads past the limit too.

Readings at these widths against the reference at the stated precision
(3 s windows, 120-156 served tokens judged; seeds 1234567, 99 and 2^31 +
7, both architectures): sound 0-0.034, the control 0.27-0.40, the lanes'
state handed back unchanged 3.5-5.5, half the rows left out of the head
3.7-4.7, a token altered 4.5-6.0; the limit here is 0.1. The draft's
decisions (103-143 a run; seeds 1234567, 99, 2^31 + 7 and 5): sound
0-0.020, the control 0.14-0.39, the draft's layers skipped 0.087-0.303,
its upper layer of two skipped 0.027-0.153; the bar read here is 0.05.
The draft's reading is not part of ``correct``: at the configurations'
widths the draft's head decides every pick with or without its layers.
(A one-chip cell exchanges nothing between chips, so that fault has no
place here.)"""

import numpy as np
import pytest
import torch

import pipeinfer_tpu_torch.models.generic as generic
import pipeinfer_tpu_torch.models.llama as llama
import pipeinfer_tpu_torch.models.staged as staged
import pipeinfer_tpu_torch.spec.device_multi as dm
from portbench import check
from portbench import run as R
from portbench.tests import nano

torch.set_num_threads(1)
NANO_LIMIT, NANO_DRAFT_LIMIT = 0.1, 0.05


def _run(arch, fault=None, seed=1234567):
    cell = nano.cell(arch)
    cell.config["check"]["gap_limit"] = NANO_LIMIT
    return R.run_cell(cell, seed, 3.0, False, "cpu", log=lambda *a: None, fault=fault)


def token_altered(monkeypatch, n_vocab=2048):
    """The device loop's first committed token of each lane, changed in
    the pack the host reads."""
    orig = dm.enqueue

    def enqueue(*a, **k):
        handle, roots, bases = orig(*a, **k)
        fetch = handle.fetch

        def altered():
            pack = np.array(fetch())
            pack[0, :, 0] = (pack[0, :, 0] + 1) % n_vocab
            return pack

        handle.fetch = altered
        return handle, roots, bases

    return lambda sched: monkeypatch.setattr(dm, "enqueue", enqueue)


def state_unchanged(monkeypatch):
    """Every device-loop dispatch hands back the lanes' state (roots and
    frontiers) as it got it."""
    orig = dm.enqueue

    def enqueue(dft, tgt, roots, bases, *a, **k):
        handle, _, _ = orig(dft, tgt, roots, bases, *a, **k)
        return handle, roots, bases

    return lambda sched: monkeypatch.setattr(dm, "enqueue", enqueue)


def draft_layers_skipped(monkeypatch):
    """The draft runs without its layers (the embedding straight into its
    head): its picks change wherever the layers decide them, and the
    target still verifies every token, so the tokens stay right."""

    def plant(sched):
        monkeypatch.setitem(sched.devsrv.dft.params, "layers", [])

    return plant


def half_left_out(monkeypatch, n_vocab=2048):
    """Half of every step's rows are left out of the head: their logits
    come back zero."""
    orig = llama.linear

    def linear(x, w, bias=None):
        y = orig(x, w, bias)
        if y.shape[-1] == n_vocab:
            y = y.clone()
            y[y.shape[0] // 2:] = 0.0
        return y

    def plant(sched):
        for mod in (llama, generic, staged):
            monkeypatch.setattr(mod, "linear", linear)

    return plant


@pytest.mark.parametrize("arch", ["mpt", "llama"])
def test_sound_run_is_correct_and_control_is_not(arch):
    res = _run(arch)
    assert res["correct"], res["checks"]
    judged, ref, gaps, dgaps = res["_judged"]
    assert gaps.max() <= NANO_LIMIT and dgaps.max() <= NANO_DRAFT_LIMIT
    ctrl = check.control_gaps(ref, ref.with_bits(4), judged)
    assert ctrl.max() > NANO_LIMIT
    depth = nano.mix()["server"]["spec"]["n_draft"]
    dctrl = check.draft_control_gaps(ref.draft(), ref.with_bits(4).draft(), judged, depth)
    assert dctrl.max() > NANO_DRAFT_LIMIT


@pytest.mark.parametrize("fault", [token_altered, state_unchanged, half_left_out])
@pytest.mark.parametrize("arch", ["mpt", "llama"])
def test_fault_under_the_timed_path_is_caught(arch, fault, monkeypatch):
    res = _run(arch, fault(monkeypatch))
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("arch", ["mpt", "llama"])
def test_draft_layers_skipped_show_in_the_draft_reading(arch, monkeypatch):
    """A draft that skips its layers serves the right tokens, so the run
    stays correct; where the layers decide its picks, as at these widths,
    its decisions read past the sound runs'."""
    res = _run(arch, draft_layers_skipped(monkeypatch))
    assert res["correct"], res["checks"]
    assert res["_judged"][3].max() > NANO_DRAFT_LIMIT
