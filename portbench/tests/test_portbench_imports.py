"""What the benchmark loads: no module whose top-level name is jax,
jaxlib, flax or pipeinfer_tpu (names compared whole: pipeinfer_tpu_torch
is the program, and begins with the JAX package's name), and a reference
that loads nothing of the program either. Each in a fresh process."""

import json
import subprocess
import sys

from portbench.cell import ROOT

_HARNESS = r"""
import json, os, sys
os.environ["PIPEINFER_WEIGHT_LAYOUT"] = "i4g"
import torch
torch.set_num_threads(1)
from portbench import run as R
from portbench.tests import nano
res = R.run_cell(nano.cell("mpt"), 11, 1.0, False, "cpu", log=lambda *a: None)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""

_REFERENCE = r"""
import json, sys, torch
from portbench.reference.model import Reference
from portbench.reference import dequant
from types import SimpleNamespace
raw = torch.zeros(2 * 144, dtype=torch.uint8)
assert dequant.q4_k(raw, 2, 256).shape == (2, 256)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _top_level(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    mods = _top_level(_HARNESS)
    assert "pipeinfer_tpu_torch" in mods and "portbench" in mods
    assert not mods & {"jax", "jaxlib", "flax", "pipeinfer_tpu"}


def test_reference_loads_nothing_of_the_program():
    mods = _top_level(_REFERENCE)
    assert not mods & {"jax", "jaxlib", "flax", "pipeinfer_tpu", "pipeinfer_tpu_torch"}


def test_forbidden_names_compare_whole():
    from portbench.run import forbidden_modules

    sys.modules.setdefault("pipeinfer_tpu_torch_like", sys)  # a longer name is not the package
    try:
        assert "pipeinfer_tpu_torch_like" not in forbidden_modules()
    finally:
        del sys.modules["pipeinfer_tpu_torch_like"]
