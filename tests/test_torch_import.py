"""The PyTorch port stands alone: importing every module of
pipeinfer_tpu_torch loads neither jax nor pipeinfer_tpu, chip_smoke.py
imports neither, and the entry points refuse to fall back to the CPU."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent

_PROBE = r"""
import importlib, json, pkgutil, sys
import pipeinfer_tpu_torch
names = [m.name for m in
         pkgutil.walk_packages(pipeinfer_tpu_torch.__path__, "pipeinfer_tpu_torch.")]
for n in names:
    importlib.import_module(n)
leaked = sorted(m for m in sys.modules
                if m == "jax" or m.startswith("jax.") or m == "pipeinfer_tpu"
                or m.startswith("pipeinfer_tpu."))
print(json.dumps({"modules": names, "leaked": leaked}))
"""


def test_import_leaves_jax_and_reference_out():
    # a subprocess: this test process has jax loaded already (conftest)
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["leaked"] == []
    for mod in ("ops.qmatmul", "ops.cell_attention", "runtime.context", "spec.controller",
                "spec.corrected", "models.convert"):
        assert f"pipeinfer_tpu_torch.{mod}" in res["modules"]


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("rel", ["chip_smoke.py", "pipeinfer_tpu_torch"])
def test_sources_import_no_jax(rel):
    paths = [ROOT / rel] if rel.endswith(".py") else sorted((ROOT / rel).rglob("*.py"))
    for p in paths:
        bad = _imported_roots(p) & {"jax", "jaxlib", "pipeinfer_tpu"}
        assert not bad, f"{p.relative_to(ROOT)} imports {bad}"


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    from pipeinfer_tpu_torch import device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        device.resolve(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        device.resolve("cuda")
    assert device.resolve("cpu") == torch.device("cpu")
