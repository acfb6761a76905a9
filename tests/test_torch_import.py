"""The PyTorch port stands alone: importing every module of
pipeinfer_tpu_torch (the CLIs, the tokenizer and the training tools
included, the image path: models.clip, cli.llava, tools.convert_clip, the
cross-process pipeline parallel.dcn, the file tools and the multi-device
modules parallel.mesh, tp, pipefused, multihost and utils.compile_cache,
and the native runtime's bindings) loads neither jax,
optax, ml_dtypes nor pipeinfer_tpu, nor the `regex`
package (which only a BPE vocabulary needs), chip_smoke.py imports none of
them, and the entry points refuse to fall back to the CPU."""

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
                or m.startswith("pipeinfer_tpu.") or m == "regex" or m == "optax"
                or m.startswith("optax.") or m == "ml_dtypes" or m.startswith("ml_dtypes."))
print(json.dumps({"modules": names, "leaked": leaked}))
"""


def test_import_leaves_jax_and_reference_out():
    # a subprocess: this test process has jax loaded already (conftest)
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["leaked"] == []
    for mod in ("ops.qmatmul", "ops.cell_attention", "runtime.context", "spec.controller",
                "spec.corrected", "models.convert", "cli.args", "cli.main", "cli.speculative",
                "tokenizer.vocab", "tokenizer.spm", "tokenizer.bpe", "tokenizer.stream",
                "sampling.grammar", "utils.kv_view", "models.generic", "models.staged",
                "parallel.stages", "spec.lookahead", "cli.pipeline", "cli.lookahead",
                "runtime.state", "tools.perplexity", "tools.bench", "tools.beam_search",
                "tools.batched", "tools.batched_bench", "tools.embedding", "tools.shapebench",
                "models.train", "tools.finetune", "tools.lora", "tools.export_lora",
                "tools.convert_train_checkpoint", "tools.quantize", "models.clip",
                "cli.llava", "cli.infill", "tools.convert_clip", "utils.rundump",
                "utils.logging", "parallel.dcn", "tools.convert_hf", "tools.convert_llama2c",
                "tools.gguf_dump", "tools.tokenize", "tools.json_schema", "tools.preset",
                "tools.results", "tools.quantize_stats", "parallel.mesh", "parallel.tp",
                "parallel.pipefused", "parallel.multihost", "utils.compile_cache",
                "native"):
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
        bad = _imported_roots(p) & {"jax", "jaxlib", "optax", "ml_dtypes", "pipeinfer_tpu"}
        assert not bad, f"{p.relative_to(ROOT)} imports {bad}"


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    from pipeinfer_tpu_torch import device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        device.resolve(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        device.resolve("cuda")
    assert device.resolve("cpu") == torch.device("cpu")


def test_a_mesh_that_names_cuda_needs_cuda(monkeypatch):
    """A mesh resolves its devices as every entry point does: without
    CUDA, naming cuda (or the default devices) raises."""
    from pipeinfer_tpu_torch.parallel import mesh, pipefused, tp

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tp.tp_mesh(["cuda:0"] * 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh.default_devices(4)
    with pytest.raises(RuntimeError, match="CUDA"):
        pipefused.make_mesh(pipefused.PipeConfig(n_stages=2, tp=1, dp=1))
    assert tp.tp_mesh(["cpu"] * 2).local_devices == [torch.device("cpu")] * 2
