"""Find a cell's files by the names in BENCHMARK.json: its configuration
(``configs/<file>``), its traffic mix (``traffic/<traffic>.json``) and its
per-layer metrics (``metrics/<name>.py``), each a file of its own, so a
later change adds a cell or a metric by adding files and entries only."""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def check_name(name: str) -> str:
    if not isinstance(name, str) or not NAME.match(name):
        raise ValueError(f"bad name {name!r}: 1-64 of letters, digits, '_', '.', '-', "
                         "not starting with '.' or '-'")
    return name


def check_unit(unit: str) -> str:
    if not isinstance(unit, str) or not UNIT.match(unit):
        raise ValueError(f"bad unit {unit!r}: 1-16 of letters, digits, '_', '/', '%', '.', '-'")
    return unit


def benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


class Cell:
    """One workload of BENCHMARK.json with its configuration, mix and the
    metrics it reports."""

    def __init__(self, bench: dict, workload: str, root: Path = ROOT):
        check_name(workload)
        wl = [w for w in bench["workloads"] if w["name"] == workload]
        if not wl:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        self.workload = wl[0]
        self.name = workload
        conf = [c for c in bench["configs"] if c["name"] == check_name(self.workload["config"])]
        if not conf:
            raise KeyError(f"no config {self.workload['config']!r} in BENCHMARK.json")
        self.config_entry = conf[0]
        self.config = json.loads((root / conf[0]["file"]).read_text())
        traffic = check_name(self.workload["traffic"])
        self.mix = json.loads((HERE / "traffic" / f"{traffic}.json").read_text())
        self.chips = int(self.workload["chips"])
        self.end_to_end = [m for m in bench["end_to_end"] if self._reports(m)]
        self.per_layer = [m for m in bench["per_layer"] if self._reports(m)]
        for m in self.end_to_end + self.per_layer:
            check_name(m["name"])
            check_unit(m["unit"])

    def _reports(self, metric: dict) -> bool:
        return "workloads" not in metric or self.name in metric["workloads"]


def load_metric(name: str):
    """The reader module of per-layer metric `name`: metrics/<name>.py,
    whose ``read(run)`` returns a number or None (nothing to read)."""
    path = HERE / "metrics" / f"{check_name(name)}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
