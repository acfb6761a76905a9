"""A cell at unit-test widths on the CPU: the benchmark's own configuration
and traffic files with the widths, lengths and pool cut, and the program's
i4g and i8g layouts (their plain versions) as the card would run them."""

from __future__ import annotations

import json
import os
from types import SimpleNamespace

from portbench.cell import HERE

CONFIGS = {"mpt": "mpt7b_q4km", "llama": "mistral7b_q4km"}
NANO = {"mpt": dict(n_embd=256, n_heads=2, n_kv_heads=2, n_ff=1024, n_vocab=2048, n_layers=4),
        "llama": dict(n_embd=256, n_heads=2, n_kv_heads=1, n_ff=768, n_vocab=2048, n_layers=4)}


def config(arch: str) -> dict:
    conf = json.loads((HERE / "configs" / f"{CONFIGS[arch]}.json").read_text())
    conf["model"].update(NANO[arch])
    conf["weights"]["draft_layers"] = 2
    conf["check"].update(min_tokens=120, min_judged=20)
    return conf


def mix(name: str = "greedy_open") -> dict:
    m = json.loads((HERE / "traffic" / f"{name}.json").read_text())
    m["lead_s"] = 0.5
    if m["loop"] == "open":
        m["rate_rps"] = 6.0
    else:
        m.update(clients=4, stagger_s=0.2)
    m["prompt"].update(median=24, min=8, max=48)
    m["output"].update(median=24, min=12, max=48)
    m["server"].update(device_lanes=4, max_slots=4, n_cells=2048)
    m["server"]["spec"]["n_draft"] = 4
    return m


def cell(arch: str = "mpt", traffic: str = "greedy_open", per_layer=()):
    """A stand-in for cell.Cell at nano size, reporting the end-to-end
    metrics and the named per-layer ones of BENCHMARK.json."""
    os.environ["PIPEINFER_WEIGHT_LAYOUT"] = "i4g"
    from portbench.cell import benchmark

    b = benchmark()
    return SimpleNamespace(name=f"nano_{arch}.{traffic}", chips=1, config=config(arch),
                           mix=mix(traffic), end_to_end=b["end_to_end"],
                           per_layer=[m for m in b["per_layer"] if m["name"] in per_layer])
