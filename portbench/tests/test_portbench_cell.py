"""The harness finds a cell's files by name and holds names and units to
the benchmark's characters."""

import json

import pytest

from portbench.cell import HERE, ROOT, Cell, benchmark, check_name, check_unit, load_metric


def test_every_cell_resolves():
    b = benchmark()
    for w in b["workloads"]:
        c = Cell(b, w["name"])
        assert c.config["model"]["n_embd"] > 0 and c.mix["loop"] in ("open", "closed")
        assert c.end_to_end and c.per_layer


def test_every_metric_has_a_reader_and_every_file_is_under_paths():
    b = benchmark()
    for m in b["per_layer"]:
        assert callable(load_metric(m["name"]).read)
    for c in b["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("portbench/")
    assert b["paths"] == ["portbench"]
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names)) and "setup_s" in names


@pytest.mark.parametrize("bad", ["", ".x", "-x", "a b", "a/b", "a,b", "x" * 65, "µs"])
def test_bad_names_are_refused(bad):
    with pytest.raises(ValueError):
        check_name(bad)


@pytest.mark.parametrize("bad", ["", "tokens per s", "x" * 17, "µs"])
def test_bad_units_are_refused(bad):
    with pytest.raises(ValueError):
        check_unit(bad)


def test_good_names_and_units_pass():
    for n in ("mpt7b_q4km.greedy_open", "prefill_ms.p50", "_x", "9a-b"):
        assert check_name(n) == n
    for u in ("tokens/s", "%", "kernels/token", "ms"):
        assert check_unit(u) == u


def test_unknown_workload_is_refused():
    with pytest.raises(KeyError):
        Cell(benchmark(), "no_such.cell")


def test_a_new_cell_needs_only_data(tmp_path):
    """A cell added by entries and data files runs through the same code:
    its configuration file is found by its path, its mix by its name."""
    b = json.loads(json.dumps(benchmark()))
    b["workloads"].append({"name": "mistral7b_q4km.greedy_open", "config": "mistral7b_q4km",
                           "traffic": "greedy_open", "chips": 1, "why": "x"})
    c = Cell(b, "mistral7b_q4km.greedy_open")
    assert c.config["model"]["arch"] == "llama" and c.mix["loop"] == "open"
    assert (HERE / "traffic" / "greedy_open.json").is_file()
