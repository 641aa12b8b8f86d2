"""The benchmark's pieces are found by name, and BENCHMARK.json keeps to
the contract's shape; a cell added as a file runs without an edit."""

import json
import re
import shutil

import pytest

from cellbench import harness, registry

BENCH = registry.benchmark()
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}\Z")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}\Z")
CELLS = [w["name"] for w in BENCH["workloads"]]


def _cells(m):
    """The cells that report a metric: its `workloads`, or every cell."""
    return m.get("workloads", CELLS)


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_benchmark_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["cellbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert all(_line(w) for w in BENCH["command"])
    names = []
    for sec in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[sec]:
            assert NAME.match(e["name"]), e["name"]
            names.append((sec in ("end_to_end", "per_layer"), e["name"]))
    assert len(set(names)) == len(names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(_cells(m)) <= set(CELLS)
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    # set-up is every cell's, those that later PRs add too
    setup = next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")
    assert "workloads" not in setup and setup["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert _line(m["layer"])
        moved = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
        # every cell that reports the metric reports what it moves
        assert set(_cells(m)) <= set(_cells(moved))


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_reports_setup_an_end_to_end_and_a_layer(cell):
    e2e = [m["name"] for m in BENCH["end_to_end"] if cell in _cells(m)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(cell in _cells(m) for m in BENCH["per_layer"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_are_found_by_name(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    c = registry.cell(cell)
    assert (c["config"], c["traffic"], c["chips"], c["why"]) == (
        entry["config"], entry["traffic"], entry["chips"], entry["why"])
    assert _line(c["why"]) and c["chips"] in (1, 4)
    assert callable(registry.traffic(c["kind"]).run)
    conf = registry.config(c["config"])
    for f in conf["flows"]:
        assert callable(registry.reference(f["kind"]).outflow)
        assert registry.work(f["kind"]).ops(f) > 0


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_entries_match_their_files(conf):
    d = registry.config(conf["name"])
    assert conf["file"] == f"cellbench/configs/{conf['name']}.json"
    assert d["source"] == conf["source"] and _line(conf["source"])
    assert d["reduced"] == conf["reduced"]
    assert all(k in d for k in d["reduced"])
    assert any(w["config"] == conf["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_every_per_layer_metric_has_a_reader(m):
    assert registry.metric(m["name"]).read({}) is None


@pytest.mark.parametrize("bad", ["../x", "a/b", "", " x", "a" * 65, 7])
def test_names_outside_the_contract_are_refused(bad):
    with pytest.raises(ValueError):
        registry.cell(bad)


def test_missing_piece_is_a_lookup_error():
    with pytest.raises(LookupError):
        registry.metric("no_such_metric.grid")


def test_a_cell_added_as_a_file_runs(tmp_path):
    root = tmp_path / "cellbench"
    shutil.copytree(registry.ROOT, root,
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    shutil.copy(registry.ROOT.parent / "BENCHMARK.json", tmp_path)
    cell = registry.cell("moore8.grid16k", root)
    cell.update(name="moore8.tiny", traffic="tiny",
                params={**cell["params"], "side": 32, "steps": 9,
                        "warmup_calls": 1})
    (root / "workloads" / "moore8.tiny.json").write_text(json.dumps(cell))
    ctx = harness.execute("moore8.tiny", 11, 0.2, False, device="cpu",
                          build_dir=str(tmp_path / "build"), root=root)
    assert ctx.checks.ok and ctx.attempted >= 1
    assert ctx.e2e["cell_updates_per_s"] > 0
