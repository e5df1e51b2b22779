"""BENCHMARK.json and the files it names."""

import json
import re

import pytest

import harness

SPEC = harness.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
# what a driver provides (harness.py's docstring)
DRIVER = ("entry", "Loop", "compare", "control_entry", "faults", "plant",
          "TINY")


def test_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"][:2] == ["python3", "bench_port/run.py"]
    assert SPEC["paths"] == ["bench_port"]
    assert 1 <= SPEC["run_seconds"] <= 51
    cells = len(SPEC["workloads"])
    assert all(w["chips"] in (1, 4) for w in SPEC["workloads"])
    fours = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert fours <= max(1, cells // 4)
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_names_units_and_entries():
    names = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in SPEC[group]:
            assert NAME.match(e["name"]), e["name"]
            names.add((group, e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
    for e in SPEC["end_to_end"]:
        assert set(e) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
    assert any(e["name"] == "setup_s" for e in SPEC["end_to_end"])
    assert len(names) == sum(len(SPEC[g]) for g in (
        "configs", "workloads", "end_to_end", "per_layer"))


@pytest.mark.parametrize("w", SPEC["workloads"], ids=lambda w: w["name"])
def test_each_cell_finds_its_files(w):
    """The configuration, traffic, driver and per-layer readers of every
    cell are found by name, and the cell reports a per-layer metric."""
    _, cfg, traffic = harness.cell(SPEC, w["name"])
    drv = harness.driver(traffic["loop"])
    for name in DRIVER:
        assert hasattr(drv, name), (traffic["loop"], name)
    assert drv.faults(cfg), "no fault for the limits to catch"
    assert cfg["limits"] and all(
        isinstance(v, (int, float)) for v in cfg["limits"].values())
    layer = [m for m in SPEC["per_layer"]
             if w["name"] in m.get("workloads", [w["name"]])]
    assert layer
    for m in layer:
        assert callable(harness.metric_reader(m["name"]))
    assert len(w["why"]) <= 200


@pytest.mark.parametrize("c", SPEC["configs"], ids=lambda c: c["name"])
def test_configs(c):
    assert c["file"].startswith("bench_port/configs/")
    cfg = json.loads((harness.ROOT / c["file"]).read_text())
    assert isinstance(c["reduced"], list) and len(c["reduced"]) <= 16
    assert all(NAME.match(k) and k in cfg for k in c["reduced"])
    assert c["source"].startswith("https://")
    used = [w for w in SPEC["workloads"] if w["config"] == c["name"]]
    assert used


def test_per_layer_moves_and_cells():
    e2e = {e["name"] for e in SPEC["end_to_end"]}
    cells = {w["name"] for w in SPEC["workloads"]}
    layers = {}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        layers.setdefault(m["layer"], []).append(m["name"])
    assert {"runner.py", "pipeline.py", "dispatch", "csrc/*.cu",
            "device"} <= set(layers)
