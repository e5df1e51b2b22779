"""Whole runs of each cell on the CPU at a tiny size: the result line, the
import guard, the controls and the faults that ``correct`` must catch."""

import json
import sys

import numpy as np
import pytest
import torch

import harness
from conftest import driver_of, tiny

CELLS = [w["name"] for w in harness.load_spec()["workloads"]]
SEED = 2 ** 31 + 101


def run(workload, trace=False, make_entry=None, seconds=0.3, overrides=None,
        min_calls=1):
    """A tiny run.  The window is doubled until it holds ``min_calls``
    calls: on a loaded host one call can outlast a short window, and a
    fault that shows from the second call on would go unseen."""
    while True:
        lines = []
        out = harness.run_cell(workload, SEED, seconds, trace, "cpu",
                               overrides=overrides or tiny(workload),
                               make_entry=make_entry, log=lines.append)
        window = next(m for m in lines if m.startswith("window:"))
        if int(window.split()[1]) >= min_calls:
            return out
        seconds *= 2


@pytest.mark.parametrize("workload", CELLS)
def test_tiny_run_prints_the_result_line(workload):
    result, checks, _ = run(workload)
    line = json.loads(harness.result_line(result, checks))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    assert set(line["metrics"]) == {"frames_per_s", "latency_ms_p95",
                                    "setup_s"}
    assert all(v["value"] > 0 for v in line["metrics"].values())
    assert line["checks"] and all(
        c["value"] <= c["limit"] for c in line["checks"].values())


@pytest.mark.parametrize("workload", ["slic720.stream", "slic720.batch4"])
def test_tiny_traced_run_reads_the_per_layer_metrics(workload):
    result, _, _ = run(workload, trace=True)
    assert result["correct"] is True
    assert "breakdown" in result and "window_s" in result["device"]
    names = {m["name"] for m in harness.load_spec()["per_layer"]
             if workload in m["workloads"]}
    # the CPU has no device trace: those metrics are left out, not zero
    assert set(result["metrics"]) <= names
    assert "runner.ties_per_frame" in result["metrics"]
    assert "kernels.roofline_pct" not in result["metrics"]


def test_main_refuses_without_a_card(capsys, monkeypatch):
    import run as run_cli
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run_cli.main(["--workload", CELLS[0], "--seed", "1",
                       "--seconds", "1", "--trace", "0"])
    assert rc != 0 and capsys.readouterr().out == ""


def test_import_guard_compares_whole_top_level_names(monkeypatch):
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "fast_slic_tpu_torch_x", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert harness.forbidden_modules() == ["jax"]


def test_a_run_loads_no_jax():
    run(CELLS[0])
    assert harness.forbidden_modules() == []


@pytest.mark.parametrize("workload", CELLS)
def test_control_comes_out_not_correct(workload):
    """The driver's control in the program's place (the reference,
    weakened as the configuration's control says) fails the limits."""
    drv, _ = driver_of(workload)
    result, checks, _ = run(workload, make_entry=drv.control_entry,
                            seconds=0.5, min_calls=3)
    assert result["correct"] is False, checks


# -- faults planted in the program -------------------------------------------

FAULTS = [(w, f) for w in CELLS for drv, cfg in [driver_of(w)]
          for f in drv.faults(cfg)]


def _run_with(fault, workload):
    """A tiny run with ``fault`` planted, every call compared (at the
    cells' own size and share: ``control.py --fault`` on the card)."""
    overrides = tiny(workload)
    overrides["traffic"]["compare_share"] = 1.0
    undo = driver_of(workload)[0].plant(fault)
    try:
        return run(workload, seconds=0.5, overrides=overrides, min_calls=3)
    finally:
        undo()


@pytest.mark.parametrize("workload,fault", FAULTS)
def test_fault_in_the_timed_path_comes_out_not_correct(workload, fault):
    result, checks, _ = _run_with(fault, workload)
    assert result["correct"] is False, checks


@pytest.mark.parametrize("workload", CELLS)
def test_fault_is_taken_out_again(workload):
    from fast_slic_tpu_torch import runner
    from fast_slic_tpu_torch.parallel import batch
    real = runner.run_iterate, batch.BatchedSlic.iterate
    drv, cfg = driver_of(workload)
    for fault in drv.faults(cfg):
        drv.plant(fault)()
    assert (runner.run_iterate, batch.BatchedSlic.iterate) == real


# -- on the card ---------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_cell_is_correct_on_the_card(cuda, workload):
    """A short run of each cell at its full size on the card."""
    result, checks, _ = harness.run_cell(workload, SEED, 2.0, False,
                                         "cuda", log=lambda msg: None)
    assert result["correct"] is True, checks
    assert result["device"]["platform"] == "gpu"


@pytest.mark.gpu
def test_traced_run_reads_the_device(cuda):
    result, _, _ = harness.run_cell("slic720.stream", SEED, 2.0, True,
                                    "cuda", log=lambda msg: None)
    m = result["metrics"]
    assert 0 < m["kernels.roofline_pct"]["value"] <= 100
    assert 0 <= m["device.idle_pct"]["value"] < 100
    assert m["dispatch.launches_per_frame"]["value"] > 100
    assert result["device"]["busy_s"] > 0
    assert len(result["breakdown"]["device_ops"]) == 10
