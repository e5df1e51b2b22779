"""The preemptive cell's own checks: a traced run on the CPU reads the
grid's activity from its entry's reports, the readers give nothing for a
program that keeps no activity, and the masked update's least time counts
the bytes its docstring names."""

import json

import numpy as np
import pytest

import harness
import roofline
import roofline_preemptive as rp
from conftest import driver_of, tiny

CELL = "slic1080.preemptive"
SEED = 2 ** 31 + 103


def _traced_tiny_run(seconds=0.3):
    """A traced run at TINY; the window is doubled until it holds a call."""
    while True:
        lines = []
        out = harness.run_cell(CELL, SEED, seconds, True, "cpu",
                               overrides=tiny(CELL), log=lines.append)
        window = next(m for m in lines if m.startswith("window:"))
        if int(window.split()[1]) >= 1:
            return out
        seconds *= 2


def test_traced_run_reads_the_grid_activity():
    """On the CPU the share of update pixels is read from the reports;
    the metrics of a device trace are left out."""
    result, _, _ = _traced_tiny_run()
    assert result["correct"] is True
    share = result["metrics"]["preemptive.update_px_share"]
    assert share["unit"] == "%" and 0 < share["value"] < 100
    assert "preemptive.step_idle_ms" not in result["metrics"]
    assert "preemptive.masked_update_roofline_pct" not in result["metrics"]


def test_entry_report_carries_the_activity():
    drv, cfg = driver_of(CELL)
    cfg.update(tiny(CELL)["config"])
    entry = drv.entry(cfg, {}, "cpu")
    image = np.random.default_rng(3).integers(
        0, 256, (1, cfg["height"], cfg["width"], 3), dtype=np.uint8)
    entry.call(image)
    rep = json.loads(entry.report())
    model = entry.obj.slic_model
    assert model.preemptive and model.preemptive_thres == 0.05
    assert rep["preemptive_activity"] == (
        model.last_preemptive_activity.tolist())
    assert len(rep["preemptive_activity"]) == cfg["max_iter"]
    assert rep["name"] == "iterate" and "counters" in rep
    # a program that keeps no activity: the plain report, nothing to read
    model.last_preemptive_activity = None
    assert "preemptive_activity" not in json.loads(entry.report())


class _Rec:
    def __init__(self, cfg, reports, slice_=None):
        self.cfg, self.reports, self.slice = cfg, reports, slice_


@pytest.mark.parametrize("name", ["preemptive.update_px_share",
                                  "preemptive.masked_update_roofline_pct",
                                  "preemptive.step_idle_ms"])
def test_readers_give_nothing_without_activity(name):
    _, cfg = driver_of(CELL)
    plain = json.dumps({"name": "iterate", "children": [],
                        "counters": {}})
    read = harness.metric_reader(name)
    assert read(_Rec(cfg, [plain, None]), roofline) is None


def test_masked_update_least_time_and_kernel_names():
    H, W, K, stride = 10, 4, 3, 3
    rows = [[3, 16], [2, 5]]
    assert rp.visited_px(H, W, stride, 2) == W * (4 + 3)
    moved = 5 * 28 + 12 * 21 + 24 * K * 2
    assert rp.masked_update(H, W, K, stride, rows) == pytest.approx(
        moved / roofline.HBM_BYTES_PER_S)
    assert rp.is_masked_update("void (anonymous namespace)::"
                               "slic_update_kernel<true, true>(int const*)")
    assert not rp.is_masked_update("void (anonymous namespace)::"
                                   "slic_update_kernel<false, true>(int)")
    assert not rp.is_masked_update("void assign_kernel<2, 4, true>(int)")
