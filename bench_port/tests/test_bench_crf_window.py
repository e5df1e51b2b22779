"""The CRF window cell's own checks: its unaries follow the clip frame,
and a traced run on the CPU reads the CRF's per-layer metrics from the
reports its entry gives."""

import json

import numpy as np

import harness
from conftest import driver_of, tiny

CELL = "crf720.window"
SEED = 2 ** 31 + 101


def test_crf_window_unaries_follow_the_clip_frame():
    """A frame of the CRF cell's clip carries the same unaries each time
    the clip shows it, and two frames or two seeds carry different ones."""
    cfg = {"height": 24, "width": 32, "num_classes": 5,
           "num_components": 6}
    traffic = {"loop": "crf_window", "streams": 1, "clip_frames": 4,
               "pan_px": 8, "noise_sigma": 2.0}
    Loop = harness.driver(traffic["loop"]).Loop
    big = 2 ** 31 + 13
    a, b, c = (Loop(cfg, traffic, s, "cpu", None) for s in (big, big, 5))
    ids = [a.images(t)[1][0] for t in range(8)]
    assert ids == [0, 1, 2, 3, 2, 1, 0, 1]
    for t, u in ((0, 6), (1, 5), (2, 4), (1, 7)):
        np.testing.assert_array_equal(a.proba(t), a.proba(u))
    assert (a.proba(0) != a.proba(1)).any()
    np.testing.assert_array_equal(a.proba(3), b.proba(3))
    assert (a.proba(3) != c.proba(3)).any()
    assert a.proba(0).shape == (5, 6) and a.proba(0).dtype == np.float32


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


def test_crf_window_traced_run_reads_the_crf_metrics():
    """The CRF cell's traced run on the CPU: the metrics read from the
    reports are there (the copies 0: nothing crosses to a device), those
    read from a device trace are left out.  Each report holds SLIC's
    sections and the CRF's cycle with its counters and its report."""
    result, _, _ = _traced_tiny_run()
    assert result["correct"] is True
    assert set(result["metrics"]) == {"crf.inference_ms",
                                      "crf.copy_mb_per_frame",
                                      "crf.meanfield_roofline_pct"}
    assert result["metrics"]["crf.copy_mb_per_frame"]["value"] == 0
    drv, cfg = driver_of(CELL)
    cfg.update(tiny(CELL)["config"])
    entry = drv.entry(cfg, {}, "cpu")
    image = np.random.default_rng(3).integers(
        0, 256, (1, cfg["height"], cfg["width"], 3), dtype=np.uint8)
    proba = np.full((cfg["num_classes"], cfg["num_components"]),
                    1 / cfg["num_classes"], np.float32)
    entry.call(image, proba)
    rep = json.loads(entry.report())
    slic, cycle = rep["children"]
    assert slic["name"] == json.loads(entry.slic.report())["name"]
    assert cycle["name"] == "crf_cycle"
    assert cycle["counters"] == {"host_syncs": 0, "h2d_bytes": 0,
                                 "d2h_bytes": 0}
    assert [c["name"] for c in cycle["children"]] == ["crf_inference"]
