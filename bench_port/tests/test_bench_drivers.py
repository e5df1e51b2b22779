"""A deployment added as new files only: a toy program (a 3x3 box blur of
each frame), its configuration, traffic, driver and per-layer reader are
written to a directory of their own, and the harness is pointed there by
replacing ``harness.places``.  The harness runs the cell, judges it
correct, and fails its control and its planted fault, with no file of the
harness edited."""

import json
import textwrap

import pytest

import harness
from test_bench_spec import DRIVER

SEED = 2 ** 31 + 7

# the program under test: float32 on whatever device it is given
PROGRAM = '''
import torch


def blur(x):
    """uint8 [B, H, W, 3] -> float32 3x3 box means, edges averaged over
    the pixels inside the frame."""
    x = torch.as_tensor(x).permute(0, 3, 1, 2).float()
    y = torch.nn.functional.avg_pool2d(x, 3, stride=1, padding=1,
                                       count_include_pad=False)
    return y.permute(0, 2, 3, 1)
'''

# its plain reference: float64 numpy, nothing of the program
REFERENCE = '''
import numpy as np


def blur(x, dtype=np.float64):
    x = np.asarray(x).astype(dtype)
    B, H, W, C = x.shape
    pad = np.zeros((B, H + 2, W + 2, C), dtype)
    ones = np.zeros((1, H + 2, W + 2, 1), dtype)
    pad[:, 1:-1, 1:-1] = x
    ones[:, 1:-1, 1:-1] = 1
    win = lambda a: sum(a[:, i:i + H, j:j + W] for i in range(3)
                        for j in range(3))
    return win(pad) / win(ones)
'''

DRIVER_SRC = '''
"""``blur``: one frame a call through the toy program's box blur."""

import numpy as np
import torch

import toy_blur
import toy_blur_ref

TINY = {"config": {}, "traffic": {}}


class Entry:
    ties_free = True

    def __init__(self, device, fn):
        self.device, self.fn = device, fn

    def call(self, images):
        return self.fn(images)

    def state(self):
        return None

    def ties(self):
        return 0

    def report(self):
        return None


def entry(cfg, traffic, device):
    return Entry(device, lambda x: toy_blur.blur(
        torch.from_numpy(x).to(device)).cpu().numpy())


def control_entry(cfg, traffic, device):
    """The reference in float16, the precision below the float32 the
    configuration states."""
    return Entry(device, lambda x: toy_blur_ref.blur(x, np.float16))


def faults(cfg):
    return ("answer altered",)


def plant(fault):
    real = toy_blur.blur

    def blur(x):
        y = real(x)
        y[0, 0, 0, 0] += 1
        return y

    toy_blur.blur = blur
    return lambda: setattr(toy_blur, "blur", real)


class Loop:
    frames_per_call = 1
    follow = False

    def __init__(self, cfg, traffic, seed, device, make_entry):
        self.cfg, self.traffic, self.make_entry = cfg, traffic, make_entry
        rng = np.random.default_rng([int(seed), 1])
        self.frames = rng.integers(
            0, 256, (traffic["frames"], cfg["height"], cfg["width"], 3),
            dtype=np.uint8)
        self.entry = None

    def images(self, t):
        i = t % len(self.frames)
        return self.frames[i:i + 1], (i,)

    def start(self):
        self.entry = self.make_entry()

    def call(self, t):
        return self.entry, self.entry.call(self.images(t)[0])

    def keeps(self, t, rng):
        return t == 0 or rng.random() < self.traffic["compare_share"]

    def keep(self, entry, out, before=None):
        return np.asarray(out, np.float64)


def compare(loop, kept, device):
    limit = loop.cfg["limits"]["blur_differ_max"]
    out = {"blur_differ_max": 0.0, "frames_differ": 0}
    for t, got in kept.items():
        gap = float(np.abs(got - toy_blur_ref.blur(loop.images(t)[0])).max())
        out["blur_differ_max"] = max(out["blur_differ_max"], gap)
        out["frames_differ"] += gap > limit
    return out
'''

READER = '''
def read(rec, roofline):
    return rec.slice.frames if rec.slice is not None else None
'''

SPEC = {
    "command": ["python3", "bench_port/run.py"],
    "paths": ["bench_port"],
    "run_seconds": 10,
    "configs": [{"name": "blur_toy", "source": "https://example.org/blur",
                 "file": "configs/blur_toy.json", "reduced": [],
                 "why": "a toy"}],
    "workloads": [{"name": "blur.frames", "config": "blur_toy",
                   "traffic": "frames", "chips": 1, "why": "a toy"}],
    "end_to_end": [{"name": "setup_s", "unit": "s", "better": "lower",
                    "bound": 0.25, "source": "host_clock"}],
    "per_layer": [{"name": "blur.frames_traced", "unit": "frames",
                   "better": "higher", "source": "device_trace",
                   "layer": "blur", "moves": "setup_s",
                   "workloads": ["blur.frames"]}],
}
CONFIG = {"height": 12, "width": 16,
          # float32 rounding of a mean of nine values up to 255 is ~3e-5;
          # float16 is off by up to 0.06
          "limits": {"blur_differ_max": 1e-3}}
TRAFFIC = {"loop": "blur", "frames": 5, "compare_share": 0.5,
           "warmup_calls": 1, "trace_calls": 2}


@pytest.fixture
def toy(tmp_path, monkeypatch):
    """The toy deployment's files, each new, and the harness pointed at
    them."""
    files = {"BENCHMARK.json": json.dumps(SPEC),
             "configs/blur_toy.json": json.dumps(CONFIG),
             "traffic/frames.json": json.dumps(TRAFFIC),
             "drivers/blur.py": DRIVER_SRC,
             "metrics/blur.frames_traced.py": READER,
             "program/toy_blur.py": PROGRAM,
             "reference/toy_blur_ref.py": REFERENCE}
    for name, text in files.items():
        (tmp_path / name).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / name).write_text(textwrap.dedent(text))
    monkeypatch.syspath_prepend(str(tmp_path / "program"))
    monkeypatch.syspath_prepend(str(tmp_path / "reference"))
    places = harness.Places(tmp_path / "BENCHMARK.json", tmp_path,
                            tmp_path / "traffic", tmp_path / "drivers",
                            tmp_path / "metrics")
    monkeypatch.setattr(harness, "places", lambda: places)
    return harness.driver("blur")


def run(trace=False, make_entry=None):
    return harness.run_cell("blur.frames", SEED, 0.3, trace, "cpu",
                            make_entry=make_entry, log=lambda msg: None)


def test_the_toy_driver_provides_what_a_driver_must(toy):
    assert all(hasattr(toy, name) for name in DRIVER)


def test_a_new_deployment_runs_and_is_correct(toy):
    result, checks, numbers = run()
    assert result["correct"] is True and result["failed"] == 0, checks
    assert set(checks) == {"blur_differ_max"}
    assert 0 < numbers["blur_differ_max"] < 1e-3
    assert result["attempted"] > 0
    line = json.loads(harness.result_line(result, checks))
    assert list(line)[-1] == "checks"


def test_its_traced_run_reads_its_own_metric(toy):
    result, _, _ = run(trace=True)
    assert result["correct"] is True
    assert result["metrics"] == {"blur.frames_traced": {
        "value": TRAFFIC["trace_calls"], "unit": "frames"}}


def test_its_control_comes_out_not_correct(toy):
    result, checks, _ = run(make_entry=toy.control_entry)
    assert result["correct"] is False, checks
    assert result["failed"] > 0


@pytest.mark.parametrize("fault", ["answer altered"])
def test_its_fault_comes_out_not_correct(toy, fault):
    assert fault in toy.faults(CONFIG)
    undo = toy.plant(fault)
    try:
        result, checks, _ = run()
    finally:
        undo()
    assert result["correct"] is False, checks
