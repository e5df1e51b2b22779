"""One run of one cell: set-up, the measured window, the traced slice,
the comparison with the plain reference, and the result line.

Everything particular to a cell is found by name: the workload in
``BENCHMARK.json``, its configuration file, ``traffic/<traffic>.json``,
``drivers/<loop>.py`` for the traffic's ``"loop"`` and
``metrics/<metric>.py`` for each per-layer metric that lists the cell.

A driver holds all that belongs to one kind of call:

- ``entry(cfg, traffic, device)``: the program's public call, an object
  with ``call(images)``, ``state()``, ``ties()``, ``report()`` and
  ``ties_free`` (whether reading ``ties()`` costs nothing, so that an
  untraced window counts them too);
- ``Loop(cfg, traffic, seed, device, make_entry)``: the inputs drawn from
  the seed and what a call is given (``images``, ``start``, ``call``,
  ``keeps``, ``keep``, ``follow``, ``frames_per_call``, ``entry``);
- ``compare(loop, kept, device)``: the numbers that the configuration's
  ``limits`` name, and ``frames_differ``, from the plain reference;
- ``control_entry(cfg, traffic, device)``: the weakened reference that
  ``control.py`` puts in the program's place;
- ``faults(cfg)`` and ``plant(fault)``: the faults that the limits must
  catch, and a function that plants one and returns its undo;
- ``TINY``: overrides that cut a cell to a size the CPU tests can run.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import pathlib
import statistics
import sys
import time

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "fast_slic_tpu")


@dataclasses.dataclass(frozen=True)
class Places:
    """Where the files of a cell are found by name."""

    spec: pathlib.Path      # BENCHMARK.json
    root: pathlib.Path      # what a configuration's "file" is relative to
    traffic: pathlib.Path   # <traffic>.json
    drivers: pathlib.Path   # <loop>.py
    metrics: pathlib.Path   # <metric>.py


def places() -> Places:
    """The checkout's own files (a test points the harness elsewhere by
    replacing this function)."""
    return Places(ROOT / "BENCHMARK.json", ROOT, HERE / "traffic",
                  HERE / "drivers", HERE / "metrics")


def load_spec() -> dict:
    return json.loads(places().spec.read_text())


def cell(spec: dict, workload: str):
    """(workload entry, configuration dict, traffic dict)."""
    for w in spec["workloads"]:
        if w["name"] == workload:
            break
    else:
        raise SystemExit("no workload %r in BENCHMARK.json" % workload)
    conf = next(c for c in spec["configs"] if c["name"] == w["config"])
    at = places()
    cfg = json.loads((at.root / conf["file"]).read_text())
    traffic = json.loads((at.traffic / (w["traffic"] + ".json")).read_text())
    return w, cfg, traffic


def _load(path: pathlib.Path, prefix: str):
    spec = importlib.util.spec_from_file_location(
        prefix + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(loop: str):
    """``drivers/<loop>.py``, the driver of a traffic's ``"loop"``."""
    return _load(places().drivers / (loop + ".py"), "bench_driver_")


def metric_reader(name: str):
    """``metrics/<name>.py``'s ``read``."""
    return _load(places().metrics / (name + ".py"), "bench_metric_").read


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def result_line(result: dict, checks: dict) -> str:
    """The result as one JSON line, the numbers compared last under
    ``checks``: {name: {"value", "limit"}}."""
    out = dict(result)
    out["checks"] = {name: {"value": v, "limit": lim}
                     for name, (v, lim) in checks.items()}
    return json.dumps(out)


class Records:
    """What the per-layer metrics read: the configuration, the timing
    reports of the window's calls, tie counts, and the profiled slice."""

    def __init__(self, cfg, traffic):
        self.cfg, self.traffic = cfg, traffic
        self.reports = []       # last_timing_report of each timed call
        self.frames = 0         # frames whose ties were counted
        self.tie_frames = 0
        self.slice = None       # devtrace.Slice
        self.hand_kernels = frozenset()


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t0: float = None, overrides=None,
             make_entry=None, log=print):
    """One run.  ``overrides`` ({"config": {...}, "traffic": {...}})
    shrink a cell for a CPU test; ``make_entry(cfg, traffic, device)``
    puts something else in the program's place (the controls; the
    driver's ``entry`` by default).  Returns (result dict, checks dict
    {name: [value, limit]}, every number the comparison gave)."""
    t0 = time.perf_counter() if t0 is None else t0
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import torch

    import devtrace
    import roofline

    spec = load_spec()
    w, cfg, traffic = cell(spec, workload)
    if overrides:
        cfg.update(overrides.get("config", {}))
        traffic.update(overrides.get("traffic", {}))
    cuda = torch.device(device).type == "cuda"
    drv = driver(traffic["loop"])
    if make_entry is None:
        make_entry = drv.entry

    # -- set-up: the kernels, the frames, a warm-up on the same traffic
    marks = {"imports": time.perf_counter() - t0}
    build_s = 0.0
    if cuda:
        torch.cuda.init()
        from fast_slic_tpu_torch.kernels import _lib
        k0 = time.perf_counter()
        build_s = _lib.build()      # 0 when the checkout has the library
        _lib.library()
        marks["kernels"] = time.perf_counter() - k0
    f0 = time.perf_counter()
    loop = drv.Loop(cfg, traffic, seed, device,
                    lambda: make_entry(cfg, traffic, device))
    marks["frames"] = time.perf_counter() - f0
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    w0 = time.perf_counter()
    loop.start()
    for t in range(traffic["warmup_calls"]):
        loop.call(t)
    if cuda:
        torch.cuda.synchronize()
    marks["warm-up"] = time.perf_counter() - w0
    setup_s = time.perf_counter() - t0
    log("set-up: %.6f s; %s; build_s %.6f (nvcc, only in a checkout's "
        "first run)" % (setup_s, ", ".join(
            "%s %.6f" % kv for kv in marks.items()), build_s))

    # -- the measured window: a closed loop from a fresh program
    rec = Records(cfg, traffic)
    rng = np.random.default_rng([int(seed), 3])
    kept = {}
    lat, ends = [], []
    keep_s = 0.0                # the comparison's bookkeeping in the window
    loop.start()
    t = 0
    cpu0 = time.process_time()
    start = time.perf_counter()
    while True:
        sampled = loop.keeps(t, rng)
        k0 = time.perf_counter()
        before = (loop.entry.state() if sampled and loop.follow and t
                  else None)
        c0 = time.perf_counter()
        entry, out = loop.call(t)
        c1 = time.perf_counter()
        lat.append(c1 - c0)
        ends.append(c1 - start)
        if sampled:
            kept[t] = loop.keep(entry, out, before)
        keep_s += (c0 - k0) + (time.perf_counter() - c1)
        if trace or entry.ties_free:
            rec.tie_frames += entry.ties()
            rec.frames += loop.frames_per_call
        if trace:
            rec.reports.append(entry.report())
        t += 1
        if c1 - start >= seconds:
            break
    window_s = time.perf_counter() - start
    cpu_s = time.process_time() - cpu0
    calls = t
    if calls - 1 not in kept and not loop.follow:
        kept[calls - 1] = loop.keep(entry, out)
    frames = calls * loop.frames_per_call
    q = statistics.quantiles(lat, n=4) if len(lat) > 1 else lat * 3
    half = sum(e < window_s / 2 for e in ends)
    log("window: %d calls, %d frames in %.6f s; latency median %.6f ms, "
        "p95 %.6f ms, quartiles %.6f and %.6f ms, max %.6f ms; calls in the "
        "first and second half %d and %d; tied frames %s"
        % (calls, frames, window_s, 1e3 * statistics.median(lat),
           1e3 * float(np.percentile(lat, 95)), 1e3 * q[0], 1e3 * q[2],
           1e3 * max(lat), half, calls - half,
           rec.tie_frames if rec.frames else "not counted"))
    log("host in the window: %.6f s of CPU; %d calls kept for the "
        "comparison, their bookkeeping %.6f s" % (cpu_s, len(kept), keep_s))

    # -- the traced slice: more calls of the same program, profiled
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": torch.cuda.device_count() if cuda else 0}
    breakdown = None
    if trace:
        # the slice follows the window on the same program and is
        # profiled, not compared
        rec.hand_kernels = devtrace.hand_kernels()
        rec.slice = devtrace.profile(lambda i: loop.call(calls + i),
                                     traffic["trace_calls"],
                                     loop.frames_per_call)
        device_info["busy_s"] = rec.slice.busy_s()
        device_info["window_s"] = rec.slice.wall_s
        breakdown = rec.slice.breakdown()
    if cuda:
        torch.cuda.synchronize()
        device_info["memory_peak_bytes"] = torch.cuda.max_memory_allocated()
    else:
        device_info["memory_peak_bytes"] = 0

    # -- the comparison, after the program's state is freed
    loop.entry = entry = out = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    r0 = time.perf_counter()
    numbers = drv.compare(loop, kept, device)
    log("reference: %d of %d calls compared, %.3f s; %s"
        % (len(kept), calls, time.perf_counter() - r0, json.dumps(numbers)))
    checks = {name: [numbers[name], limit]
              for name, limit in cfg["limits"].items()}
    correct = all(v <= lim for v, lim in checks.values())

    # -- metrics
    if trace:
        metrics = {}
        for m in spec["per_layer"]:
            if workload not in m.get("workloads", [workload]):
                continue
            value = metric_reader(m["name"])(rec, roofline)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {
            "frames_per_s": {"value": frames / window_s, "unit": "frames/s"},
            "latency_ms_p95": {"value": 1e3 * float(np.percentile(lat, 95)),
                               "unit": "ms"},
            "setup_s": {"value": setup_s, "unit": "s"},
        }
    result = {"correct": correct, "attempted": frames,
              "failed": 0 if correct else numbers["frames_differ"],
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    return result, checks, numbers
