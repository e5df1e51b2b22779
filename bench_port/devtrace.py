"""A profiled slice of calls and what the metrics read from it.

``torch.profiler`` records the host's operator events and the device's
kernels, copies and memsets (CUPTI).  The slice's wall time is the host
clock around its calls and includes the profiler's own host cost, so the
idle share read here is higher than in an untraced run.
"""

from __future__ import annotations

import collections
import pathlib
import re
import time

import numpy as np
import torch

CSRC = (pathlib.Path(__file__).resolve().parent.parent
        / "fast_slic_tpu_torch" / "csrc")
_GLOBAL = re.compile(
    r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(")


def hand_kernels() -> frozenset:
    """Names of the program's hand-written kernels, read from its CUDA
    sources."""
    names = set()
    for src in sorted(CSRC.glob("*.cu")):
        names.update(_GLOBAL.findall(src.read_text()))
    return frozenset(names)


def kernel_id(name: str) -> str:
    """The function name in a demangled kernel name ("void
    ns::f<3>(int*)" -> "f")."""
    name = re.sub(r"^void\s+", "", name.replace("(anonymous namespace)::",
                                                 ""))
    return name.split("(")[0].split("<")[0].split("::")[-1].strip()


class Slice:
    """Events of one profiled slice: device intervals (name, start_us,
    end_us), host operator intervals, frames and wall seconds."""

    def __init__(self, device_events, host_events, frames: int,
                 wall_s: float):
        self.device_events = sorted(device_events, key=lambda e: e[1])
        self.host_events = host_events
        self.frames = frames
        self.wall_s = wall_s

    # -- reductions ------------------------------------------------------
    def busy_intervals(self):
        merged = []
        for _, s, e in self.device_events:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-6

    def device_time_by_name(self):
        acc = collections.Counter()
        for name, s, e in self.device_events:
            acc[name] += (e - s) * 1e-6
        return acc

    def hand_kernel_s(self, names) -> float:
        return sum(e - s for n, s, e in self.device_events
                   if kernel_id(n) in names) * 1e-6

    def idle_by_host_op(self):
        """Seconds of each idle gap between device intervals, by the
        innermost host operator running at the gap's middle ("python"
        where none runs)."""
        acc = collections.Counter()
        busy = np.asarray(self.busy_intervals(), dtype=np.float64)
        if len(busy) < 2:
            return acc
        gap_lo, gap_hi = busy[:-1, 1], busy[1:, 0]
        mids = 0.5 * (gap_lo + gap_hi)
        names = [h[0] for h in self.host_events]
        hs = np.array([h[1] for h in self.host_events], np.float64)
        he = np.array([h[2] for h in self.host_events], np.float64)
        for c in range(0, len(mids), 256):
            m = mids[c:c + 256, None]
            cover = (hs[None, :] <= m) & (he[None, :] >= m)
            length = np.where(cover, (he - hs)[None, :], np.inf)
            inner = length.argmin(1)
            for g, h in enumerate(inner):
                name = names[h] if np.isfinite(length[g, h]) else "python"
                acc[name] += (gap_hi[c + g] - gap_lo[c + g]) * 1e-6
        return acc

    def breakdown(self, top: int = 10):
        short = lambda n: n if len(n) <= 120 else n[:117] + "..."
        ops = self.device_time_by_name().most_common(top)
        gaps = self.idle_by_host_op().most_common(top)
        return {"device_ops": [[short(n), s] for n, s in ops],
                "idle_gaps": [[short(n), s] for n, s in gaps]}


def profile(fn, calls: int, frames_per_call: int) -> Slice:
    """Run ``fn(i)`` for i < calls under torch.profiler; the device is
    synchronised before and after."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize()
    with torch_profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(calls):
            fn(i)
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev, host = [], []
    cuda_type = torch.autograd.DeviceType.CUDA
    for e in prof.events():
        span = (e.name, e.time_range.start, e.time_range.end)
        if e.device_type == cuda_type:
            dev.append(span)
        elif not e.name.startswith(("ProfilerStep", "[memory]")):
            host.append(span)
    return Slice(dev, host, calls * frames_per_call, wall)
