#!/usr/bin/env python3
"""Device time a launch of the SLIC update sums (plain and masked), the CCA
lookup, the orphan chase and the f32 segment sum (with whatever groups its
pixels), at B=1 and in a stacked batch of four frames, on a CUDA GPU.

    python3 scripts/kernel_profile.py [--root DIR]

Runs one steady frame each of `SlicAvx2(num_components=1600)`,
`SlicAvx2(num_components=1600, preemptive=True)` (the masked update) and
`LSCAvx2(num_components=1600)` at 1280x720 (the frames of chip_smoke.py),
and one steady batch of `BatchedSlic(num_components=1600,
batch_mode="stack")` on four such frames, also with `preemptive=True`,
under torch.profiler, and prints,
for each, the run's device launches and busy share and every device kernel
whose name names one of those calls (the update kernels, the LAB
conversion, LSC's colour features, the CCA lookup and chase, the f32
segment sum and its sort, scan and search launches), with
its launches and device microseconds a launch.  Only the public API is
used, so ``--root`` may name another checkout of the port (default: the
one holding this script) and two versions can be profiled in one run on
one card.  Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

# substrings of the device kernels reported (kernel names as the profiler
# gives them)
WATCH = ("slic_update_kernel", "lab_kernel", "lsc_feat_kernel",
         "lookup_kernel", "resolve_orphans_kernel", "fsegsum_kernel",
         "fs_rank", "fs_scan", "fs_scatter", "fs_sum", "RadixSort",
         "radixSort", "searchsorted")


def profile_frame(slic, warm, frame):
    """torch.profiler over ``slic.iterate(frame)`` after
    ``slic.iterate(warm)`` (a frame, or a batch of frames)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    slic.iterate(warm)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        slic.iterate(frame)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy, launches, rows = 0.0, 0, {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", 0)
        if us <= 0:
            continue
        busy += us
        launches += e.count
        if any(w in e.key for w in WATCH):
            rows[e.key[:100]] = {"launches": e.count,
                                 "us_per_launch": us / e.count}
    return {"wall_us": wall_us, "busy_us": busy, "launches": launches,
            "kernels": rows}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("kernel_profile: needs a CUDA GPU", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, here)
    from chip_smoke import BATCH, H720, K720, W720, make_frames
    sys.path.insert(0, os.path.abspath(args.root))
    sys.modules.pop("fast_slic_tpu_torch", None)
    from fast_slic_tpu_torch import LSCAvx2, SlicAvx2
    from fast_slic_tpu_torch.parallel.batch import BatchedSlic

    frames = make_frames(2, H720, W720)
    more = make_frames(2 * BATCH, H720, W720, seed=1)
    out = {"root": os.path.abspath(args.root),
           "device": torch.cuda.get_device_name(0)}
    for name, cls, kw in (("SlicAvx2", SlicAvx2, {}),
                          ("SlicAvx2 preemptive", SlicAvx2,
                           {"preemptive": True}),
                          ("LSCAvx2", LSCAvx2, {})):
        slic = cls(num_components=K720, device="cuda", **kw)
        out[name] = profile_frame(slic, frames[0], frames[1])
    for name, kw in (("", {}), (" preemptive", {"preemptive": True})):
        bs = BatchedSlic(num_components=K720, batch_mode="stack",
                         device="cuda", **kw)
        out["BatchedSlic stack B=%d%s" % (BATCH, name)] = profile_frame(
            bs, np.stack(more[:BATCH]), np.stack(more[BATCH:]))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
