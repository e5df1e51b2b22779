#!/usr/bin/env python3
"""Device time a launch of the CCA lookup, the orphan chase and the f32
segment sum (with whatever groups its pixels), at B=1 on a CUDA GPU.

    python3 scripts/kernel_profile.py [--root DIR]

Runs one steady `SlicAvx2(num_components=1600)` frame and one steady
`LSCAvx2(num_components=1600)` frame at 1280x720 (the frames of
chip_smoke.py) under torch.profiler and prints, for each, the frame's device
launches and busy share and every device kernel whose name names one of
those calls (the CCA lookup and chase, the f32 segment sum and its sort,
scan and search launches), with its launches and device microseconds a
launch.  Only the public API is used, so ``--root`` may name another
checkout of the port (default: the one holding this script) and two
versions can be profiled in one run on one card.  Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

# substrings of the device kernels reported (kernel names as the profiler
# gives them)
WATCH = ("lookup_kernel", "resolve_orphans_kernel", "fsegsum_kernel",
         "fs_rank", "fs_scan", "fs_scatter", "fs_sum", "RadixSort",
         "radixSort", "searchsorted")


def profile_frame(slic, warm, frame):
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
    from chip_smoke import H720, K720, W720, make_frames
    sys.path.insert(0, os.path.abspath(args.root))
    sys.modules.pop("fast_slic_tpu_torch", None)
    from fast_slic_tpu_torch import LSCAvx2, SlicAvx2

    frames = make_frames(2, H720, W720)
    out = {"root": os.path.abspath(args.root),
           "device": torch.cuda.get_device_name(0)}
    for name, cls in (("SlicAvx2", SlicAvx2), ("LSCAvx2", LSCAvx2)):
        slic = cls(num_components=K720, device="cuda")
        out[name] = profile_frame(slic, frames[0], frames[1])
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
