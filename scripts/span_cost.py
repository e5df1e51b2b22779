#!/usr/bin/env python3
"""Host cost of the port's tracing (``fast_slic_tpu_torch/utils/timing.py``):
one ``span`` entered and left, one call through a ``spanned`` function, one
``Timer(None).scope``, and a counted ``to_host`` read of a flag beside the
plain read; each with no profiler running and inside a
``torch.profiler.profile`` with CPU and (where there is a card) CUDA
activity, minus the same loop with nothing in it.

    python3 scripts/span_cost.py [--reps 200000]

Prints one JSON line of microseconds a span (or read), with the device's
name.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def per_call_us(fn, reps: int) -> float:
    """Host µs a call of ``fn``, less an empty loop's."""
    def loop(f):
        t0 = time.perf_counter()
        for _ in range(reps):
            f()
        return time.perf_counter() - t0

    fn()
    return (loop(fn) - loop(lambda: None)) * 1e6 / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=200000)
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    from fast_slic_tpu_torch.utils import timing

    cuda = torch.cuda.is_available()
    flag = torch.zeros((), dtype=torch.bool,
                       device="cuda" if cuda else "cpu")
    timer = timing.Timer(None)

    def span():
        with timing.span("cost"):
            pass

    spanned = timing.spanned("cost")(lambda: None)

    def scope():
        with timer.scope("cost"):
            pass

    parts = {"span": (span, args.reps), "spanned": (spanned, args.reps),
             "timer_scope": (scope, args.reps),
             # blocking reads: far fewer
             "to_host_bool": (lambda: timing.to_host(flag, bool), 2000),
             "bool": (lambda: bool(flag), 2000)}
    out = {"device": torch.cuda.get_device_name(0) if cuda else "cpu"}
    for name, (fn, reps) in parts.items():
        out[name + "_off_us"] = per_call_us(fn, reps)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts):
        for name, (fn, reps) in parts.items():
            # the profiler stores every span: a tenth of the calls
            out[name + "_on_us"] = per_call_us(fn, max(reps // 10, 100))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
