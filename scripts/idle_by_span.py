#!/usr/bin/env python3
"""The device's idle time in one benchmark cell's traced slice, split by
the innermost ``fstt.`` span of the port open at each idle microsecond
(``bench_port/spans.py``), with the share outside every span.

    python3 scripts/idle_by_span.py --workload slic720.stream \\
        --seed 7 [--seconds 51] [--out FILE]

Runs the cell once with ``--trace 1`` through the benchmark's harness
(``bench_port/harness.py``) on the card, keeps its profiled slice, and
prints one JSON line: the result's per-layer metrics and breakdown, the
slice's wall and idle ms a frame, and idle ms a frame by innermost span
(``"(none)"``: outside every span) and by the chain of open spans.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import time

T0 = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "bench_port"))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import devtrace
    import harness
    import spans

    kept = {}
    profile = devtrace.profile

    def keep_slice(*a, **kw):
        kept["slice"] = profile(*a, **kw)
        return kept["slice"]

    devtrace.profile = keep_slice
    result, checks, _ = harness.run_cell(
        args.workload, args.seed, args.seconds, True, "cuda", T0,
        log=lambda msg: print(msg, file=sys.stderr, flush=True))
    sl = kept["slice"]
    per_frame = 1e-3 / sl.frames
    by_chain = spans.idle_by_chain(sl) or {}
    inner = collections.Counter()
    for chain, us in by_chain.items():
        inner[chain[-1] if chain else "(none)"] += us * per_frame
    busy_ms = sum(e - s for s, e in sl.busy_intervals()) * per_frame
    out = {"workload": args.workload, "seed": args.seed,
           "correct": result["correct"], "device": result["device"],
           "metrics": {k: v["value"] for k, v in result["metrics"].items()},
           "slice_wall_ms_a_frame": 1e3 * sl.wall_s / sl.frames,
           "busy_ms_a_frame": busy_ms,
           "idle_in_events_ms_a_frame": sum(by_chain.values()) * per_frame,
           "idle_by_innermost_ms": dict(inner.most_common()),
           "idle_by_chain_ms": {" > ".join(c) or "(none)": us * per_frame
                                for c, us in sorted(
                                    by_chain.items(), key=lambda x: -x[1])},
           "breakdown": result.get("breakdown")}
    line = json.dumps(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0 if result["correct"] else 1


if __name__ == "__main__":
    sys.exit(main())
