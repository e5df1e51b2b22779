#!/usr/bin/env python3
"""Device time a launch of the candidate build and the assign kernel at 16
and at 48 candidate slots on a carried 720p frame, on a CUDA GPU.

    python3 scripts/slots_profile.py [--reps N]

``SlicAvx2(num_components=1600)`` is carried over the first three of
chip_smoke.py's frames; from its state, ``pipeline.iterate_graph`` runs the
fourth frame ``reps`` times at each slot count under torch.profiler
(:func:`kernel_profile.profiled`: device launches, busy µs, every
candidate and assign kernel with its launches and device µs a launch),
with its overflow flag and the host ms of a run (synchronised; the two
counts timed in turns, 16 48 48 16).  A carried
call starts at the slots of the run it kept (``SlicModel``), where it
started at 16 and re-ran at 48 on overflow.  Prints one JSON line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("slots_profile: needs a CUDA GPU", file=sys.stderr)
        return 1
    sys.path[:0] = [ROOT, os.path.join(ROOT, "scripts")]
    from chip_smoke import H720, K720, W720, make_frames
    from kernel_profile import profiled
    from fast_slic_tpu_torch import SlicAvx2, pipeline

    frames = make_frames(4, H720, W720)
    slic = SlicAvx2(num_components=K720, device="cuda")
    for f in frames[:3]:
        slic.iterate(f)
    model = slic.slic_model
    cfg = model._static_config(H720, W720)
    scal = pipeline.derive_scalars(cfg, slic.compactness,
                                   slic.min_size_factor)
    image = torch.from_numpy(frames[3]).cuda()
    out = {"device": torch.cuda.get_device_name(0),
           "carried_slots": model.last_cand_slots}
    runs = {}
    for slots in (16, 48):
        c = dataclasses.replace(cfg, cand_slots=slots)
        runs[slots] = lambda c=c: pipeline.iterate_graph(
            image, model._clusters.to_torch("cuda"), c, scal, 10,
            slic.subsample_stride)
        out["%d slots" % slots] = {
            "overflow": bool(runs[slots]().cand_overflow),  # warm, the flag
            "reps": args.reps, "host_ms_a_run": []}
    for slots in (16, 48, 48, 16):   # in turns: the host's pace drifts
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.reps):
            runs[slots]()
        torch.cuda.synchronize()
        out["%d slots" % slots]["host_ms_a_run"].append(
            (time.perf_counter() - t0) * 1e3 / args.reps)
    for slots in (16, 48):
        out["%d slots" % slots].update(profiled(
            lambda: [runs[slots]() for _ in range(args.reps)],
            watch=("candidates_kernel", "assign_kernel")))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
