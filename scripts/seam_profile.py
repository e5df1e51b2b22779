#!/usr/bin/env python3
"""Device time of the sharded CCA's halo propagation on a CUDA GPU: one
3840x2160 frame of ``ShardedSlicExplicit(num_components=14400)`` over four
shards of the card (``make_mesh(data=1, space=4, devices=[cuda:0] * 4)``,
the mesh phase of chip_smoke.py).

    python3 scripts/seam_profile.py [--root DIR]

Prints one JSON line with
* ``propagations``: each of the frame's two halo propagations (the pixel
  ids, the leader ranks) replayed alone on its own inputs under
  torch.profiler, after one warm-up replay: its seam rounds, wall µs,
  device busy µs, device launches and every device kernel with its
  launches and µs a launch;
* ``frame``: one steady sharded frame under torch.profiler (wall, busy,
  launches, and the CCA's kernels);
* ``alone``: 20 calls of the region-minimum kernels alone (propagate_min,
  and where the checkout has them region_table and seam_min) on the
  frame's slab 1 with its leader-rank seed, and of propagate_min on a
  1280x720 raw assignment (chip_smoke.py's first frame, K=1600): device
  µs a launch of each device kernel;
* ``ms``: CUDA-event ms of three frames each, sharded and on one device
  (``SlicAvx2(14400)``), in turns, each carrying its state.

``--root`` names another checkout of the port (default: the one holding
this script), so two versions are measured in turns in one call.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def profiled(run):
    """torch.profiler over ``run()``: wall µs, device busy µs, device
    launches and each device kernel's launches and µs a launch."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
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
        rows[e.key[:100]] = {"launches": e.count,
                             "us_per_launch": us / e.count}
    return {"wall_us": wall_us, "busy_us": busy, "launches": launches,
            "kernels": rows}


def event_ms(fn) -> float:
    import torch
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("seam_profile: needs a CUDA GPU", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, here)
    from chip_smoke import H4K, H720, K4K, K720, W4K, W720, make_frames
    sys.path.insert(0, os.path.abspath(args.root))
    sys.modules.pop("fast_slic_tpu_torch", None)
    from fast_slic_tpu_torch import SlicAvx2, cluster, pipeline
    from fast_slic_tpu_torch.config import StaticConfig
    from fast_slic_tpu_torch.kernels import cca
    from fast_slic_tpu_torch.parallel import spatial_shardmap as ssm
    from fast_slic_tpu_torch.parallel.mesh import make_mesh

    dev = torch.device("cuda")
    mesh = make_mesh(data=1, space=4, devices=[dev] * 4)
    frames = make_frames(4, H4K, W4K)
    out = {"root": os.path.abspath(args.root),
           "device": torch.cuda.get_device_name(0)}

    # the frame's two propagations, their inputs kept as they came in
    captured = []
    real = ssm._halo_propagate

    def capture(mesh_, labs, tables, roots, rounds):
        captured.append(([x.clone() for x in labs],
                         [x.clone() for x in tables], roots))
        return real(mesh_, labs, tables, roots, rounds)

    sharded = ssm.ShardedSlicExplicit(num_components=K4K, mesh=mesh)
    ssm._halo_propagate = capture
    try:
        sharded.iterate(frames[0])
    finally:
        ssm._halo_propagate = real
    out["seam_rounds"] = list(sharded.last_seam_rounds)
    out["propagations"] = []
    for labs, tables, roots in captured[-2:]:
        rounds = []
        real(mesh, labs, [t.clone() for t in tables], roots, rounds)
        fresh = [t.clone() for t in tables]
        prof = profiled(lambda: real(mesh, labs, fresh, roots, rounds))
        prof["rounds"] = rounds[-1]
        out["propagations"].append(prof)
    out["propagation_busy_us"] = sum(p["busy_us"]
                                     for p in out["propagations"])
    out["propagation_launches"] = sum(p["launches"]
                                      for p in out["propagations"])

    prof = profiled(lambda: sharded.iterate(frames[1]))
    prof["kernels"] = {k: v for k, v in prof["kernels"].items()
                       if any(w in k for w in (
                           "cc_", "pm_", "rt_", "seam_min", "lookup",
                           "Memcpy", "Memset"))}
    out["frame"] = prof

    # the kernels alone: slab 1 and its leader-rank seed, and 720p
    _, tables, roots = captured[-1]
    Hl, W = roots[1].shape
    m0 = tables[1].reshape(Hl, W).contiguous()
    calls = {"propagate_min 4K slab": lambda: cca.propagate_min(m0, roots[1])}
    if hasattr(cca, "region_table"):
        calls["region_table 4K slab"] = (
            lambda: cca.region_table(m0, roots[1]))
        labs = captured[-1][0]
        table = cca.region_table(m0, roots[1])
        changed = torch.zeros((), dtype=torch.int32, device=dev)
        vals = cca.lookup(roots[0][-1:].contiguous(),
                          cca.region_table(tables[0].reshape(Hl, W),
                                           roots[0]))
        calls["seam_min 4K seam"] = lambda: cca.seam_min(
            table, roots[1][0], labs[1][0], labs[0][-1], vals[0], changed, 1)
    f720 = make_frames(1, H720, W720)[0]
    cfg = StaticConfig(H=H720, W=W720, K=K720)
    scal = pipeline.derive_scalars(cfg, 10.0, 0.25)
    raw = pipeline.iterate_graph(
        torch.from_numpy(f720).cuda(),
        cluster.initialize_clusters(f720, K720).to_torch("cuda"), cfg, scal,
        10, 3).raw_assignment
    roots720 = cca.connected_components(raw)
    ids720 = torch.arange(raw.numel(), dtype=torch.int32,
                          device=dev).reshape(raw.shape)
    calls["propagate_min 720p"] = lambda: cca.propagate_min(ids720, roots720)
    if hasattr(cca, "region_table"):
        calls["region_table 720p"] = (
            lambda: cca.region_table(ids720, roots720))
    out["alone"] = {}
    for name, call in calls.items():
        def run(call=call):
            for _ in range(20):
                call()
        run()
        out["alone"][name] = profiled(run)["kernels"]

    single = SlicAvx2(num_components=K4K, device=dev)
    single.iterate(frames[0])
    out["ms"] = {"sharded": [], "single": []}
    for f in frames[1:]:
        out["ms"]["sharded"].append(event_ms(lambda: sharded.iterate(f)))
        out["ms"]["single"].append(event_ms(lambda: single.iterate(f)))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
