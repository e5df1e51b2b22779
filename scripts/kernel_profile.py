#!/usr/bin/env python3
"""Device time a launch of the assign kernels (quantized and float), the
SLIC update sums (plain and masked), the CCA's components, segment sum,
lookup and selection (``cca_select_kernel``; an older checkout's orphan
chase) and the f32 segment sum (with whatever groups its
pixels), at B=1 and in a stacked batch of four frames, on a CUDA GPU.

    python3 scripts/kernel_profile.py [--root DIR]

Runs one steady frame each of `SlicAvx2(num_components=1600)`,
`SlicAvx2(num_components=1600, preemptive=True)` (the masked update),
`LSCAvx2(num_components=1600)` and `SlicRealDist(num_components=1600)` at
1280x720 (the frames of chip_smoke.py), and one steady batch of
`BatchedSlic(num_components=1600, batch_mode="stack")` on four such
frames, also with `preemptive=True` and with `variant="real_noq"`, under
torch.profiler, and prints, for each, the run's device launches and busy
share and every device kernel whose name names one of those calls (the
assign kernels, the update kernels, the LAB conversion, LSC's colour
features, the CCA's components kernels, segment sum, lookup and chase, the
f32 segment sum and its sort, scan and search launches), with its launches
and device microseconds a launch.  Then the same for 20 calls of a kernel
alone: the assign kernel on a mid-loop state (setup and three loop
iterations) of the first frame, at stride 3 and at stride 1; the float
assign of each variant (real, real_l2, real_noq, lsc) on that variant's
mid-loop state of the first frame and of the four frames stacked (B=4),
at stride 3 and at stride 1; and the CCA's segment sum on the component
ids and values of the first frame's raw assignment, and the per-frame
segment sum on the same ids as one frame (B=1) and on the four frames of
the stacked batch (B=4; every device launch listed: the output's zero
fill beside the kernel); the KNN on the clusters of the JAX package's
first 720p frame at m=4 (every launch listed: ``knn_buckets_kernel``
beside ``knn_kernel``, or, for a checkout from before them, the
bucketing's torch ops) and the bucketing alone; the candidate build
alone at B=1 and B=4 (every launch listed; with the candidate kernel, also
its plain version on the card); the CCA's selection with its orphan chase
alone (``ops.cca._substitutes``, every launch listed, and host µs a call
over 20 calls ended by one synchronize) on the tables of the first
frame, of the four frames stacked, of the first frame made at 1920x1080
and of two 720p tables with a component a pixel (nc = n: random areas
in [1, 60] and targets below each entry; every area 1 and each target
its left neighbour, one chain through the table); and one steady
``initialize(); inference(5)`` cycle of ``SimpleCRF(21, 1600)`` over four
frames with their adjacency graphs (every launch listed).  The frames go
through the public API and the kernel calls through the pipeline's stages, so
``--root`` may name another checkout of the port (default: the one holding
this script) and two versions can be profiled in one run on one card.
Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

# substrings of the device kernels reported (kernel names as the profiler
# gives them; "segment_sum_kernel" is both segment sums' kernel, and the
# name of framed_segment_sum's one-atomic-a-pixel kernel before it)
WATCH = ("slic_update_kernel", "lab_kernel", "lsc_feat_kernel",
         "lookup_kernel", "resolve_orphans_kernel", "cca_select_kernel",
         "fsegsum_kernel",
         "fs_rank", "fs_scan", "fs_scatter", "fs_sum", "RadixSort",
         "radixSort", "searchsorted", "assign_kernel", "cc_init",
         "cc_merge", "cc_local", "cc_seams", "cc_flatten",
         "assign_float_kernel", "segment_sum_kernel")
FLOAT_VARIANTS = ("real", "real_l2", "real_noq", "lsc")


def profiled(run, watch=WATCH):
    """torch.profiler over ``run()``: wall µs, device busy µs, device
    launches and, for each watched kernel (every kernel when ``watch`` is
    None), its launches and device µs a launch."""
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
        if watch is None or any(w in e.key for w in watch):
            rows[e.key[:100]] = {"launches": e.count,
                                 "us_per_launch": us / e.count}
    return {"wall_us": wall_us, "busy_us": busy, "launches": launches,
            "kernels": rows}


def profile_frame(slic, warm, frame):
    """:func:`profiled` over ``slic.iterate(frame)`` after
    ``slic.iterate(warm)`` (a frame, or a batch of frames)."""
    slic.iterate(warm)
    return profiled(lambda: slic.iterate(frame))


def profile_assign(frame, K, reps=20):
    """The assign kernel alone at the frame's shapes, on a mid-loop state
    (setup and three loop iterations): ``reps`` calls each at stride 3 and
    at stride 1."""
    import torch
    from fast_slic_tpu_torch import cluster as cl, pipeline
    from fast_slic_tpu_torch.config import StaticConfig
    from fast_slic_tpu_torch.kernels import assign
    H, W = frame.shape[:2]
    cfg = StaticConfig(H=H, W=W, K=K)
    scal = pipeline.derive_scalars(cfg, 10.0, 0.25)
    st = cl.initialize_clusters(frame, K).to_torch("cuda")
    planes, st, lsc = pipeline.stage_setup(torch.from_numpy(frame).cuda(),
                                           st, cfg, scal)
    st, a, _, _ = pipeline.stage_loop(planes, st, lsc, cfg, scal, 3, 3)
    st = pipeline._clamp_centers(st, cfg)
    cand, _ = pipeline.build_candidates(st.y, st.x, st.is_active, cfg)
    table = pipeline.center_table(st)
    out = {}
    for stride in (3, 1):
        def run(stride=stride):
            for _ in range(reps):
                assign.assign(planes, table, cand, a, scal.coef, cfg.S,
                              stride, 0, True)
        run()
        out["assign alone, stride %d" % stride] = profiled(run)
    return out


def float_state(frame, K, variant):
    """(planes, table, cand, assignment, feats, cent, coef, S) of the float
    assign on a mid-loop state of one frame (setup and three loop
    iterations); feats and cent are None but for lsc."""
    import torch
    from fast_slic_tpu_torch import cluster as cl, pipeline
    from fast_slic_tpu_torch.config import StaticConfig
    H, W = frame.shape[:2]
    cfg = StaticConfig(H=H, W=W, K=K, variant=variant)
    scal = pipeline.derive_scalars(cfg, 10.0, 0.25)
    st = cl.initialize_clusters(frame, K).to_torch("cuda")
    planes, st, (feats, weights, cent) = pipeline.stage_setup(
        torch.from_numpy(frame).cuda(), st, cfg, scal)
    st, a, cent, _ = pipeline.stage_loop(planes, st, (feats, weights, cent),
                                         cfg, scal, 3, 3)
    st = pipeline._clamp_centers(st, cfg)
    cand, _ = pipeline.build_candidates(st.y, st.x, st.is_active, cfg)
    return (planes, pipeline.center_table(st), cand, a, feats, cent,
            scal.coef, cfg.S)


def profile_assign_float(frames, K, reps=20):
    """The float assign alone, each variant: ``reps`` calls at stride 3 and
    at stride 1 on the first frame's mid-loop state (B=1) and on the four
    frames' states stacked along the frame axis (B=4)."""
    import torch
    from fast_slic_tpu_torch.kernels import assign_float
    out = {}
    for variant in FLOAT_VARIANTS:
        states = [float_state(f, K, variant) for f in frames]
        coef, S = states[0][6], states[0][7]
        for B in (1, len(frames)):
            if B == 1:
                planes, table, cand, a, feats, cent = states[0][:6]
            else:
                # frame axis: planes [3, B, H, W], feats [10, B, H, W],
                # every other argument a leading [B]
                dims = (1, 0, 0, 0, 1, 0)
                planes, table, cand, a, feats, cent = (
                    None if xs[0] is None else torch.stack(xs, d)
                    for xs, d in zip(zip(*(s[:6] for s in states)), dims))
            for stride in (3, 1):
                def run(stride=stride, args=(planes, table, cand, a),
                        lsc=(feats, cent)):
                    for _ in range(reps):
                        assign_float.assign_float(
                            *args, coef, S, stride, 0, variant, True, None,
                            *lsc)
                run()
                out["assign_float %s alone B=%d, stride %d"
                    % (variant, B, stride)] = profiled(run)
    return out


def cca_inputs(frames, K):
    """The per-frame segment sum's inputs on SlicAvx2's raw assignments of
    ``frames`` (720p, K=1600): ids [B, n] frame-local component ids and
    vals [2, B, n] (area ones, leader targets), as
    ``ops.cca.framed_cca_parts`` makes them."""
    import torch
    from fast_slic_tpu_torch import cluster as cl, pipeline
    from fast_slic_tpu_torch.config import StaticConfig
    from fast_slic_tpu_torch.ops.cca import framed_components, segsum_values
    H, W = frames[0].shape[:2]
    cfg = StaticConfig(H=H, W=W, K=K)
    scal = pipeline.derive_scalars(cfg, 10.0, 0.25)
    raw = torch.stack([pipeline.iterate_graph(
        torch.from_numpy(f).cuda(),
        cl.initialize_clusters(f, K).to_torch("cuda"), cfg, scal, 10,
        3).raw_assignment for f in frames])
    comp, is_leader = framed_components(raw, K)
    return (comp.reshape(len(frames), H * W),
            segsum_values(comp, is_leader).contiguous())


def profile_segment_sum(frame, batch, K, reps=20):
    """The CCA's segment sums alone, every device launch listed (the
    output's zero fill beside the kernel): ``reps`` calls of segment_sum
    on the component ids and values of ``frame``'s raw assignment, and of
    framed_segment_sum on the same as one frame (B=1) and on the four
    frames of ``batch`` (B=4, the stacked batch's call)."""
    from fast_slic_tpu_torch.kernels import segsum
    out = {}
    ids1, vals1 = cca_inputs([frame], K)
    n = ids1.shape[1]
    calls = {"segment_sum alone (CCA ids, V=2)":
             lambda: segsum.segment_sum(ids1[0], vals1[:, 0], n),
             "framed_segment_sum alone B=1 (CCA ids, V=2)":
             lambda: segsum.framed_segment_sum(ids1, vals1, n)}
    ids4, vals4 = cca_inputs(batch, K)
    calls["framed_segment_sum alone B=%d (CCA ids, V=2)" % len(batch)] = (
        lambda: segsum.framed_segment_sum(ids4, vals4, n))
    for name, call in calls.items():
        def run(call=call):
            for _ in range(reps):
                call()
        run()
        out[name] = profiled(run, None)
    return out


def profile_candidates(frames, K, reps=20):
    """The candidate build alone, ``reps`` builds through
    ``pipeline.build_candidates_batched`` (every device launch listed), on
    the mid-loop state (setup and three loop iterations) of the first frame
    (B=1) and of the frames stacked (B=4); for a checkout with the
    candidate kernel, also its plain version on the card (the sort build)
    and the kernel into a running flag."""
    import torch
    from fast_slic_tpu_torch import cluster as cl, pipeline
    from fast_slic_tpu_torch.config import StaticConfig
    H, W = frames[0].shape[:2]
    cfg = StaticConfig(H=H, W=W, K=K)
    scal = pipeline.derive_scalars(cfg, 10.0, 0.25)
    try:
        from fast_slic_tpu_torch.kernels import candidates
    except ImportError:   # a checkout from before the kernel
        candidates = None
    out = {}
    for B in (1, len(frames)):
        sts = [cl.initialize_clusters(f, K) for f in frames[:B]]
        st = cl.Clusters(*(np.stack(xs) for xs in zip(
            *(s.fields() for s in sts)))).to_torch("cuda")
        images = torch.from_numpy(np.stack(frames[:B])).cuda()
        planes, st, lsc = pipeline.stage_setup(images, st, cfg, scal)
        st, _, _, _ = pipeline.stage_loop(planes, st, lsc, cfg, scal, 3, 3)
        st = pipeline._clamp_centers(st, cfg)
        GH, GW = pipeline.cell_grid_shape(cfg)
        flag = torch.zeros((), dtype=torch.bool, device="cuda")
        calls = {"build": lambda: pipeline.build_candidates_batched(
            st.y, st.x, st.is_active, cfg)}
        if candidates is not None:
            calls["plain (torch ops)"] = lambda: candidates.plain(
                st.y, st.x, st.is_active, cfg.S, GH, GW, cfg.cand_slots)
            calls["kernel, running flag"] = lambda: candidates.candidates(
                st.y, st.x, st.is_active, cfg.S, GH, GW, cfg.cand_slots,
                overflow=flag)
        for name, call in calls.items():
            def run(call=call):
                for _ in range(reps):
                    call()
            run()
            out["candidates %s, B=%d, %d builds" % (name, B, reps)] = (
                profiled(run, None))
    return out


def select_tables(frames, K):
    """{case: (areas, target, num_components, threshold)} of the selection
    (see the module docstring), from SlicAvx2's raw assignments (10
    iterations, stride 3)."""
    import torch
    from chip_smoke import make_frames
    from fast_slic_tpu_torch import cluster as cl, pipeline
    from fast_slic_tpu_torch.config import StaticConfig
    from fast_slic_tpu_torch.ops.cca import cca_parts, framed_cca_parts

    def raw(frame):
        H, W = frame.shape[:2]
        cfg = StaticConfig(H=H, W=W, K=K)
        scal = pipeline.derive_scalars(cfg, 10.0, 0.25)
        return pipeline.iterate_graph(
            torch.from_numpy(frame).cuda(),
            cl.initialize_clusters(frame, K).to_torch("cuda"), cfg, scal,
            10, 3).raw_assignment, int(scal.thres)

    raws = [raw(f) for f in frames]
    thres = raws[0][1]
    out = {"720p B=1": cca_parts(raws[0][0])[1:] + (thres,)}
    _, areas, target, ncomp = framed_cca_parts(
        torch.stack([r for r, _ in raws]), K)
    out["720p B=%d stacked" % len(frames)] = (areas, target, ncomp, thres)
    raw1080, thres1080 = raw(make_frames(1, 1080, 1920)[0])
    out["1080p B=1"] = cca_parts(raw1080)[1:] + (thres1080,)
    n = areas.shape[-1]
    rng = np.random.default_rng(0)
    tgt = np.zeros(n, np.int32)
    tgt[1:] = rng.integers(0, np.arange(1, n))
    full = torch.tensor(n, dtype=torch.int64, device="cuda")
    out["720p nc=n random"] = (
        torch.from_numpy(rng.integers(1, 61, n).astype(np.int32)).cuda(),
        torch.from_numpy(tgt).cuda(), full, thres)
    out["720p nc=n chain"] = (
        torch.ones(n, dtype=torch.int32, device="cuda"),
        torch.from_numpy(np.maximum(np.arange(n) - 1, 0).astype(
            np.int32)).cuda(), full, thres)
    return out


def profile_select(frames, K, reps=20):
    """The CCA's selection alone (``ops.cca._substitutes``) on each table of
    :func:`select_tables`: ``reps`` calls profiled (every device launch
    listed), then the host µs of a call over ``reps`` calls ended by one
    synchronize (the device's pace where a call's device time exceeds its
    host time)."""
    import torch
    from fast_slic_tpu_torch.ops.cca import _substitutes
    out = {}
    for name, (areas, target, ncomp, thres) in select_tables(frames,
                                                              K).items():
        def run(args=(areas, target, ncomp, K, thres)):
            for _ in range(reps):
                _substitutes(*args)
        run()
        row = profiled(run, None)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        row["host_us_a_call"] = (time.perf_counter() - t0) * 1e6 / reps
        row["components"] = ncomp.tolist()
        out["selection alone %s, %d calls" % (name, reps)] = row
    return out


def profile_knn(K, reps=20):
    """The KNN alone on the clusters of the first frame of
    chip_smoke.FIXTURE at chip_smoke.CRF_KNN neighbours: ``reps`` calls,
    every device launch listed; and ``reps`` calls of its bucketing alone
    where the checkout has it as a kernel."""
    import torch
    from chip_smoke import CRF_KNN, FIXTURE, H720, W720
    from fast_slic_tpu_torch.kernels import knn
    yxm = np.load(FIXTURE)["slice_clusters"][0]
    ys = torch.from_numpy(np.ascontiguousarray(yxm[:, 0])).cuda()
    xs = torch.from_numpy(np.ascontiguousarray(yxm[:, 1])).cuda()

    def run():
        for _ in range(reps):
            knn.knn(ys, xs, H720, W720, CRF_KNN)
    run()
    out = {"knn alone (720p clusters, m=%d)" % CRF_KNN: profiled(run, None)}
    if hasattr(knn, "knn_buckets"):
        def buckets():
            for _ in range(reps):
                knn.knn_buckets(ys, xs, H720, W720)
        buckets()
        out["knn_buckets alone (720p clusters)"] = profiled(buckets, None)
    return out


def profile_crf(frames, K):
    """One steady initialize(); inference(CRF_ITERS) cycle of a
    SimpleCRF(CRF_C, K) over the frames with their adjacency graphs,
    every device launch listed."""
    from chip_smoke import CRF_C, CRF_ITERS, crf_proba
    from fast_slic_tpu_torch import SimpleCRF, SlicAvx2
    slic = SlicAvx2(num_components=K, device="cuda")
    crf = SimpleCRF(CRF_C, K, device="cuda")
    for t, f in enumerate(frames):
        slic.iterate(f)
        crf.push_slic_frame(slic).set_proba(crf_proba(t, CRF_C, K))

    def cycle():
        crf.initialize()
        crf.inference(CRF_ITERS)
    cycle()
    return {"SimpleCRF cycle T=%d C=%d N=%d inference(%d)" % (
        len(frames), CRF_C, K, CRF_ITERS): profiled(cycle, None)}


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
    from fast_slic_tpu_torch import LSCAvx2, SlicAvx2, SlicRealDist, kernels
    from fast_slic_tpu_torch.parallel.batch import BatchedSlic

    frames = make_frames(BATCH, H720, W720)
    more = make_frames(2 * BATCH, H720, W720, seed=1)
    out = {"root": os.path.abspath(args.root),
           "device": torch.cuda.get_device_name(0)}
    for name, cls, kw in (("SlicAvx2", SlicAvx2, {}),
                          ("SlicAvx2 preemptive", SlicAvx2,
                           {"preemptive": True}),
                          ("LSCAvx2", LSCAvx2, {}),
                          ("SlicRealDist", SlicRealDist, {})):
        slic = cls(num_components=K720, device="cuda", **kw)
        out[name] = profile_frame(slic, frames[0], frames[1])
    out.update(profile_assign(frames[0], K720))
    out.update(profile_candidates(frames, K720))
    out.update(profile_assign_float(frames, K720))
    out.update(profile_segment_sum(frames[0], more[:BATCH], K720))
    out.update(profile_select(frames, K720))
    if hasattr(kernels, "knn"):  # a checkout from before the KNN has none
        out.update(profile_knn(K720))
        out.update(profile_crf(frames, K720))
    for name, kw in (("", {}), (" preemptive", {"preemptive": True}),
                     (" real_noq", {"variant": "real_noq"})):
        bs = BatchedSlic(num_components=K720, batch_mode="stack",
                         device="cuda", **kw)
        out["BatchedSlic stack B=%d%s" % (BATCH, name)] = profile_frame(
            bs, np.stack(more[:BATCH]), np.stack(more[BATCH:]))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
