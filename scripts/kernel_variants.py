#!/usr/bin/env python3
"""Device time of the CCA components, the assign kernels (quantized and
float), the segment sum and the KNN beside the variants their designs
were chosen from, at 1280x720, K=1600, on a CUDA GPU.

    python3 scripts/kernel_variants.py

Builds ``scripts/kernel_variants.cu`` (which includes the library's
``csrc/cca.cu``, ``csrc/assign.cu``, ``csrc/assign_float.cu`` and
``csrc/knn.cu``) with the library's nvcc flags into
``build/kernel_variants/``, makes real inputs (the raw assignments of
SlicAvx2's loop on the four frames of chip_smoke.py, one frame's and the
stacked [4*720, 1280] map that ``ops.cca.framed_components`` builds; a
mid-loop state, setup and three loop iterations, of one frame and of the
four frames stacked), holds every variant against the plain version, then
profiles 20 calls of each, in turns, each call kind in its own
torch.profiler run.  Calls:

- components: ``library`` (``cc_local``: row-group scans and label pairs,
  then ``cc_seams`` and ``cc_flatten``); ``union_find`` (the tile-local
  step as a union-find in shared memory, a thread a pixel, one union a
  pair of touching runs); ``union_find_halving`` (the same with path
  halving in its finds);
- assign, at stride 3 and 1: ``library`` (128 / S cells a block, 2 row
  groups of 4 rows, each thread loading its own pixels, the spatial
  table); ``staged_rows`` (each step's rows staged in shared memory by
  16-byte loads before the slot loop); ``one_group`` (one row group of 8
  rows a block); ``no_table`` (the spatial term computed in the loop);
- float assign, on a mid-loop state of each variant (as
  ``scripts/kernel_profile.py`` makes it): lsc, real_noq and real at
  stride 3 and 1, real_l2 at stride 3, lsc on four stacked frames at
  stride 3 and 1 and real_noq on four at stride 3:
  ``library`` (records staged once a cell, one row group of 4 consecutive
  rows a thread, a cell row's rows split over as many blocks as make one
  step each, each thread's pixels loaded after the staging) beside
  ``gGrR`` for G, R in (2, 4), (1, 8), (4, 2), (2, 2), (4, 1), (1, 2) and
  ``g1r4_prefetch``, each with the first step's pixels loaded before the
  staging, ``g2r4_rows_apart`` (the same with a thread's rows G apart, so
  that each spans the cell row: the first design), ``g2r4_no_prefetch``
  and ``g1r2_no_prefetch``;
- segment sum, on the CCA's component ids and values of the first frame's
  raw assignment, and the per-frame segment sum on the four frames'
  (B=4): ``library`` (a lane's runs, then the block's shared table, one
  atomic a slot and plane; one kernel for both, the frame a grid row);
  ``atomics`` (one global atomic a pixel and nonzero value: the per-frame
  sum's kernel before this design); ``runs_only`` (a lane's runs, each to
  device memory);
- KNN, on the clusters of the JAX package's first 720p frame at m=4 and
  m=60: ``library`` (``knn_buckets_kernel`` and ``knn_kernel``: a warp a
  cluster, its heap in shared memory, lane 0 running it);
  ``warp_lanes_heap`` (at m=4: the library's bucketing, then its walk with
  the heap held by the lanes, lane j heap[j], each sift done at once by
  ballots and shuffles); ``warp_first`` (the library's bucketing, then
  the warp walk's first design: each batch survivor tested one by one,
  the heap in shared memory behind a generic pointer);
  ``thread_per_cluster`` (the design before both, as its wrapper ran it:
  the bucketing by torch ops, then one thread a cluster with its heap in
  device memory); ``empty`` (an empty kernel of one warp: the floor of
  any launch); the bucketing alone, ``buckets`` (the library's), and cut
  after its count, its scan and its staging (``buckets_count``,
  ``buckets_scan``, ``buckets_staged``), and the walk alone on the
  library's buckets, in full (``walk``), cut after reading the window's
  runs (``walk_setup``) and after the batches' loads, distances and
  ballots (``walk_loads``, no heap), for the time of its parts, and in
  full over the first 528 and 132 clusters only (``walk_first_528``,
  ``walk_first_132``: 4 and 1 warps an SM's worth), for its latency.

Prints the card's name and power limit, then one JSON line of device
microseconds a call (all of a call's launches) and a launch by kernel.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CC_VARIANTS = {"union_find": 0, "union_find_halving": 1}
ASSIGN_VARIANTS = {"staged_rows": 0, "one_group": 1, "no_table": 2}
FLOAT_VARIANTS = {"g2r4_rows_apart": 0, "g2r4": 1, "g2r4_no_prefetch": 2,
                  "g1r8": 3, "g4r2": 4, "g2r2": 5, "g4r1": 6,
                  "g1r4_prefetch": 7, "g1r2": 8, "g1r2_no_prefetch": 9}
SEGSUM_VARIANTS = {"atomics": 0, "runs_only": 1}
VARIANT_CODE = {"real": 0, "real_l2": 1, "real_noq": 2, "lsc": 3}


def build():
    """Compile the variants; returns their C entry points (the KNN's three
    as a tuple)."""
    from fast_slic_tpu_torch.kernels import _lib
    out_dir = os.path.join(ROOT, "build", "kernel_variants")
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, "libkernel_variants.so")
    subprocess.run([_lib._nvcc(), *_lib.NVCC_FLAGS, "-shared", "-o", so,
                    os.path.join(ROOT, "scripts", "kernel_variants.cu")],
                   check=True)
    lib = ctypes.CDLL(so)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.cc_variant.argtypes = [I, P, P, I, I, P]
    lib.assign_variant.argtypes = [I, P, P, P, P, P, F] + [I] * 11 + [P]
    lib.assign_float_variant.argtypes = [I] + [P] * 7 + [F] + [I] * 12 + [P]
    lib.segsum_variant.argtypes = [I, P, P, P, I, I, I, I, P]
    lib.knn_variant.argtypes = [I, P, P, P, P, I, I, I, I, I, P, P, P, P, P]
    lib.knn_buckets_variant.argtypes = [I, P, P, I, I, I, I, I, I, P, P, P]
    lib.knn_walk_variant.argtypes = [I, P, P, P, P, I, I, I, I, I, P, P, P]
    knn_fns = (lib.knn_variant, lib.knn_buckets_variant, lib.knn_walk_variant)
    for fn in (lib.cc_variant, lib.assign_variant, lib.assign_float_variant,
               lib.segsum_variant) + knn_fns:
        fn.restype = I
    return (lib.cc_variant, lib.assign_variant, lib.assign_float_variant,
            lib.segsum_variant, knn_fns)


def inputs(dev):
    """The stacked raw assignments [4, H, W] and two mid-loop assign states
    (B=1 and B=4): (planes, table, cand, assignment)."""
    import numpy as np
    import torch
    from chip_smoke import H720, K720, W720, make_frames
    from fast_slic_tpu_torch import cluster as cl, pipeline
    from fast_slic_tpu_torch.config import StaticConfig

    cfg = StaticConfig(H=H720, W=W720, K=K720)
    scal = pipeline.derive_scalars(cfg, 10.0, 0.25)
    frames = make_frames(4, H720, W720)
    raws = [pipeline.iterate_graph(
        torch.from_numpy(f).to(dev),
        cl.initialize_clusters(f, K720).to_torch(dev), cfg, scal, 10,
        3).raw_assignment for f in frames]
    states = {}
    for B in (1, 4):
        st = cl.Clusters(*(np.stack(xs) for xs in zip(*(
            cl.initialize_clusters(f, K720).fields()
            for f in frames[:B])))).to_torch(dev)
        images = torch.from_numpy(np.stack(frames[:B])).to(dev)
        planes, st, _ = pipeline.stage_setup(images, st, cfg, scal)
        st, a, _, _ = pipeline.stage_loop(planes, st, (None, None, None),
                                          cfg, scal, 3, 3)
        st = pipeline._clamp_centers(st, cfg)
        cand, _ = pipeline.build_candidates_batched(st.y, st.x, st.is_active,
                                                    cfg)
        table = pipeline.center_table(st)
        if B == 1:
            planes, table, cand, a = (planes[:, 0].contiguous(), table[0],
                                      cand[0], a[0])
        states[B] = (planes, table, cand, a)
    return torch.stack(raws), states, cfg, scal


def device_us(call, reps=20):
    """Device µs a call of ``call`` (all its launches) and a launch of each
    kernel, from one torch.profiler run over ``reps`` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    total, kernels = 0.0, {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = e.self_device_time_total
        if us > 0:
            total += us
            kernels[e.key[:60]] = us / e.count
    return {"us_per_call": total / reps, "us_per_launch": kernels}


def in_turns(calls):
    """Each call profiled twice, in turns (a b ... b a)."""
    names = list(calls)
    runs = {n: [] for n in names}
    for n in names + names[::-1]:
        runs[n].append(device_us(calls[n]))
    return runs


def float_cases(float_variant, result):
    """The float assign and its variants, held against the plain version,
    then profiled in turns."""
    import torch
    from chip_smoke import H720, K720, W720, make_frames
    from fast_slic_tpu_torch.kernels import _lib, assign_float
    from kernel_profile import float_state

    frames = make_frames(4, H720, W720)
    for variant, B, strides in (("lsc", 1, (3, 1)), ("real_noq", 1, (3, 1)),
                                ("real", 1, (3, 1)), ("real_l2", 1, (3,)),
                                ("lsc", 4, (3, 1)), ("real_noq", 4, (3,))):
        states = [float_state(f, K720, variant) for f in frames[:B]]
        coef, S = states[0][6], states[0][7]
        if B == 1:
            planes, table, cand, a0, feats, cent = states[0][:6]
        else:
            planes, table, cand, a0, feats, cent = (
                None if xs[0] is None else torch.stack(xs, d)
                for xs, d in zip(zip(*(s[:6] for s in states)),
                                 (1, 0, 0, 0, 1, 0)))
        H, W = a0.shape[-2:]
        GH, GW, C = cand.shape[-3:]
        lsc = (feats, cent)
        for stride in strides:
            ref = a0.clone()
            ref_md = torch.full(ref.shape, -1.0, device=ref.device)
            assign_float.plain(planes, table, cand, ref, coef, S, stride, 0,
                               variant, True, ref_md, *lsc)
            a = a0.clone()

            def run(v, a=a, md=None):
                err = float_variant(
                    v, planes.data_ptr(),
                    None if feats is None else feats.data_ptr(),
                    table.data_ptr(),
                    None if cent is None else cent.data_ptr(),
                    cand.data_ptr(), a.data_ptr(),
                    None if md is None else md.data_ptr(), float(coef), H, W,
                    S, GH, GW, C, stride, 0, VARIANT_CODE[variant], 1, K720,
                    B, _lib.stream())
                if err:
                    raise RuntimeError("assign_float_variant %d: cudaError "
                                       "%d" % (v, err))

            calls = {"library": lambda a=a, stride=stride:
                     assign_float.assign_float(planes, table, cand, a, coef,
                                               S, stride, 0, variant, True,
                                               None, *lsc)}
            got, md = a0.clone(), torch.full_like(ref_md, -1.0)
            assign_float.assign_float(planes, table, cand, got, coef, S,
                                      stride, 0, variant, True, md, *lsc)
            checks = {"library": (got, md)}
            for vname, v in FLOAT_VARIANTS.items():
                calls[vname] = lambda v=v: run(v)
                got, md = a0.clone(), torch.full_like(ref_md, -1.0)
                run(v, got, md)
                checks[vname] = (got, md)
            for vname, (got, md) in checks.items():
                if not (torch.equal(got, ref) and torch.equal(md, ref_md)):
                    raise RuntimeError("float assign %s differs from the "
                                       "plain version" % vname)
            result["cases"]["assign_float %s B=%d stride %d"
                            % (variant, B, stride)] = in_turns(calls)


def segsum_cases(segsum_variant, raws, result):
    """The CCA's segment sums and their variants on the component ids of
    the first frame (segment_sum) and of the four frames stacked
    (framed_segment_sum, the stacked batch's call), held against the plain
    versions, then profiled in turns (each call with its zero fill of the
    output)."""
    import torch
    from chip_smoke import K720
    from fast_slic_tpu_torch.kernels import _lib, segsum
    from fast_slic_tpu_torch.ops.cca import framed_components, segsum_values

    comp, is_leader = framed_components(raws, K720)
    B = comp.shape[0]
    ids4 = comp.reshape(B, -1)
    vals4 = segsum_values(comp, is_leader).contiguous()
    V, _, n = vals4.shape
    ids1, vals1 = ids4[0], vals4[:, 0].contiguous()
    cases = {
        "segment_sum (CCA ids, V=2)": (
            1, ids1, vals1, lambda: segsum.segment_sum(ids1, vals1, n),
            segsum.segment_sum_plain(ids1, vals1, n)),
        "framed_segment_sum B=%d (CCA ids, V=2)" % B: (
            B, ids4, vals4,
            lambda: segsum.framed_segment_sum(ids4, vals4, n),
            segsum.framed_segment_sum_plain(ids4, vals4, n))}
    for name, (nb, ids, vals, library, ref) in cases.items():
        bins = n + 1 if nb == 1 else n

        def run(v, nb=nb, ids=ids, vals=vals, bins=bins, shape=ref.shape):
            out = torch.zeros(shape, dtype=torch.int32, device=ids.device)
            err = segsum_variant(v, ids.data_ptr(), vals.data_ptr(),
                                 out.data_ptr(), nb, n, V, bins,
                                 _lib.stream())
            if err:
                raise RuntimeError("segsum_variant %d: cudaError %d"
                                   % (v, err))
            return out

        calls = {"library": library}
        for vname, v in SEGSUM_VARIANTS.items():
            calls[vname] = lambda v=v, run=run: run(v)
        for vname, call in calls.items():
            if not torch.equal(call(), ref):
                raise RuntimeError("%s %s differs from the plain version"
                                   % (name, vname))
        result["cases"][name] = in_turns(calls)


def knn_cases(knn_fns, result):
    """The KNN call and the design before it, held against the host loop,
    then profiled in turns beside an empty launch."""
    import numpy as np
    import torch
    from chip_smoke import FIXTURE, H720, W720
    from fast_slic_tpu_torch.kernels import _lib, knn

    yxm = np.load(FIXTURE)["slice_clusters"][0]
    ys = torch.from_numpy(np.ascontiguousarray(yxm[:, 0])).cuda()
    xs = torch.from_numpy(np.ascontiguousarray(yxm[:, 1])).cuda()
    K = ys.shape[0]
    S, nh, nw = knn.grid(H720, W720, K)
    knn_variant, buckets_variant, walk_variant = knn_fns

    def run(v, m):
        sorted_ids, cell_start = knn.knn_buckets_plain(ys, xs, H720, W720)
        heap = torch.empty((2, m + 1, K), dtype=torch.int32, device="cuda")
        out = torch.empty((K, m), dtype=torch.int32, device="cuda")
        counts = torch.empty(K, dtype=torch.int32, device="cuda")
        err = knn_variant(v, ys.data_ptr(), xs.data_ptr(),
                          sorted_ids.data_ptr(), cell_start.data_ptr(), K, S,
                          nh, nw, m, heap[0].data_ptr(), heap[1].data_ptr(),
                          out.data_ptr(), counts.data_ptr(), _lib.stream())
        if err:
            raise RuntimeError("knn_variant %d: cudaError %d" % (v, err))
        return out, counts

    def warp_variant(v, m):
        sorted_ids, cell_start = knn.knn_buckets(ys, xs, H720, W720)
        out = torch.empty((K, m), dtype=torch.int32, device="cuda")
        counts = torch.empty(K, dtype=torch.int32, device="cuda")
        err = knn_variant(v, ys.data_ptr(), xs.data_ptr(),
                          sorted_ids.data_ptr(), cell_start.data_ptr(), K, S,
                          nh, nw, m, None, None, out.data_ptr(),
                          counts.data_ptr(), _lib.stream())
        if err:
            raise RuntimeError("knn_variant %d: cudaError %d" % (v, err))
        return out, counts

    def buckets_cut(stop):
        sorted_ids = torch.empty(K, dtype=torch.int32, device="cuda")
        cell_start = torch.empty(nh * nw + 1, dtype=torch.int32,
                                 device="cuda")
        err = buckets_variant(stop, ys.data_ptr(), xs.data_ptr(), K, S, nh,
                              nw, knn.BUCKET_RANGE,
                              min(knn.BUCKET_TILE, -(-K // 32) * 32),
                              sorted_ids.data_ptr(), cell_start.data_ptr(),
                              _lib.stream())
        if err:
            raise RuntimeError("knn_buckets_variant %d: cudaError %d"
                               % (stop, err))
        return sorted_ids, cell_start

    want = knn.knn_buckets_plain(ys, xs, H720, W720)
    if not all(torch.equal(g, w) for g, w in zip(buckets_cut(4), want)):
        raise RuntimeError("knn_buckets_cut differs from the plain version")
    calls = {"buckets": lambda: knn.knn_buckets(ys, xs, H720, W720)}
    for name, stop in (("buckets_count", 1), ("buckets_scan", 2),
                       ("buckets_staged", 3)):
        calls[name] = lambda stop=stop: buckets_cut(stop)
    result["cases"]["knn_buckets 720p K=%d" % K] = in_turns(calls)
    sorted_ids, cell_start = knn.knn_buckets(ys, xs, H720, W720)

    def walk_cut(stop, m, k=K):
        out = torch.empty((k, m), dtype=torch.int32, device="cuda")
        counts = torch.empty(k, dtype=torch.int32, device="cuda")
        err = walk_variant(stop, ys.data_ptr(), xs.data_ptr(),
                           sorted_ids.data_ptr(), cell_start.data_ptr(), k, S,
                           nh, nw, m, out.data_ptr(), counts.data_ptr(),
                           _lib.stream())
        if err:
            raise RuntimeError("knn_walk_variant %d: cudaError %d"
                               % (stop, err))
        return out, counts

    for m in (4, 60):
        want = knn.knn_plain(ys, xs, H720, W720, m)
        if not all(torch.equal(g.cpu(), w)
                   for g, w in zip(walk_cut(3, m), want)):
            raise RuntimeError("knn_walk_cut differs from the host loop")
        result["cases"]["knn walk 720p K=%d m=%d" % (K, m)] = in_turns({
            "walk": lambda m=m: walk_cut(3, m),
            "walk_loads": lambda m=m: walk_cut(2, m),
            "walk_setup": lambda m=m: walk_cut(1, m),
            "walk_first_528": lambda m=m: walk_cut(3, m, 528),
            "walk_first_132": lambda m=m: walk_cut(3, m, 132)})
        calls = {"library": lambda m=m: knn.knn(ys, xs, H720, W720, m),
                 "warp_first": lambda m=m: warp_variant(2, m),
                 "thread_per_cluster": lambda m=m: run(0, m)}
        for vname, call in calls.items():
            got = call()
            if not all(torch.equal(g.cpu(), w) for g, w in zip(got, want)):
                raise RuntimeError("knn %s at m=%d differs from the host "
                                   "loop" % (vname, m))
        if m < 32:
            calls["warp_lanes_heap"] = lambda m=m: warp_variant(3, m)
        calls["empty"] = lambda: knn_variant(1, *[None] * 4, 0, 1, 1, 1, 0,
                                             *[None] * 4, _lib.stream())
        result["cases"]["knn 720p K=%d m=%d" % (K, m)] = in_turns(calls)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("kernel_variants: needs a CUDA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from chip_smoke import K720, gpu_line
    from fast_slic_tpu_torch.kernels import _lib, assign, cca
    from fast_slic_tpu_torch.ops.cca import framed_labels

    print(gpu_line(), flush=True)
    dev = torch.device("cuda")
    (cc_variant, assign_variant, float_variant, segsum_variant,
     knn_fns) = build()
    raws, states, cfg, scal = inputs(dev)
    result = {"device": torch.cuda.get_device_name(0), "cases": {}}

    for name, labels in (("components B=1", raws[0].contiguous()),
                         ("components stacked B=4",
                          framed_labels(raws, K720))):
        H, W = labels.shape
        ref = cca.connected_components_plain(labels)
        out = torch.empty_like(labels)

        def variant(v, o=out, labels=labels, H=H, W=W):
            err = cc_variant(v, labels.data_ptr(), o.data_ptr(), H, W,
                             _lib.stream())
            if err:
                raise RuntimeError("cc_variant %d: cudaError %d" % (v, err))

        calls = {"library": lambda labels=labels:
                 cca.connected_components(labels)}
        for vname, v in CC_VARIANTS.items():
            calls[vname] = lambda v=v: variant(v)
            got = torch.empty_like(labels)
            variant(v, got)
            if not torch.equal(got, ref):
                raise RuntimeError("%s differs from the plain version" % vname)
        if not torch.equal(calls["library"](), ref):
            raise RuntimeError("connected_components differs from the plain "
                               "version")
        result["cases"][name] = in_turns(calls)

    for B in (1, 4):
        planes, table, cand, a0 = states[B]
        H, W = a0.shape[-2:]
        GH, GW, C = cand.shape[-3:]
        for stride in ((3, 1) if B == 1 else (3,)):
            ref = a0.clone()
            ref_md = torch.full_like(ref, -7)
            assign.plain(planes, table, cand, ref, scal.coef, cfg.S, stride,
                         0, True, ref_md)
            a = a0.clone()

            def variant(v, a=a, md=None):
                err = assign_variant(
                    v, planes.data_ptr(), table.data_ptr(), cand.data_ptr(),
                    a.data_ptr(), None if md is None else md.data_ptr(),
                    float(scal.coef), H, W, cfg.S, GH, GW, C, stride, 0, 1,
                    K720, B, _lib.stream())
                if err:
                    raise RuntimeError("assign_variant %d: cudaError %d"
                                       % (v, err))

            calls = {"library": lambda a=a, stride=stride: assign.assign(
                planes, table, cand, a, scal.coef, cfg.S, stride, 0, True)}
            for vname, v in ASSIGN_VARIANTS.items():
                calls[vname] = lambda v=v: variant(v)
                got, md = a0.clone(), torch.full_like(a0, -7)
                variant(v, got, md)
                if not (torch.equal(got, ref) and torch.equal(md, ref_md)):
                    raise RuntimeError("%s differs from the plain version"
                                       % vname)
            got, md = a0.clone(), torch.full_like(a0, -7)
            assign.assign(planes, table, cand, got, scal.coef, cfg.S, stride,
                          0, True, md)
            if not (torch.equal(got, ref) and torch.equal(md, ref_md)):
                raise RuntimeError("assign differs from the plain version")
            result["cases"]["assign B=%d stride %d" % (B, stride)] = (
                in_turns(calls))
    float_cases(float_variant, result)
    segsum_cases(segsum_variant, raws, result)
    knn_cases(knn_fns, result)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
