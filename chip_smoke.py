#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths once on one NVIDIA GPU and check
them: the standard main path, the float-distance path (the real variants
and LSC), the preemptive grid and batched frames (BatchedSlic).

    python3 chip_smoke.py            # from the repository root, on a GPU
    python3 chip_smoke.py --profile  # also: torch.profiler over one frame
                                     # of the standard, the LSC and the
                                     # preemptive path and one stacked
                                     # batch of four frames

Phases (any failure exits non-zero; no phase's error is caught):

1. the card: torch.cuda.is_available(), name and power limit (nvidia-smi);
2. build: the CUDA kernels of fast_slic_tpu_torch/csrc, compiled by nvcc;
3. kernels: each kernel against its plain PyTorch version, both on the
   card, at the paths' shapes (1280x720, K=1600, S=24, 16 candidate slots;
   assign, float assign (each variant) and update at stride 3 with each
   remainder and stride 1; CCA on a real raw assignment of the frame (the
   orphan chase on its selection's tables); the
   LSC features and the f32 segment sum on an LSC state of the frame; on
   four stacked frames after nine preemptive iterations, where some cells
   are inactive: assign, float assign and update with the frame axis, the
   masked update with that pixel mask at B=4 and B=1, and the per-frame
   segment sum on the CCA values of the four frames; the f32 segment sum
   again under frame 0's preemptive mask); bit-exact (the f32
   segment sum against its plain version on the CPU, whose order of
   addition it keeps; on the card index_add_ adds with float atomics), with
   times, the host time of a lookup, chase and f32 segment-sum call, each
   kernel's
   bound (the bytes it must move over 3.35 TB/s or its operations over
   67 TFLOP/s, the larger) and, where one PyTorch call computes the same
   function, that call's time;
4. slice, standard path: SlicAvx2(num_components=1600, device="cuda") on
   four 1280x720 frames made from tests/data/golden_ref.npz; labels and
   clusters equal the plain path (device="cpu") on the same frames;
5. slice, float path: LSCAvx2 on two frames (labels agree >= 0.999 with the
   plain path, clusters within 1 of it or 1 %), SlicRealDist,
   SlicRealDistL2 and SlicRealDistNoQ on one frame each (labels and
   clusters equal the plain path); the plain path runs each frame from the
   device model's state before it;
6. slice, preemptive grid: SlicAvx2(preemptive=True) on the four frames
   and LSCAvx2(preemptive=True) on one, against the plain path as above;
7. batch: BatchedSlic(num_components=1600) on two batches of four frames
   in stack and in map mode (labels and clusters equal across stack, map
   and four SlicAvx2 models on the card), one stacked batch of two frames
   against the plain path, and one stacked batch with preemptive=True and
   one with variant="real_noq" against map mode;
8. golden: the seven standard and the three real-distance golden cases
   agree 1.0 with golden_ref.npz, lsc_k256 >= 0.999.

Each path's launch counts are set to 0 just before it runs and read just
after; every kernel of the path must have been launched.  The line before
the last is {"kernels": [...]}; the last line is {"ok": true, "device":
{...}}.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

H720, W720, K720 = 720, 1280, 1600
GOLDEN = os.path.join(ROOT, "tests", "data", "golden_ref.npz")
BATCH = 4

# H100 SXM peaks (NVIDIA's data sheet, at 700 W): device memory, and float32
# outside the tensor cores (the integer ops of these kernels are counted at the
# same rate)
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12

# (K, StaticConfig flags, RuntimeParams overrides) as in tests/test_golden.py
GOLDEN_CASES = {
    "real_k256": (256, {"variant": "real"}, {}),
    "l2_k256": (256, {"variant": "real_l2"}, {}),
    "noq_k256": (256, {"variant": "real_noq"}, {}),
    "lsc_k256": (256, {"variant": "lsc"}, {}),
    "std_k256_msf01": (256, {}, {}),
    "std_k256_msf0": (256, {}, {"min_size_factor": 0.0}),
    "std_k100_nolab": (100, {"convert_to_lab": False},
                       {"min_size_factor": 0.25}),
    "std_k256_euclid": (256, {"manhattan_spatial_dist": False}, {}),
    "std_k256_stride1": (256, {}, {"subsample_stride": 1}),
    "std_k256_comp20": (256, {}, {"compactness": 20.0}),
    "std_k256_preempt": (256, {"preemptive": True},
                         {"preemptive_thres": 0.05}),
}


# the kernels each path must launch
STANDARD_PATH = ("lab", "assign", "slic_update", "segment_sum",
                 "connected_components", "lookup", "resolve_orphans")
FLOAT_PATH = ("lab", "lsc_feat", "assign_float", "slic_update", "fsegsum",
              "segment_sum", "connected_components", "lookup",
              "resolve_orphans")
PREEMPTIVE_PATH = ("lab", "lsc_feat", "assign", "assign_float",
                   "slic_update_masked", "fsegsum", "segment_sum",
                   "connected_components", "lookup", "resolve_orphans")
BATCH_PATH = ("lab", "assign", "assign_float", "slic_update",
              "slic_update_masked", "framed_segment_sum",
              "connected_components", "lookup", "resolve_orphans")
# device kernels of the redesigned calls, printed in every profile
PROFILE_ALWAYS = ("lookup_kernel", "resolve_orphans_kernel", "fs_rank",
                  "fs_scan", "fs_scatter", "fs_sum")
# the path whose run gives each kernel's launch count in the JSON line
COUNTED_ON = dict(
    [(k, "standard") for k in STANDARD_PATH]
    + [(k, "float") for k in ("lsc_feat", "assign_float", "fsegsum")]
    + [("slic_update_masked", "preemptive"), ("framed_segment_sum", "batch")])


class SmokeFailure(RuntimeError):
    pass


def require(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def resize_bilinear(img: np.ndarray, H: int, W: int) -> np.ndarray:
    h, w = img.shape[:2]
    ys = np.clip((np.arange(H) + 0.5) * h / H - 0.5, 0, h - 1)
    xs = np.clip((np.arange(W) + 0.5) * w / W - 0.5, 0, w - 1)
    y0 = np.floor(ys).astype(np.int64)
    x0 = np.floor(xs).astype(np.int64)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = (ys - y0)[:, None, None]
    wx = (xs - x0)[None, :, None]
    f = img.astype(np.float64)
    top = f[y0][:, x0] * (1 - wx) + f[y0][:, x1] * wx
    bot = f[y1][:, x0] * (1 - wx) + f[y1][:, x1] * wx
    return top * (1 - wy) + bot * wy


def make_frames(n: int, H: int, W: int, seed: int = 0, shift: int = 8):
    """n video-like uint8 frames [H, W, 3]: the golden image resized, panned
    by ``shift`` pixels a frame, plus Gaussian noise from ``seed``."""
    base = resize_bilinear(np.load(GOLDEN)["image"], H, W + shift * n)
    rng = np.random.default_rng(seed)
    frames = []
    for f in range(n):
        crop = base[:, shift * f: shift * f + W]
        noisy = crop + rng.normal(0.0, 2.0, size=crop.shape)
        frames.append(np.clip(np.rint(noisy), 0, 255).astype(np.uint8))
    return frames


def time_ms(fn, reps: int) -> float:
    """Mean device ms of fn over reps launches (CUDA events), after one
    warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def host_us(fn, reps: int = 1000) -> float:
    """Host microseconds a call of fn: the host clock over reps calls after
    a synchronize, with no synchronize inside.  Where a call's device time
    exceeds its host time, the host waits on the launch queue and this
    reads the device's rate instead."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) * 1e6 / reps
    torch.cuda.synchronize()
    return us


def paired_times(kernel_fn, plain_fn, reps: int, plain_reps: int):
    """Times in turns (plain, kernel, kernel, plain); the min of each pair."""
    p1 = time_ms(plain_fn, plain_reps)
    k1 = time_ms(kernel_fn, reps)
    k2 = time_ms(kernel_fn, reps)
    p2 = time_ms(plain_fn, plain_reps)
    return min(k1, k2), min(p1, p2)


def bound(moved: float, ops: float):
    """The least time the card could take: the bytes the call must move
    (each input read once, each output written once) over the memory rate,
    or its operations over the scalar rate, the larger; in ms, with which
    of the two bounds it."""
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, ops / SCALAR_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def max_abs_err(a, b):
    require(a.shape == b.shape and a.dtype == b.dtype,
            "shape/dtype differ: %s %s vs %s %s"
            % (tuple(a.shape), a.dtype, tuple(b.shape), b.dtype))
    if not a.numel():
        return 0
    if a.is_floating_point():
        return float((a.double() - b.double()).abs().max())
    return int((a.long() - b.long()).abs().max())


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def cand_visits(cand, H: int, W: int, S: int, stride: int, rem: int) -> int:
    """Candidate slots the assign kernels visit on the rows i % stride ==
    rem: each pixel walks its cell's list up to the first empty slot."""
    import torch
    filled = (cand >= 0).sum(-1)                       # [..., GH, GW]
    GH, GW = filled.shape[-2:]
    ci = torch.clamp(torch.arange(rem, H, stride, device=cand.device) // S,
                     max=GH - 1)
    cj = torch.clamp(torch.arange(W, device=cand.device) // S, max=GW - 1)
    return int(filled[..., ci, :][..., cj].sum())


# operations counted per unit of work for the bound (a lower count: the
# arithmetic of the kernel's inner statement, not its index math)
OPS_PER_VISIT = {"standard": 12, "real": 14, "real_l2": 16, "real_noq": 22,
                 "lsc": 30}


class Results:
    """Each kernel's row of the JSON line: its largest error against the
    plain version and, for the call that represents it, its time, the
    plain version's, the library call's and the bound."""

    def __init__(self):
        self.rows = {}

    def check(self, name, err):
        r = self.rows.setdefault(name, {
            "max_abs_err": 0, "ms": None, "plain_ms": None, "bound_ms": None,
            "bound_by": None, "library_ms": None})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        require(err == 0, "%s disagrees with its plain version: max abs err "
                "%r" % (name, err))

    def time(self, name, kernel_fn, plain_fn, moved, ops, library_fn=None,
             reps=50, plain_reps=5):
        ms, plain_ms = paired_times(kernel_fn, plain_fn, reps, plain_reps)
        b_ms, b_by = bound(moved, ops)
        self.rows[name].update(
            ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=time_ms(library_fn, reps) if library_fn else None)

    def log(self):
        for name, r in self.rows.items():
            log("kernel %s: max abs err %r, kernel %.4f ms, plain %.4f ms, "
                "bound %.4f ms (%s), library %s ms"
                % (name, r["max_abs_err"], r["ms"], r["plain_ms"],
                   r["bound_ms"], r["bound_by"], r["library_ms"]))


def log_times(what, kernel_fn, plain_fn, moved, ops):
    """Time a kernel call that is not its JSON row's (another stride, the
    frame axis) and log it beside its bound."""
    ms, plain_ms = paired_times(kernel_fn, plain_fn, 50, 5)
    b_ms, b_by = bound(moved, ops)
    log("kernel %s: kernel %.4f ms, plain %.4f ms, bound %.4f ms (%s)"
        % (what, ms, plain_ms, b_ms, b_by))


def kernel_phase(dev, frame, K: int, res: Results):
    """Each kernel of the standard and float paths vs its plain version on
    ``dev`` at the frame's shapes."""
    import torch
    from fast_slic_tpu_torch import cluster as cl, pipeline
    from fast_slic_tpu_torch.config import StaticConfig, UNASSIGNED
    from fast_slic_tpu_torch.kernels import assign, cca, lab, segsum
    from fast_slic_tpu_torch.ops.cca import (cca_parts, leader_ranks,
                                             orphan_tables, segsum_values)
    from fast_slic_tpu_torch.ops.cielab import lab_tables

    H, W = frame.shape[:2]
    n = H * W
    cfg = StaticConfig(H=H, W=W, K=K)
    scal = pipeline.derive_scalars(cfg, 10.0, 0.25)

    image = torch.from_numpy(frame).to(dev)
    res.check("lab", max_abs_err(lab.rgb_to_lab_planar(image),
                                 lab.plain(image)))
    res.time("lab", lambda: lab.rgb_to_lab_planar(image),
             lambda: lab.plain(image),
             15 * n + nbytes(*lab_tables(dev)), 30 * n)

    # a mid-loop state: setup and three loop iterations through the kernels
    st = cl.initialize_clusters(frame, K).to_torch(dev)
    planes, st, lsc_state = pipeline.stage_setup(image, st, cfg, scal)
    st, a0, _, _ = pipeline.stage_loop(planes, st, lsc_state, cfg, scal, 3, 3)
    st = pipeline._clamp_centers(st, cfg)
    cand, _ = pipeline.build_candidates(st.y, st.x, st.is_active, cfg)
    table = pipeline.center_table(st)
    log("kernel phase: H=%d W=%d K=%d S=%d cand=%s planes=%s"
        % (H, W, K, cfg.S, tuple(cand.shape), tuple(planes.shape)))
    for stride, rem in ((3, 0), (3, 1), (3, 2), (1, 0)):
        outs = []
        for fn in (assign.assign, assign.plain):
            a = a0.clone()
            md = torch.full_like(a, UNASSIGNED)
            fn(planes, table, cand, a, scal.coef, cfg.S, stride, rem,
               True, min_dists=md)
            outs.append((a, md))
        res.check("assign", max(max_abs_err(outs[0][0], outs[1][0]),
                                max_abs_err(outs[0][1], outs[1][1])))
        a_k = outs[0][0]
        P = len(range(rem, H, stride)) * W
        if rem == 0:  # the pass is idempotent, so it is timed in place
            args = (lambda: assign.assign(planes, table, cand, a_k,
                                          scal.coef, cfg.S, stride, rem,
                                          True),
                    lambda: assign.plain(planes, table, cand, a_k, scal.coef,
                                         cfg.S, stride, rem, True),
                    16 * P + nbytes(cand, table),
                    OPS_PER_VISIT["standard"]
                    * cand_visits(cand, H, W, cfg.S, stride, rem))
            if stride == 3:
                res.time("assign", *args)
            else:
                log_times("assign at stride 1", *args)
        upd_k = segsum.slic_update(a_k, planes, K, stride, rem)
        upd_p = segsum.slic_update_plain(a_k, planes, K, stride, rem)
        res.check("slic_update", max_abs_err(upd_k, upd_p))
        if (stride, rem) == (3, 0):
            res.time("slic_update",
                     lambda: segsum.slic_update(a_k, planes, K, stride, rem),
                     lambda: segsum.slic_update_plain(a_k, planes, K, stride,
                                                      rem),
                     16 * P + 24 * K, 6 * P)

    # CCA kernels on a real raw assignment of the frame
    out = pipeline.iterate_graph(
        image, cl.initialize_clusters(frame, K).to_torch(dev), cfg, scal,
        10, 3)
    raw = out.raw_assignment
    res.check("connected_components",
              max_abs_err(cca.connected_components(raw),
                          cca.connected_components_plain(raw)))
    res.time("connected_components", lambda: cca.connected_components(raw),
             lambda: cca.connected_components_plain(raw), 8 * n, 10 * n,
             plain_reps=2)
    L = cca.connected_components_plain(raw).reshape(-1)
    is_leader, rank, ncomp = leader_ranks(L)
    L_long = L.long()
    res.check("lookup", max_abs_err(cca.lookup(L, rank),
                                    cca.lookup_plain(L, rank)))
    res.time("lookup", lambda: cca.lookup(L, rank),
             lambda: cca.lookup_plain(L, rank), 8 * n + nbytes(rank), n,
             library_fn=lambda: rank[L_long])
    # the orphan chase on the tables of this frame's selection
    _, areas, target, _ = cca_parts(raw)
    sub, ptrs, _ = orphan_tables(areas, target, ncomp, K, int(scal.thres))
    res.check("resolve_orphans",
              max_abs_err(cca.resolve_orphans(sub, ptrs),
                          cca.resolve_orphans_plain(sub, ptrs)))
    res.time("resolve_orphans", lambda: cca.resolve_orphans(sub, ptrs),
             lambda: cca.resolve_orphans_plain(sub, ptrs), 12 * n, n)
    log("kernel phase: %d of %d components dropped (orphans)"
        % (int((sub == UNASSIGNED).sum()), int(ncomp)))
    log("host: lookup %.2f us a call, resolve_orphans %.2f us a call "
        "(host clock over 1000 calls)"
        % (host_us(lambda: cca.lookup(L, rank)),
           host_us(lambda: cca.resolve_orphans(sub, ptrs))))
    comp2 = cca.lookup_plain(L, rank).reshape(H, W)
    vals = segsum_values(comp2, is_leader).contiguous()
    ids = comp2.reshape(-1)
    ids_long = ids.long()
    res.check("segment_sum",
              max_abs_err(segsum.segment_sum(ids, vals, n),
                          segsum.segment_sum_plain(ids, vals, n)))
    res.time("segment_sum", lambda: segsum.segment_sum(ids, vals, n),
             lambda: segsum.segment_sum_plain(ids, vals, n),
             nbytes(ids, vals) + 8 * (n + 1), 2 * n,
             library_fn=lambda: torch.zeros(
                 (2, n + 1), dtype=torch.int32, device=dev).index_add_(
                     1, ids_long, vals))
    log("kernel phase: raw assignment has %d components" % int(ncomp))
    return float_kernel_phase(dev, image, K, res)


def float_kernel_phase(dev, image, K: int, res: Results):
    """The float path's kernels vs their plain versions: the float assign
    of each variant on a mid-loop state of that variant (setup and three
    loop iterations through the kernels), and LSC's colour features and f32
    segment sum on the LSC state.  Returns the segment sum's arguments
    (ids, mask, vals)."""
    import torch
    from fast_slic_tpu_torch import cluster as cl, pipeline
    from fast_slic_tpu_torch.config import StaticConfig
    from fast_slic_tpu_torch.kernels import assign_float, fsegsum, lsc_feat

    H, W = image.shape[:2]
    n = H * W
    frame = image.cpu().numpy()
    for variant in ("real", "real_l2", "real_noq", "lsc"):
        cfg = StaticConfig(H=H, W=W, K=K, variant=variant)
        scal = pipeline.derive_scalars(cfg, 10.0, 0.25)
        st = cl.initialize_clusters(frame, K).to_torch(dev)
        planes, st, (feats, weights, cent) = pipeline.stage_setup(
            image, st, cfg, scal)
        st, a0, cent, _ = pipeline.stage_loop(
            planes, st, (feats, weights, cent), cfg, scal, 3, 3)
        st = pipeline._clamp_centers(st, cfg)
        cand, _ = pipeline.build_candidates(st.y, st.x, st.is_active, cfg)
        table = pipeline.center_table(st)
        for stride, rem in ((3, 0), (3, 1), (3, 2), (1, 0)):
            outs = []
            for fn in (assign_float.assign_float, assign_float.plain):
                a = a0.clone()
                md = torch.full(a.shape, assign_float.F32_MAX, device=dev)
                fn(planes, table, cand, a, scal.coef, cfg.S, stride, rem,
                   variant, True, md, feats, cent)
                outs.append((a, md))
            res.check("assign_float",
                      max(max_abs_err(outs[0][0], outs[1][0]),
                          max_abs_err(outs[0][1], outs[1][1])))
            if rem:
                continue
            # the pass is idempotent, so it is timed in place; the JSON
            # line carries LSC's stride-3 times (the path's heaviest
            # variant), the log every variant's
            a_k = outs[0][0]
            P = len(range(rem, H, stride)) * W
            per_px = 44 if variant == "lsc" else 16
            args = (lambda: assign_float.assign_float(
                        planes, table, cand, a_k, scal.coef, cfg.S, stride,
                        rem, variant, True, None, feats, cent),
                    lambda: assign_float.plain(
                        planes, table, cand, a_k, scal.coef, cfg.S, stride,
                        rem, variant, True, None, feats, cent),
                    per_px * P + nbytes(cand, table)
                    + (nbytes(cent) if variant == "lsc" else 0),
                    OPS_PER_VISIT[variant]
                    * cand_visits(cand, H, W, cfg.S, stride, rem))
            if (variant, stride) == ("lsc", 3):
                res.time("assign_float", *args)
            else:
                log_times("assign_float %s at stride %d" % (variant, stride),
                          *args)

    # the loop ended on lsc: planes, scal, feats, weights, a0 are its state
    tabs = [torch.from_numpy(scal.lsc_tables[k]).to(dev)
            for k in ("L_cos", "L_sin", "color_cos", "color_sin")]
    res.check("lsc_feat", max_abs_err(lsc_feat.lsc_color_feats(planes, *tabs),
                                      lsc_feat.plain(planes, *tabs)))
    res.time("lsc_feat", lambda: lsc_feat.lsc_color_feats(planes, *tabs),
             lambda: lsc_feat.plain(planes, *tabs),
             36 * n + nbytes(*tabs), 6 * n)

    # the segment sum as after_update calls it at stride 3, rem 0
    ok = a0[0::3] != 0xFFFF
    ids = torch.where(ok, a0[0::3], K).reshape(-1).to(torch.int32)
    mask = ok.reshape(-1).to(torch.int32)
    vals = torch.cat([feats[:, 0::3], weights[None, 0::3]]).reshape(11, -1)
    # the kernel keeps the CPU index_add_'s order of addition: exact there
    got = fsegsum.float_segsum(ids, mask, vals, K, 10)
    ref = fsegsum.plain(ids.cpu(), mask.cpu(), vals.cpu(), K, 10)
    res.check("fsegsum", max_abs_err(got.cpu(), ref))
    got2 = fsegsum.float_segsum(ids, mask, vals, K, 10)
    require(torch.equal(got, got2), "fsegsum differs between two runs")
    ids_long = ids.long()   # unassigned pixels already in the dropped bin K
    Ns = ids.numel()
    # library: the unweighted sum of the same rows (one index_add_)
    res.time("fsegsum", lambda: fsegsum.float_segsum(ids, mask, vals, K, 10),
             lambda: fsegsum.plain(ids, mask, vals, K, 10),
             nbytes(ids, mask, vals) + 44 * (K + 1), 22 * Ns,
             library_fn=lambda: torch.zeros(
                 (11, K + 1), device=dev).index_add_(1, ids_long, vals))
    log("kernel phase: float path at N=%d segment-sum pixels" % Ns)
    log("host: fsegsum %.2f us a call (host clock over 1000 "
        "calls)" % host_us(lambda: fsegsum.float_segsum(ids, mask, vals, K, 10)))
    return ids, mask, vals


def frame_kernel_phase(dev, frames, K: int, res: Results, fseg):
    """The kernels with a frame axis and the two kernels of the preemptive
    and stacked paths, on four stacked frames after nine preemptive loop
    iterations (the pixel mask then has inactive cells): assign, float
    assign (real, real_l2, real_noq) and update over the B frames, the
    masked update at B=4 and B=1, each at stride 3 with each remainder and
    at stride 1, and the per-frame segment sum on the frames' CCA values;
    and the f32 segment sum ``fseg`` (ids, mask, vals of the LSC state)
    again with frame 0's preemptive mask."""
    import torch
    from fast_slic_tpu_torch import cluster as cl, pipeline
    from fast_slic_tpu_torch.config import StaticConfig, UNASSIGNED
    from fast_slic_tpu_torch.kernels import assign, assign_float, segsum
    from fast_slic_tpu_torch.ops.cca import framed_components, segsum_values

    B = len(frames)
    H, W = frames[0].shape[:2]
    n = H * W
    cfg = StaticConfig(H=H, W=W, K=K, preemptive=True)
    scal = pipeline.derive_scalars(cfg, 10.0, 0.25, 0.05)
    sts = [cl.initialize_clusters(f, K) for f in frames]
    st = cl.Clusters(*(np.stack(xs) for xs in zip(
        *(s.fields() for s in sts)))).to_torch(dev)
    images = torch.from_numpy(np.stack(frames)).to(dev)
    no_lsc = (None, None, None)
    planes, st, _ = pipeline.stage_setup(images, st, cfg, scal)
    st, a0, _, _ = pipeline.stage_loop(planes, st, no_lsc, cfg, scal, 9, 3)
    mask = pipeline.preemptive_mask(st, cfg)
    share = float(mask.float().mean())
    log("frame kernel phase: B=%d, after 9 preemptive iterations %.4f of "
        "the pixels active, %d of %d clusters inactive"
        % (B, share, int((st.is_active == 0).sum()), B * K))
    require(share < 1.0, "no inactive cell after nine preemptive iterations")
    st = pipeline._clamp_centers(st, cfg)
    cand, _ = pipeline.build_candidates_batched(st.y, st.x, st.is_active, cfg)
    table = pipeline.center_table(st)
    planes1, mask1 = planes[:, 0].contiguous(), mask[0]
    for stride, rem in ((3, 0), (3, 1), (3, 2), (1, 0)):
        P = len(range(rem, H, stride)) * W
        outs = []
        for fn in (assign.assign, assign.plain):
            a = a0.clone()
            md = torch.full_like(a, UNASSIGNED)
            fn(planes, table, cand, a, scal.coef, cfg.S, stride, rem, True,
               min_dists=md)
            outs.append((a, md))
        res.check("assign", max(max_abs_err(outs[0][0], outs[1][0]),
                                max_abs_err(outs[0][1], outs[1][1])))
        a_k = outs[0][0]
        if rem == 0:
            log_times("assign B=%d at stride %d" % (B, stride),
                      lambda: assign.assign(planes, table, cand, a_k,
                                            scal.coef, cfg.S, stride, rem,
                                            True),
                      lambda: assign.plain(planes, table, cand, a_k,
                                           scal.coef, cfg.S, stride, rem,
                                           True),
                      16 * B * P + nbytes(cand, table),
                      OPS_PER_VISIT["standard"]
                      * cand_visits(cand, H, W, cfg.S, stride, rem))
        for variant in ("real", "real_l2", "real_noq"):
            outs = []
            for fn in (assign_float.assign_float, assign_float.plain):
                a = a0.clone()
                md = torch.full(a.shape, assign_float.F32_MAX, device=dev)
                fn(planes, table, cand, a, scal.coef, cfg.S, stride, rem,
                   variant, True, md)
                outs.append((a, md))
            res.check("assign_float",
                      max(max_abs_err(outs[0][0], outs[1][0]),
                          max_abs_err(outs[0][1], outs[1][1])))
            if (stride, rem) == (3, 0):
                a_f = outs[0][0]
                log_times(
                    "assign_float %s B=%d at stride 3" % (variant, B),
                    lambda: assign_float.assign_float(
                        planes, table, cand, a_f, scal.coef, cfg.S, stride,
                        rem, variant, True),
                    lambda: assign_float.plain(
                        planes, table, cand, a_f, scal.coef, cfg.S, stride,
                        rem, variant, True),
                    16 * B * P + nbytes(cand, table),
                    OPS_PER_VISIT[variant]
                    * cand_visits(cand, H, W, cfg.S, stride, rem))
        res.check("slic_update",
                  max_abs_err(segsum.slic_update(a_k, planes, K, stride, rem),
                              segsum.slic_update_plain(a_k, planes, K, stride,
                                                       rem)))
        if rem == 0:
            log_times("slic_update B=%d at stride %d" % (B, stride),
                      lambda: segsum.slic_update(a_k, planes, K, stride, rem),
                      lambda: segsum.slic_update_plain(a_k, planes, K,
                                                       stride, rem),
                      16 * B * P + 24 * B * K, 6 * B * P)
        for nb, args in ((B, (a_k, planes, mask)), (1, (a_k[0], planes1,
                                                         mask1))):
            res.check("slic_update_masked", max_abs_err(
                segsum.slic_update_masked(*args, K, stride, rem),
                segsum.slic_update_masked_plain(*args, K, stride, rem)))
            if rem:
                continue
            active = int(args[2][rem::stride].sum())
            timed = (lambda args=args: segsum.slic_update_masked(
                         *args, K, stride, rem),
                     lambda args=args: segsum.slic_update_masked_plain(
                         *args, K, stride, rem),
                     17 * nb * P + 24 * nb * K, 6 * active)
            if (nb, stride) == (1, 3):
                res.time("slic_update_masked", *timed)
            else:
                log_times("slic_update_masked B=%d at stride %d"
                          % (nb, stride), *timed)

    # LSC's segment sum under frame 0's preemptive mask (rows 0::3), beside
    # the unmasked call
    from fast_slic_tpu_torch.kernels import fsegsum
    ids, fmask, vals = fseg
    pmask = fmask & mask[0, 0::3].reshape(-1).to(torch.int32)
    got = fsegsum.float_segsum(ids, pmask, vals, K, 10)
    res.check("fsegsum", max_abs_err(got.cpu(), fsegsum.plain(
        ids.cpu(), pmask.cpu(), vals.cpu(), K, 10)))
    masked_ms, unmasked_ms = paired_times(
        lambda: fsegsum.float_segsum(ids, pmask, vals, K, 10),
        lambda: fsegsum.float_segsum(ids, fmask, vals, K, 10), 50, 50)
    log("kernel fsegsum under the preemptive mask (%.4f of the pixels "
        "kept): %.4f ms, unmasked %.4f ms"
        % (float(pmask.float().mean()), masked_ms, unmasked_ms))

    # the per-frame segment sum on the CCA values of the four frames
    st = st.replace(is_active=torch.ones_like(st.is_active))
    _, raw, _, _ = pipeline.stage_full_assign(planes, st, no_lsc, None,
                                              a0.clone(), cfg, scal)
    comp, is_leader = framed_components(raw, K)
    vals = segsum_values(comp, is_leader).contiguous()          # [2, B, n]
    ids = comp.reshape(B, n)
    res.check("framed_segment_sum", max_abs_err(
        segsum.framed_segment_sum(ids, vals, n),
        segsum.framed_segment_sum_plain(ids, vals, n)))
    gid = (ids.long() + torch.arange(B, device=dev)[:, None] * n).reshape(-1)
    vals2 = vals.reshape(2, -1)
    res.time("framed_segment_sum",
             lambda: segsum.framed_segment_sum(ids, vals, n),
             lambda: segsum.framed_segment_sum_plain(ids, vals, n),
             nbytes(ids, vals) + 8 * B * n, 2 * B * n,
             library_fn=lambda: torch.zeros(
                 (2, B * n), dtype=torch.int32, device=dev).index_add_(
                     1, gid, vals2))


def slice_phase(dev, frames, K: int):
    """The standard path: SlicAvx2 on the frames on ``dev`` and on the CPU
    (plain path); the results must be equal.  Returns (launch counts of the
    device run, host ms per frame, device ms per frame from the timing
    report, tie escalation per frame, last timing report)."""
    from fast_slic_tpu_torch import SlicAvx2
    from fast_slic_tpu_torch.kernels import launch_counts, reset_launches

    H, W = frames[0].shape[:2]
    slic = SlicAvx2(num_components=K, device=dev)
    results, ms, dev_ms, ties = [], [], [], []
    reset_launches()
    for f in frames:
        t0 = time.perf_counter()
        labels = slic.iterate(f)  # returns numpy: the device has finished
        ms.append((time.perf_counter() - t0) * 1e3)
        report = slic.slic_model.last_timing_report
        dev_ms.append(json.loads(report)["duration"] / 1e3)
        ties.append(slic.slic_model.last_cca_tie)
        results.append((labels, slic.slic_model.to_yxmrgb()))
    counts = launch_counts()

    plain = SlicAvx2(num_components=K, device="cpu")
    for i, (f, (labels, yxmrgb)) in enumerate(zip(frames, results)):
        require(labels.shape == (H, W) and labels.dtype == np.int16,
                "frame %d: labels %s %s" % (i, labels.shape, labels.dtype))
        require(labels.min() >= 0 and labels.max() < K,
                "frame %d: labels outside [0, K)" % i)
        ref = plain.iterate(f)
        require(np.array_equal(labels, ref),
                "frame %d: labels differ from the plain path at %d pixels"
                % (i, int((labels != ref).sum())))
        require(np.array_equal(yxmrgb, plain.slic_model.to_yxmrgb()),
                "frame %d: clusters differ from the plain path" % i)
    return counts, ms, dev_ms, ties, report


def compare_phase(dev, runs, K: int, tag: str, **kw):
    """Models of the classes in ``runs`` ((class, frames) pairs, built with
    ``kw``) on ``dev``, each carrying its clusters from frame to frame, and
    every frame again on the CPU (plain path) from the device model's state
    before that frame: labels and clusters equal, or for LSC labels agree
    >= 0.999 and clusters within 1 or 1 % (its image-wide float64 sums may
    round differently on the two devices; a difference would compound over
    frames if the CPU model carried its own state).  Returns the launch
    counts of the device runs."""
    from fast_slic_tpu_torch.kernels import launch_counts, reset_launches

    results = []
    reset_launches()
    for cls, fs in runs:
        slic = cls(num_components=K, device=dev, **kw)
        for f in fs:
            model = slic.slic_model
            start = model._clusters.copy() if model.initialized else None
            t0 = time.perf_counter()
            labels = slic.iterate(f)  # numpy: the device has finished
            host_ms = (time.perf_counter() - t0) * 1e3
            report = json.loads(model.last_timing_report)
            results.append((start, labels, model.to_yxmrgb(),
                            report["duration"] / 1e3, host_ms,
                            model.last_cca_tie))
    counts = launch_counts()

    out = iter(results)
    for cls, fs in runs:
        for i, f in enumerate(fs):
            start, labels, yxmrgb, dev_ms, host_ms, tie = next(out)
            plain = cls(num_components=K, device="cpu", **kw)
            if start is not None:
                plain.slic_model._clusters = start
                plain.slic_model.initialized = True
            ref = plain.iterate(f)
            ref_yxm = plain.slic_model.to_yxmrgb()
            agree = float((labels == ref).mean())
            moved = int((yxmrgb != ref_yxm).any(axis=1).sum())
            log("slice %s %s frame %d: %.3f ms (CUDA events over iterate), "
                "%.3f ms (host clock), tie escalation %s, label agreement "
                "with the plain path %r, clusters that differ %d"
                % (tag, cls.__name__, i + 1, dev_ms, host_ms, tie, agree,
                   moved))
            require(labels.shape == ref.shape and labels.min() >= 0,
                    "%s frame %d: labels shape or range" % (cls.__name__, i))
            if cls.__name__.startswith("LSC"):
                far = int((~np.isclose(yxmrgb, ref_yxm, rtol=0.01, atol=1.0)
                           ).any(axis=1).sum())
                log("slice %s %s frame %d: %d clusters beyond 1 or 1 %% of "
                    "the plain path (largest difference %r)"
                    % (tag, cls.__name__, i + 1, far,
                       float(np.abs(yxmrgb - ref_yxm).max())))
                require(agree >= 0.999, "%s frame %d: agreement %r"
                        % (cls.__name__, i, agree))
                require(far == 0, "%s frame %d: clusters differ from the "
                        "plain path" % (cls.__name__, i))
            else:
                require(agree == 1.0 and np.array_equal(yxmrgb, ref_yxm),
                        "%s frame %d: labels or clusters differ from the "
                        "plain path" % (cls.__name__, i))
    return counts


def timed_batch(bs, frames):
    """One BatchedSlic.iterate: labels on the host, CUDA-event ms and
    host-clock ms (both end when the device has finished), and the number
    of frames that took the tie escalation."""
    import torch
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    labels = bs.iterate(frames)
    stop.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    return (labels.cpu().numpy(), start.elapsed_time(stop), host_ms,
            int(bs.last_flags.sum()))


def states_equal(a, b):
    return all(np.array_equal(x, y) for x, y in zip(a.fields(), b.fields()))


def batch_phase(dev, batches, K: int):
    """BatchedSlic on the batches (frame position f of every batch is one
    stream) in stack and in map mode, then one stacked batch with the
    preemptive grid and one of real_noq; the checks of phase 7.  Returns
    the launch counts of the batch path."""
    from fast_slic_tpu_torch import SlicAvx2
    from fast_slic_tpu_torch.kernels import launch_counts, reset_launches
    from fast_slic_tpu_torch.parallel.batch import BatchedSlic

    B = len(batches[0])
    modes = {m: BatchedSlic(num_components=K, batch_mode=m, device=dev)
             for m in ("stack", "map")}
    extra = [BatchedSlic(num_components=K, batch_mode="stack", device=dev,
                         **kw)
             for kw in ({"preemptive": True}, {"variant": "real_noq"})]
    labels = {m: [] for m in modes}
    reset_launches()
    for t, frames in enumerate(batches):
        for m, bs in modes.items():
            lab, dev_ms, host_ms, ties = timed_batch(bs, frames)
            labels[m].append(lab)
            log("batch %s B=%d batch %d: %.3f ms (CUDA events over iterate), "
                "%.3f ms (host clock); per frame %.3f ms, %.3f ms; %d tie "
                "escalations" % (m, B, t + 1, dev_ms, host_ms, dev_ms / B,
                                 host_ms / B, ties))
    extra_labels = []
    for bs in extra:
        lab, dev_ms, host_ms, ties = timed_batch(bs, batches[0])
        extra_labels.append(lab)
        log("batch stack %s B=%d: %.3f ms (CUDA events), %.3f ms (host "
            "clock); %d tie escalations"
            % ("preemptive" if bs.preemptive else bs.variant, B, dev_ms,
               host_ms, ties))
    counts = launch_counts()

    for t in range(len(batches)):
        require(np.array_equal(labels["stack"][t], labels["map"][t]),
                "batch %d: stack and map labels differ" % t)
        require(labels["stack"][t].shape == batches[t].shape[:3]
                and labels["stack"][t].min() >= 0
                and labels["stack"][t].max() < K,
                "batch %d: labels shape or range" % t)
    require(states_equal(modes["stack"].state, modes["map"].state),
            "stack and map cluster states differ")
    st = modes["stack"].state
    for f in range(B):
        slic = SlicAvx2(num_components=K, device=dev)
        for t, frames in enumerate(batches):
            require(np.array_equal(slic.iterate(frames[f]),
                                   labels["stack"][t][f]),
                    "batch %d frame %d: labels differ from SlicAvx2" % (t, f))
        yxm = slic.slic_model.to_yxmrgb()
        require(np.array_equal(
            np.stack([st.y[f], st.x[f], st.num_members[f].astype(np.float32),
                      st.r[f], st.g[f], st.b[f]], 1).astype(np.float64),
            yxm), "frame %d: clusters differ from SlicAvx2" % f)
    for kw, bs, lab in zip(({"preemptive": True}, {"variant": "real_noq"}),
                           extra, extra_labels):
        ref = BatchedSlic(num_components=K, batch_mode="map", device=dev,
                          **kw)
        require(np.array_equal(ref.iterate(batches[0]).cpu().numpy(), lab)
                and states_equal(ref.state, bs.state),
                "stack %r differs from map mode" % (kw,))
    pair = batches[0][:2]
    gpu = BatchedSlic(num_components=K, batch_mode="stack", device=dev)
    cpu = BatchedSlic(num_components=K, batch_mode="stack", device="cpu")
    require(np.array_equal(gpu.iterate(pair).cpu().numpy(),
                           cpu.iterate(pair).numpy())
            and states_equal(gpu.state, cpu.state),
            "stack batch of two differs from the plain path")
    log("batch: stack == map == SlicAvx2 on %d batches of %d frames; "
        "preemptive and real_noq stacks == map; B=2 stack == plain path"
        % (len(batches), B))
    return counts


def golden_phase(dev):
    from fast_slic_tpu_torch import cluster as cl, runner
    from fast_slic_tpu_torch.config import RuntimeParams, StaticConfig

    g = np.load(GOLDEN)
    image = g["image"]
    H, W = image.shape[:2]
    for name, (K, flags, over) in GOLDEN_CASES.items():
        cfg = StaticConfig(H=H, W=W, K=K, **flags)
        params = RuntimeParams(compactness=10.0, min_size_factor=0.1,
                               subsample_stride=3, max_iter=10)
        for k, v in over.items():
            setattr(params, k, v)
        res = runner.run_iterate(cfg, image, cl.initialize_clusters(image, K),
                                 params, dev)
        agree = float((res.labels.astype(np.int64) == g[name]).mean())
        ref = g[name + "_clusters"]
        st = res.clusters
        log("golden %s: agreement %r, tie escalation %s"
            % (name, agree, res.cca_tie))
        if flags.get("variant") == "lsc":
            require(agree >= 0.999, "golden %s: agreement %r" % (name, agree))
            continue
        require(agree == 1.0, "golden %s: agreement %r" % (name, agree))
        require(np.array_equal(st.y, ref[:, 0])
                and np.array_equal(st.x, ref[:, 1])
                and np.array_equal(st.num_members.astype(np.float32),
                                   ref[:, 5]),
                "golden %s: cluster y/x/num_members differ" % name)


def profile_phase(name: str, warm, run, frames: int = 1):
    """torch.profiler over ``run()`` after ``warm()``: device time by
    kernel and the device's busy share of the wall time (per frame when
    ``run`` covers several)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    warm()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for e in prof.key_averages():
        # device-side events only (kernels, copies, memsets); the host ops
        # that launched them carry the same time again
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            rows.append((us, e.count, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    require(busy > 0, "the profiler saw no device time")
    log("profile %s: wall %.1f us, device busy %.1f us (%.1f%%), idle "
        "%.1f%%, %d device launches (kernels, copies, memsets); per frame "
        "(%d): wall %.1f us, busy %.1f us"
        % (name, wall_us, busy, 100 * busy / wall_us,
           100 - 100 * busy / wall_us, sum(r[1] for r in rows), frames,
           wall_us / frames, busy / frames))
    for i, (us, count, key) in enumerate(rows):
        if i < 20 or any(k in key for k in PROFILE_ALWAYS):
            log("profile %s: %10.1f us %5d x %8.1f us  %s"
                % (name, us, count, us / count, key[:90]))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import fast_slic_tpu_torch  # noqa: F401  (fails outside the repository)
    from fast_slic_tpu_torch.kernels import KERNELS, _lib

    require("jax" not in sys.modules, "the port imported jax")
    dev = torch.device("cuda")
    log("torch %s, CUDA %s" % (torch.__version__, torch.version.cuda))
    log(gpu_line())  # name, power limit: as nvidia-smi prints them

    secs = _lib.build(force=True)
    _lib.library()
    log("build: nvcc %.1f s -> %s" % (secs, _lib.LIB_PATH))

    frames = make_frames(4, H720, W720)
    more = make_frames(2 * BATCH, H720, W720, seed=1)
    batches = [np.stack(more[:BATCH]), np.stack(more[BATCH:])]
    res = Results()
    fseg = kernel_phase(dev, frames[0], K720, res)
    frame_kernel_phase(dev, list(batches[0]), K720, res, fseg)
    res.log()

    counts = {}
    counts["standard"], ms, dev_ms, ties, report = slice_phase(dev, frames,
                                                               K720)
    log("slice: ms per frame, CUDA events over iterate: %s"
        % ", ".join("%.3f" % m for m in dev_ms))
    log("slice: ms per frame, host clock around SlicAvx2.iterate: %s"
        % ", ".join("%.3f" % m for m in ms))
    log("slice: tie escalation per frame: %s" % ties)
    log("slice: last frame phases (CUDA events, us) " + report)

    from fast_slic_tpu_torch import (LSCAvx2, SlicAvx2, SlicRealDist,
                                     SlicRealDistL2, SlicRealDistNoQ)
    counts["float"] = compare_phase(
        dev, [(LSCAvx2, frames[:2])] + [
            (cls, frames[:1])
            for cls in (SlicRealDist, SlicRealDistL2, SlicRealDistNoQ)],
        K720, "float")
    counts["preemptive"] = compare_phase(
        dev, [(SlicAvx2, frames), (LSCAvx2, frames[:1])], K720, "preemptive",
        preemptive=True)
    counts["batch"] = batch_phase(dev, batches, K720)
    for path, need in (("standard", STANDARD_PATH), ("float", FLOAT_PATH),
                       ("preemptive", PREEMPTIVE_PATH),
                       ("batch", BATCH_PATH)):
        log("slice: %s path launches %s" % (path, json.dumps(counts[path])))
        missing = [k for k in need if counts[path][k] <= 0]
        require(not missing, "kernels never launched on the %s path: %s"
                % (path, missing))
    log("slice: lookup launches per standard-path frame %r"
        % (counts["standard"]["lookup"] / len(frames)))

    golden_phase(dev)
    if "--profile" in sys.argv[1:]:
        from fast_slic_tpu_torch.parallel.batch import BatchedSlic
        for name, cls, kw in (("SlicAvx2", SlicAvx2, {}),
                              ("LSCAvx2", LSCAvx2, {}),
                              ("SlicAvx2 preemptive", SlicAvx2,
                               {"preemptive": True})):
            slic = cls(num_components=K720, device=dev, **kw)
            profile_phase(name, lambda: slic.iterate(frames[0]),
                          lambda: slic.iterate(frames[1]))
        bs = BatchedSlic(num_components=K720, batch_mode="stack", device=dev)
        profile_phase("BatchedSlic stack B=%d" % BATCH,
                      lambda: bs.iterate(batches[0]),
                      lambda: bs.iterate(batches[1]), frames=BATCH)
    require("jax" not in sys.modules, "the port imported jax")

    rows = []
    for k in KERNELS:
        r = dict(res.rows[k.name])
        rows.append({"name": k.name, "route": k.route, "source": k.source,
                     "replaces": k.replaces,
                     "launches": counts[COUNTED_ON[k.name]][k.name], **r})
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
