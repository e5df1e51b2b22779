#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths once on one NVIDIA GPU and check
them: the standard main path, the float-distance path (the real variants
and LSC), the preemptive grid, batched frames (BatchedSlic), the CRF
refinement (the graph utilities and SimpleCRF) and the rest of the public
API (the debug recorder, profile=True and enforce_connectivity) and the
device mesh (one image's rows over four shards of the card, a batch over a
mesh's data axis).

    python3 chip_smoke.py            # from the repository root, on a GPU
    python3 chip_smoke.py --profile  # also: torch.profiler over one frame
                                     # of the standard, the LSC and the
                                     # preemptive path, one stacked
                                     # batch of four frames, one frame's
                                     # CRF graphs, one CRF cycle and one
                                     # 4K frame of SlicAvx2 and of
                                     # ShardedSlicExplicit over 4 shards

Phases (any failure exits non-zero; no phase's error is caught):

1. the card: torch.cuda.is_available(), name and power limit (nvidia-smi);
2. build: the CUDA kernels of fast_slic_tpu_torch/csrc, compiled by nvcc;
3. kernels: each kernel against its plain PyTorch version, both on the
   card, at the paths' shapes (1280x720, K=1600, S=24, 16 candidate slots;
   assign, float assign (each variant) and update at stride 3 with each
   remainder and stride 1; CCA on a real raw assignment of the frame (the
   selection and orphan chase, cca_select, on its component tables); the
   LSC features and the f32 segment sum on an LSC state of the frame; on
   four stacked frames after nine preemptive iterations, where some cells
   are inactive: assign, float assign and update with the frame axis (and
   the LSC float assign on the four frames' LSC states stacked), the
   masked update with that pixel mask at B=4 and B=1, and the components,
   the per-frame segment sum and the selection (on [4, n] views, a
   component count a frame) on the four frames' stacked CCA map; the
   f32 segment sum again under frame 0's preemptive mask; the region
   minimum per pixel (propagate_min) and per region (region_table) on
   frame 0's raw assignment with pixel-id, leader-rank and
   _BIG-but-at-leaders seeds (and, in the mesh phase, at the mesh path's
   own slabs and seeds, with the seam step seam_min); the KNN on the
   clusters of the JAX package's first 720p frame at m = 4, 1, 8 and 60,
   and its bucketing by cell);
   bit-exact (the f32 segment sum against its plain version on the CPU,
   whose order of addition it keeps; on the card index_add_ adds with
   float atomics; the KNN against its host loop), with times, the host
   time of a lookup, selection, f32 segment-sum and KNN call, each kernel's bound
   (the bytes it must move over 3.35 TB/s or its operations over 67
   TFLOP/s, the larger) and, where one PyTorch call computes the same
   function, that call's time;
4. slice, standard path: SlicAvx2(num_components=1600, device="cuda") on
   four 1280x720 frames made from tests/data/golden_ref.npz; labels and
   clusters equal the plain path (device="cpu") on the same frames and the
   JAX package's in tests/data/port_720p_ref.npz;
5. slice, float path: LSCAvx2 on two frames (labels agree >= 0.999 with the
   plain path, clusters within 1 of it or 1 %), SlicRealDist,
   SlicRealDistL2 and SlicRealDistNoQ on one frame each (labels and
   clusters equal the plain path); the plain path runs each frame from the
   device model's state before it;
6. slice, preemptive grid: SlicAvx2(preemptive=True) on the four frames
   and LSCAvx2(preemptive=True) on one, against the plain path as above;
7. batch: BatchedSlic(num_components=1600) on two batches of four frames
   in stack and in map mode (labels and clusters equal across stack, map
   and four SlicAvx2 models on the card; the stacked labels equal the JAX
   package's in tests/data/port_720p_ref.npz), one stacked batch of two frames
   against the plain path, and one stacked batch with preemptive=True and
   one with variant="real_noq" against map mode;
8. crf: SlicAvx2(num_components=1600) on the four frames, each frame's
   get_connectivity, get_knn_connectivity(labels, 4), the density of a
   seeded mask and its broadcast, and the frame pushed by push_slic_frame
   into a SimpleCRF(21, 1600) with the adjacency graph and into one with
   knn=4 (class probabilities as bench.py's config 5), then initialize();
   inference(5) on each; the graphs and densities equal the plain path's
   and the JAX package's (tests/data/port_crf_ref.npz), the posteriors are
   within rtol 2e-4, atol 1e-6 of the JAX package's with >= 0.999 of the
   argmax classes equal; ms of each call a frame and of a cycle (CUDA
   events and the host clock);
9. api: the launchers' skip of a pass with no rows (rem >= H) against
   the plain versions; debug_mode=True on SlicAvx2, LSCAvx2 and
   SlicAvx2(preemptive=True) on frame 0 (max_iter 10): every one of the
   11 snapshots (assignment, min_dists, clusters) equals the plain path's
   as arrays (LSC: assignments >= 0.999, >= 0.999 of min_dists within
   rtol 1e-4, clusters within 1 or 1 %), the labels equal the default
   run's (and for SlicAvx2 the JAX package's), SlicAvx2's report is
   rendered once (its bytes and render time logged); profile=True on
   SlicAvx2 and LSCAvx2 (labels equal the default run's, the sections
   summed); the standalone enforce_connectivity on frames 0-2's raw
   pre-CCA assignments at the pipeline's threshold (frames 1-2 tie)
   equals the frames' labels, the JAX package's and the plain path;
10. mesh: ShardedSlicExplicit(num_components=14400) over
   make_mesh(data=1, space=4, devices=[cuda:0] * 4) on two 3840x2160
   frames, labels and cluster state equal to SlicAvx2 carrying its own;
   at 1920x1080, K=1600 over the same four shards one frame each of the
   real, real_l2, real_noq and preemptive variants (equal to their
   single-device classes), LSC (agreement >= 0.99) and ShardedSlic;
   BatchedSlic over data=2, space=2 on the first batch in stack and map
   mode equal to no mesh (labels, state, tie flags); the JAX package's
   sharded classes (tests/data/port_mesh_ref.npz) on eight shards of the
   card; ms a frame (CUDA events and host clock), launches, tie
   escalations, seam-fixpoint rounds and bytes between shards for each
   sharded frame and its single-device run; and the path's own
   connected_components, seam_min, lookup and cca_select calls (the
   selection on tables of fewer bins than pixels) on one 4K frame (slabs
   of 540x3840) and one 1080p frame (270x1920), each held bit for bit
   against its plain version on the same inputs, the 4K run giving the
   JSON rows of seam_min (a seam row) and of region_table and
   propagate_min (a slab and its leader-rank seed), which the path no
   longer calls (launches 0);
11. golden: the seven standard and the three real-distance golden cases
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
# the JAX package's labels and clusters on this script's 720p frames and
# batches (scripts/make_port_fixture_720p.py)
FIXTURE = os.path.join(ROOT, "tests", "data", "port_720p_ref.npz")
BATCH = 4
# the crf phase: SimpleCRF(CRF_C, K720) over the four slice frames, with the
# adjacency graph and with knn=CRF_KNN, then initialize(); inference(CRF_ITERS)
CRF_C, CRF_KNN, CRF_ITERS = 21, 4, 5
# the JAX package's graphs, densities and posteriors on the slice frames
# (scripts/make_port_fixture_crf.py)
CRF_FIXTURE = os.path.join(ROOT, "tests", "data", "port_crf_ref.npz")
# the mesh phase: 4K over four shards of the card (S=24, as at 720p: 540
# rows a slab), and BASELINE.md's 1080p for the variants (270 rows a slab)
H4K, W4K, K4K = 2160, 3840, 14400
H1080, W1080 = 1080, 1920
# the JAX package's sharded classes on 8 CPU shards
# (scripts/make_port_fixture_mesh.py)
MESH_FIXTURE = os.path.join(ROOT, "tests", "data", "port_mesh_ref.npz")

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
STANDARD_PATH = ("lab", "candidates", "assign", "slic_update", "segment_sum",
                 "connected_components", "lookup", "cca_select")
FLOAT_PATH = ("lab", "lsc_feat", "candidates", "assign_float", "slic_update",
              "fsegsum", "segment_sum", "connected_components", "lookup",
              "cca_select")
PREEMPTIVE_PATH = ("lab", "lsc_feat", "candidates", "assign", "assign_float",
                   "slic_update_masked", "fsegsum", "segment_sum",
                   "connected_components", "lookup", "cca_select")
BATCH_PATH = ("lab", "candidates", "assign", "assign_float", "slic_update",
              "slic_update_masked", "framed_segment_sum",
              "connected_components", "lookup", "cca_select")
# the mesh path: four shards of one card at 4K (the standard variant), and
# at 1080p each variant and the preemptive grid
MESH_PATH = ("lab", "candidates", "assign", "slic_update", "seam_min",
             "connected_components", "segment_sum", "lookup",
             "cca_select")
MESH_VARIANT_PATH = ("assign_float", "lsc_feat", "fsegsum",
                     "slic_update_masked", "seam_min")
# the CRF path: the standard path's kernels, then the graph utilities
CRF_PATH = STANDARD_PATH + ("knn", "knn_buckets")
# the api phase: debug and profiled frames of SlicAvx2, LSCAvx2 and the
# preemptive grid, and the standalone enforce_connectivity
API_PATH = ("lab", "candidates", "assign", "assign_float", "slic_update",
            "slic_update_masked", "segment_sum", "connected_components",
            "lookup", "cca_select", "lsc_feat", "fsegsum")
# device kernels of the redesigned calls and the once-a-frame kernels,
# printed in every profile
PROFILE_ALWAYS = ("lookup_kernel", "cca_select_kernel", "fs_rank",
                  "fs_scan", "fs_scatter", "fs_sum", "slic_update_kernel",
                  "lab_kernel", "lsc_feat_kernel", "assign_kernel",
                  "cc_local", "cc_seams", "cc_flatten", "assign_float_kernel",
                  "segment_sum_kernel", "knn_kernel", "knn_buckets_kernel",
                  "seam_min_kernel", "rt_init", "rt_scatter",
                  "candidates_kernel")
# the path whose run gives each kernel's launch count in the JSON line
COUNTED_ON = dict(
    [(k, "standard") for k in STANDARD_PATH]
    + [(k, "float") for k in ("lsc_feat", "assign_float", "fsegsum")]
    + [("slic_update_masked", "preemptive"), ("framed_segment_sum", "batch"),
       ("knn", "crf"), ("knn_buckets", "crf"), ("propagate_min", "mesh"),
       ("region_table", "mesh"), ("seam_min", "mesh")])


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


def crf_mask(t: int, H: int, W: int) -> np.ndarray:
    """The crf phase's seeded u8 mask of frame t: 16x16 blocks of random
    values."""
    rng = np.random.default_rng(100 + t)
    blocks = rng.integers(0, 256, size=(-(-H // 16), -(-W // 16)),
                          dtype=np.uint8)
    return np.kron(blocks, np.ones((16, 16), np.uint8))[:H, :W]


def crf_proba(t: int, C: int, N: int) -> np.ndarray:
    """Frame t's class probabilities [C, N] (bench.py's config 5)."""
    return np.ascontiguousarray(np.random.default_rng(t).dirichlet(
        np.ones(C), N).T.astype(np.float32))


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


def require_fixture(what, labels, ref):
    """Labels equal to the JAX package's (FIXTURE), their agreement
    logged."""
    agree = (float((labels == ref).mean()) if labels.shape == ref.shape
             else 0.0)
    log("%s: label agreement with the JAX package (%s) %r"
        % (what, os.path.basename(FIXTURE), agree))
    require(agree == 1.0, "%s: labels differ from the JAX package's" % what)


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


def update_library(a, planes, mask, K: int, stride: int, rem: int):
    """One PyTorch call computing the update sums of one frame: an int32
    ``index_add_`` of the counted pixels' [1, i, j, L, a, b] into [6, K],
    with the ids and values built here, outside the timed call."""
    import torch
    H, W = a.shape
    rows = torch.arange(rem, H, stride, device=a.device)
    ar = a[rows]
    ok = (ar != 0xFFFF) & (ar >= 0) & (ar < K)
    if mask is not None:
        ok &= mask[rows]
    ii = rows[:, None].expand(ar.shape).to(torch.int32)
    jj = torch.arange(W, device=a.device)[None, :].expand(ar.shape).to(
        torch.int32)
    ids = ar[ok].long()
    vals = torch.stack([torch.ones_like(ar), ii, jj, *planes[:, rows]])[:, ok]
    vals = vals.contiguous()
    return lambda: torch.zeros((6, K), dtype=torch.int32,
                               device=a.device).index_add_(1, ids, vals)


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
# the KNN's work a candidate: two subtractions, two absolutes, an add, the
# conversion and the compare with the heap's top
OPS_PER_KNN_VISIT = 7
# the bucketing's work a cluster: two conversions, two divisions, four
# clamps, the cell's multiply-add and the count
OPS_PER_KNN_BUCKET = 10


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


def candidates_check(st, cfg, res: Results, what: str, timed=None):
    """The candidate kernel against its plain version (torch ops on the
    card) on the state ``st`` (one frame's fields [K] or B frames' [B, K]):
    the lists and the flag equal, one launch with a running flag.  With
    ``timed``, both timed and the host µs of a build logged: "row" for the
    JSON line's row (the library call: the plain version's sort alone),
    "log" for the log alone.  Returns the kernel's lists."""
    import torch
    from fast_slic_tpu_torch import pipeline
    from fast_slic_tpu_torch.kernels import candidates, launch_counts
    y, x, act = (t if t.ndim == 2 else t[None]
                 for t in (st.y, st.x, st.is_active))
    B, K = y.shape
    GH, GW = pipeline.cell_grid_shape(cfg)
    C = cfg.cand_slots
    args = (y, x, act, cfg.S, GH, GW, C)
    flag = torch.zeros((), dtype=torch.bool, device=y.device)
    before = launch_counts()["candidates"]
    cand, ovf = candidates.candidates(*args, overflow=flag)
    require(ovf is flag and launch_counts()["candidates"] == before + 1,
            "candidates: not one launch into the running flag")
    ref, ref_ovf = candidates.plain(*args)
    res.check("candidates", max(max_abs_err(cand, ref),
                                max_abs_err(ovf, ref_ovf)))
    log("candidates %s: B=%d GH=%d GW=%d C=%d, overflow %s, %d filled slots"
        % (what, B, GH, GW, C, bool(ovf), int((cand >= 0).sum())))
    if timed:
        span = 4 * K
        comp = torch.randint(0, GH * GW * span, (B, 9 * K),
                             device=y.device)
        moved = nbytes(y, x, act, cand)
        fns = (lambda: candidates.candidates(*args, overflow=flag),
               lambda: candidates.plain(*args))
        if timed == "row":
            res.time("candidates", *fns, moved, 9 * B * K,
                     library_fn=lambda: torch.sort(comp, dim=1))
        else:
            log_times("candidates %s" % what, *fns, moved, 9 * B * K)
        log("host: candidates %s %.2f us a build, plain %.2f us (host clock "
            "over 200 builds)" % (what, host_us(fns[0], 200),
                                  host_us(fns[1], 200)))
    return cand if st.y.ndim == 2 else cand[0]


def candidates_lsc_1080p(dev, res: Results):
    """The candidate kernel against its plain version at 1080p LSC
    (K=1600; setup and three loop iterations of a 1080p frame), with 16 and
    4 slots."""
    import dataclasses
    import torch
    from fast_slic_tpu_torch import cluster as cl, pipeline
    from fast_slic_tpu_torch.config import StaticConfig
    frame = make_frames(1, H1080, W1080)[0]
    cfg = StaticConfig(H=H1080, W=W1080, K=K720, variant="lsc")
    scal = pipeline.derive_scalars(cfg, 10.0, 0.25)
    st = cl.initialize_clusters(frame, K720).to_torch(dev)
    planes, st, lsc = pipeline.stage_setup(torch.from_numpy(frame).to(dev),
                                           st, cfg, scal)
    st, _, _, _ = pipeline.stage_loop(planes, st, lsc, cfg, scal, 3, 3)
    st = pipeline._clamp_centers(st, cfg)
    for slots in (16, 4):
        candidates_check(st, dataclasses.replace(cfg, cand_slots=slots), res,
                         "1080p LSC K=%d, %d slots" % (K720, slots),
                         timed="log" if slots == 16 else None)


def kernel_phase(dev, frame, K: int, res: Results):
    """Each kernel of the standard and float paths vs its plain version on
    ``dev`` at the frame's shapes."""
    import torch
    from fast_slic_tpu_torch import cluster as cl, pipeline
    from fast_slic_tpu_torch.config import StaticConfig, UNASSIGNED
    from fast_slic_tpu_torch.kernels import assign, cca, lab, segsum
    from fast_slic_tpu_torch.ops.cca import (cca_parts, leader_ranks,
                                             segsum_values)
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
    cand = candidates_check(st, cfg, res, "720p K=%d" % K, timed="row")
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
                     16 * P + 24 * K, 6 * P,
                     library_fn=update_library(a_k, planes, None, K, stride,
                                               rem))

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
    # the selection and orphan chase on this frame's component tables
    _, areas, target, _ = cca_parts(raw)
    thres = int(scal.thres)
    got = cca.cca_select(areas, target, ncomp, K, thres)
    want = cca.cca_select_plain(areas, target, ncomp, K, thres)
    res.check("cca_select", max(max_abs_err(got[0], want[0]),
                                max_abs_err(got[1], want[1])))
    nc = int(ncomp)
    res.time("cca_select", lambda: cca.cca_select(areas, target, ncomp, K,
                                                  thres),
             lambda: cca.cca_select_plain(areas, target, ncomp, K, thres),
             8 * nc + 4 * n, nc)
    log("kernel phase: %d of %d components dropped (orphans)"
        % (nc - min(K, int((areas[:nc] >= thres).sum())), nc))
    log("host: lookup %.2f us a call, cca_select %.2f us a call "
        "(host clock over 1000 calls)"
        % (host_us(lambda: cca.lookup(L, rank)),
           host_us(lambda: cca.cca_select(areas, target, ncomp, K, thres))))
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
    propagate_min_check(dev, raw, res)
    candidates_lsc_1080p(dev, res)
    return float_kernel_phase(dev, image, K, res)


def propagate_min_check(dev, raw, res: Results):
    """The region minimum per pixel (propagate_min) and per region
    (region_table) against their plain versions, bit for bit, on a raw
    assignment with the sharded CCA's seeds: pixel ids, leader ranks
    (every pixel's exclusive leader count) and _BIG except at the leaders;
    the kernels over the components kernel's roots, the plain versions
    over connected_components_plain's.  Their JSON rows are timed in the
    mesh phase, at the mesh path's slabs (cca_on_slabs)."""
    import torch
    from fast_slic_tpu_torch.kernels import cca
    from fast_slic_tpu_torch.ops.cca import leader_ranks

    H, W = raw.shape
    n = H * W
    roots = cca.connected_components(raw)
    plain_roots = cca.connected_components_plain(raw)
    is_leader, rank, _ = leader_ranks(roots.reshape(-1))
    seeds = {"pixel ids": torch.arange(n, dtype=torch.int32, device=dev),
             "leader ranks": rank,
             "_BIG but at leaders": torch.where(is_leader, rank, 0x7FFFFFFF)}
    for what, m0 in seeds.items():
        m0 = m0.reshape(H, W).contiguous()
        want = cca.propagate_min_plain(m0, plain_roots)
        res.check("propagate_min", max_abs_err(cca.propagate_min(m0, roots),
                                               want))
        res.check("region_table", max_abs_err(
            cca.region_table(m0, roots),
            cca.region_table_plain(m0, plain_roots)))
        log("kernel phase: propagate_min and region_table with the %s seed "
            "equal their plain versions (%d distinct minima)"
            % (what, int(torch.unique(want).numel())))
    m0 = rank.reshape(H, W).contiguous()
    log_times("propagate_min %dx%d" % (W, H),
              lambda: cca.propagate_min(m0, roots),
              lambda: cca.propagate_min_plain(m0, roots), 12 * n, 2 * n)
    log_times("region_table %dx%d" % (W, H),
              lambda: cca.region_table(m0, roots),
              lambda: cca.region_table_plain(m0, roots), 12 * n, n)


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
    assign (real, real_l2, real_noq; lsc on the frames' own mid-loop LSC
    states, stacked) and update over the B frames, the
    masked update at B=4 and B=1, each at stride 3 with each remainder and
    at stride 1, the components on the frames' stacked CCA map, the
    per-frame segment sum on their CCA values and the selection on its
    [B, n] tables; and the f32 segment sum
    ``fseg`` (ids, mask, vals of the LSC state) again with frame 0's
    preemptive mask."""
    import torch
    from fast_slic_tpu_torch import cluster as cl, pipeline
    from fast_slic_tpu_torch.config import StaticConfig, UNASSIGNED
    from fast_slic_tpu_torch.kernels import assign, assign_float, cca, segsum
    from fast_slic_tpu_torch.ops.cca import (framed_cca_parts,
                                             framed_components, framed_labels,
                                             segsum_values)

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
    cand = candidates_check(st, cfg, res, "720p K=%d B=%d, preemptive"
                            % (K, B), timed="log")
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
                res.time("slic_update_masked", *timed,
                         library_fn=update_library(*args, K, stride, rem))
            else:
                log_times("slic_update_masked B=%d at stride %d"
                          % (nb, stride), *timed)

    # the LSC float assign with the frame axis: each frame's mid-loop LSC
    # state (setup and three loop iterations), stacked
    lcfg = StaticConfig(H=H, W=W, K=K, variant="lsc")
    lscal = pipeline.derive_scalars(lcfg, 10.0, 0.25)
    parts = []
    for f in frames:
        lst = cl.initialize_clusters(f, K).to_torch(dev)
        lp, lst, lsc = pipeline.stage_setup(torch.from_numpy(f).to(dev), lst,
                                            lcfg, lscal)
        lst, la, lcent, _ = pipeline.stage_loop(lp, lst, lsc, lcfg, lscal, 3,
                                                3)
        lst = pipeline._clamp_centers(lst, lcfg)
        lcand, _ = pipeline.build_candidates(lst.y, lst.x, lst.is_active,
                                             lcfg)
        parts.append((lp, pipeline.center_table(lst), lcand, la, lsc[0],
                      lcent))
    lp, ltable, lcand, la, lfeats, lcent = (
        torch.stack(xs, d) for xs, d in zip(zip(*parts), (1, 0, 0, 0, 1, 0)))
    for stride, rem in ((3, 0), (3, 1), (3, 2), (1, 0)):
        outs = []
        for fn in (assign_float.assign_float, assign_float.plain):
            a = la.clone()
            md = torch.full(a.shape, assign_float.F32_MAX, device=dev)
            fn(lp, ltable, lcand, a, lscal.coef, lcfg.S, stride, rem, "lsc",
               True, md, lfeats, lcent)
            outs.append((a, md))
        res.check("assign_float", max(max_abs_err(outs[0][0], outs[1][0]),
                                      max_abs_err(outs[0][1], outs[1][1])))
        if rem == 0:
            a_l = outs[0][0]
            P = len(range(rem, H, stride)) * W
            log_times("assign_float lsc B=%d at stride %d" % (B, stride),
                      lambda: assign_float.assign_float(
                          lp, ltable, lcand, a_l, lscal.coef, lcfg.S, stride,
                          rem, "lsc", True, None, lfeats, lcent),
                      lambda: assign_float.plain(
                          lp, ltable, lcand, a_l, lscal.coef, lcfg.S, stride,
                          rem, "lsc", True, None, lfeats, lcent),
                      44 * B * P + nbytes(lcand, ltable, lcent),
                      OPS_PER_VISIT["lsc"]
                      * cand_visits(lcand, H, W, lcfg.S, stride, rem))

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

    # a raw assignment of the four frames (a full assign with every cluster
    # active): the components on the stacked [B*H, W] map that
    # framed_components builds from it, then the per-frame segment sum on
    # its CCA values
    st = st.replace(is_active=torch.ones_like(st.is_active))
    _, raw, _, _ = pipeline.stage_full_assign(planes, st, no_lsc, None,
                                              a0.clone(), cfg, scal)
    stacked = framed_labels(raw, K)
    res.check("connected_components", max_abs_err(
        cca.connected_components(stacked),
        cca.connected_components_plain(stacked)))
    log_times("connected_components B=%d on the stacked [%d, %d] map"
              % (B, B * H, W), lambda: cca.connected_components(stacked),
              lambda: cca.connected_components_plain(stacked), 8 * B * n,
              10 * B * n)
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
    # the selection on the four frames' tables as the stacked path gives
    # them: [B, n] views with a frame stride of two tables, a component
    # count a frame read on the device
    _, areas, target, ncomp = framed_cca_parts(raw, K)
    thres = int(scal.thres)
    got = cca.cca_select(areas, target, ncomp, K, thres)
    want = cca.cca_select_plain(areas, target, ncomp, K, thres)
    res.check("cca_select", max(max_abs_err(got[0], want[0]),
                                max_abs_err(got[1], want[1])))
    log("frame kernel phase: cca_select B=%d on [%d, %d] views of frame "
        "stride %d, components %s, tie flags %s"
        % (B, B, n, areas.stride(0), ncomp.tolist(), got[1].tolist()))


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
    fixture = np.load(FIXTURE)
    for i, (labels, yxmrgb) in enumerate(results):
        require_fixture("slice frame %d" % (i + 1), labels,
                        fixture["slice_labels"][i])
        require(np.array_equal(yxmrgb.astype(np.float32),
                               fixture["slice_clusters"][i]),
                "frame %d: clusters differ from the JAX package's" % i)
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
    labels, ev_ms, host_ms = timed_call(lambda: bs.iterate(frames))
    return labels.cpu().numpy(), ev_ms, host_ms, int(bs.last_flags.sum())


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
    fixture = np.load(FIXTURE)
    for t in range(len(batches)):
        require_fixture("batch stack %d" % (t + 1), labels["stack"][t],
                        fixture["batch_labels"][t])
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


def knn_visits(ys, xs, H: int, W: int) -> int:
    """Candidates the KNN walks for these centres: the clusters in each
    query's half-open 6x6-cell window, itself excluded."""
    from fast_slic_tpu_torch.kernels.knn import grid
    K = ys.shape[0]
    S, nh, nw = grid(H, W, K)
    cy, cx = ys.astype(np.int32) // S, xs.astype(np.int32) // S
    pop = np.zeros((nh, nw), np.int64)
    np.add.at(pop, (np.clip(cy, 0, nh - 1), np.clip(cx, 0, nw - 1)), 1)
    csum = np.zeros((nh + 1, nw + 1), np.int64)
    csum[1:, 1:] = pop.cumsum(0).cumsum(1)
    y0, y1 = np.maximum(cy - 3, 0), np.minimum(cy + 3, nh)
    x0, x1 = np.maximum(cx - 3, 0), np.minimum(cx + 3, nw)
    win = csum[y1, x1] - csum[y0, x1] - csum[y1, x0] + csum[y0, x0]
    return int(win.sum()) - K


def knn_kernel_phase(dev, res: Results):
    """The KNN kernels against their plain versions on the clusters of the
    JAX package's first 720p frame (FIXTURE): the bucketing against its
    torch ops on the card, the walk against its host loop at the crf
    phase's m and at 1, 8 and 60 (more than a window holds)."""
    import torch
    from fast_slic_tpu_torch.kernels import knn

    yxm = np.load(FIXTURE)["slice_clusters"][0]
    ys = torch.from_numpy(np.ascontiguousarray(yxm[:, 0])).to(dev)
    xs = torch.from_numpy(np.ascontiguousarray(yxm[:, 1])).to(dev)
    K = ys.shape[0]
    got = knn.knn_buckets(ys, xs, H720, W720)
    want = knn.knn_buckets_plain(ys, xs, H720, W720)
    res.check("knn_buckets", max(max_abs_err(got[0], want[0]),
                                 max_abs_err(got[1], want[1])))
    ncell = want[1].numel() - 1
    res.time("knn_buckets", lambda: knn.knn_buckets(ys, xs, H720, W720),
             lambda: knn.knn_buckets_plain(ys, xs, H720, W720),
             nbytes(ys, xs) + 4 * K + 4 * (ncell + 1),
             OPS_PER_KNN_BUCKET * K + ncell)
    for m in (CRF_KNN, 1, 8, 60):
        got = knn.knn(ys, xs, H720, W720, m)
        want = knn.knn_plain(ys.cpu(), xs.cpu(), H720, W720, m)
        res.check("knn", max(max_abs_err(got[0].cpu(), want[0]),
                             max_abs_err(got[1].cpu(), want[1])))
        log("kernel phase: knn m=%d: %d neighbours for %d clusters"
            % (m, int(want[1].sum()), K))
    visits = knn_visits(yxm[:, 0], yxm[:, 1], H720, W720)
    log("kernel phase: knn walks %d candidates at 720p K=%d, %d cells"
        % (visits, K, ncell))
    res.time("knn", lambda: knn.knn(ys, xs, H720, W720, CRF_KNN),
             lambda: knn.knn_plain(ys.cpu(), xs.cpu(), H720, W720, CRF_KNN),
             nbytes(ys, xs) + 4 * K * (CRF_KNN + 1),
             OPS_PER_KNN_VISIT * visits, reps=50, plain_reps=2)
    log("host: knn %.2f us a call, knn_buckets %.2f us a call (host clock "
        "over 1000 calls)"
        % (host_us(lambda: knn.knn(ys, xs, H720, W720, CRF_KNN)),
           host_us(lambda: knn.knn_buckets(ys, xs, H720, W720))))


def timed_call(fn):
    """fn() with its CUDA-event ms and host-clock ms; both end when the
    device has finished."""
    import torch
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop), (time.perf_counter() - t0) * 1e3


def crf_phase(dev, frames, K: int):
    """The CRF path: SlicAvx2 over the frames on ``dev``, each frame's
    adjacency and KNN graphs, the density of a seeded mask and its
    broadcast, and the frame pushed into two SimpleCRF(CRF_C, K) (the
    adjacency graph; knn=CRF_KNN), then initialize(); inference(CRF_ITERS)
    on each.  The graphs and densities equal the plain path's and the JAX
    package's (CRF_FIXTURE); the posteriors are within rtol 2e-4, atol
    1e-6 of the JAX package's, with >= 0.999 of the argmax classes equal.
    Returns the launch counts of the path."""
    import torch
    from fast_slic_tpu_torch import SimpleCRF, SlicAvx2
    from fast_slic_tpu_torch.kernels import launch_counts, reset_launches
    from fast_slic_tpu_torch.ops import graph

    H, W = frames[0].shape[:2]
    times = {k: ([], []) for k in ("get_connectivity", "get_knn_connectivity",
                                   "push_slic_frame adjacency",
                                   "push_slic_frame knn")}

    def timed(what, fn):
        out, ev_ms, host_ms = timed_call(fn)
        times[what][0].append(ev_ms)
        times[what][1].append(host_ms)
        return out

    reset_launches()
    slic = SlicAvx2(num_components=K, device=dev)
    crfs = {"adjacency": SimpleCRF(CRF_C, K, device=dev),
            "knn": SimpleCRF(CRF_C, K, device=dev)}
    frame_out = []
    for t, f in enumerate(frames):
        labels = slic.iterate(f)
        model = slic.slic_model
        adj = timed("get_connectivity", lambda: model.get_connectivity(labels))
        kn = timed("get_knn_connectivity",
                   lambda: model.get_knn_connectivity(labels, CRF_KNN))
        dens = model.get_mask_density(crf_mask(t, H, W), labels)
        back = model.broadcast_density_to_mask(dens, labels)
        for name, crf in crfs.items():
            fr = timed("push_slic_frame " + name, lambda: crf.push_slic_frame(
                slic, knn=CRF_KNN if name == "knn" else None))
            fr.set_proba(crf_proba(t, CRF_C, K))
        frame_out.append((labels, model._clusters.copy(), adj.matrix(),
                          kn.matrix(), dens, back))
    cycles = {}
    for name, crf in crfs.items():
        # the first cycle stages the graph and unaries; the second is steady
        cycles[name] = [timed_call(lambda: (crf.initialize(),
                                            crf.inference(CRF_ITERS)))[1:]
                        for _ in range(2)]
    stacks = {name: crf.inferred_stack() for name, crf in crfs.items()}
    counts = launch_counts()

    for what, (ev, host) in times.items():
        log("crf: %s ms a frame, CUDA events: %s; host clock: %s"
            % (what, ", ".join("%.3f" % x for x in ev),
               ", ".join("%.3f" % x for x in host)))
    for name, cyc in cycles.items():
        log("crf: %s initialize(); inference(%d) at T=%d, C=%d, N=%d: "
            "first %.3f ms (CUDA events), %.3f ms (host clock); steady "
            "%.3f ms, %.3f ms" % (name, CRF_ITERS, len(frames), CRF_C, K,
                                  cyc[0][0], cyc[0][1], cyc[1][0],
                                  cyc[1][1]))

    fixture = np.load(FIXTURE)
    ref = np.load(CRF_FIXTURE)
    for t, (labels, st, adj, kn, dens, back) in enumerate(frame_out):
        require_fixture("crf frame %d" % (t + 1), labels,
                        fixture["slice_labels"][t])
        for what, (nbr, lens), plain, key in (
                ("adjacency", adj, graph.adjacency_matrix(labels, K, "cpu"),
                 "adj"),
                ("knn", kn, graph.knn(st, CRF_KNN, (H, W), "cpu"), "knn")):
            require(np.array_equal(nbr, plain[0])
                    and np.array_equal(lens, plain[1]),
                    "crf frame %d: %s differs from the plain path"
                    % (t, what))
            require(np.array_equal(lens, ref[key + "_lens"][t])
                    and np.array_equal(nbr,
                                       ref[key + "_nbr"][t][:, :nbr.shape[1]])
                    and (ref[key + "_nbr"][t][:, nbr.shape[1]:] == -1).all(),
                    "crf frame %d: %s differs from the JAX package's"
                    % (t, what))
        mask = crf_mask(t, H, W)
        require(np.array_equal(dens, graph.mask_density(mask, labels, st,
                                                         "cpu"))
                and np.array_equal(back, graph.density_to_mask(dens, labels,
                                                               K, "cpu")),
                "crf frame %d: densities differ from the plain path" % t)
        require(np.array_equal(dens, ref["density"][t])
                and np.array_equal(back, ref["density_mask"][t]),
                "crf frame %d: densities differ from the JAX package's" % t)
        log("crf frame %d: adjacency (%d edges, longest list %d), knn (%d "
            "neighbours) and densities equal the plain path and the JAX "
            "package" % (t + 1, int(adj[1].sum()) // 2, int(adj[1].max()),
                         int(kn[1].sum())))
    for name, stack in stacks.items():
        require(isinstance(stack, torch.Tensor)
                and stack.device.type == torch.device(dev).type,
                "crf %s: the posteriors left the device" % name)
        got = stack.cpu().numpy()
        want = ref["q_adj" if name == "adjacency" else "q_knn"]
        require(got.shape == want.shape and np.isfinite(got).all(),
                "crf %s: posteriors %s" % (name, got.shape))
        # the share of the tolerance used: <= 1 is within rtol 2e-4, atol 1e-6
        share = float((np.abs(got - want) / (1e-6 + 2e-4 * np.abs(want))
                       ).max())
        agree = float((got.argmax(1) == want.argmax(1)).mean())
        log("crf %s: posteriors vs the JAX package: max abs err %r, share "
            "of the tolerance %r, argmax agreement %r"
            % (name, float(np.abs(got - want).max()), share, agree))
        require(share <= 1.0 and agree >= 0.999,
                "crf %s: posteriors differ from the JAX package's" % name)
    return counts


def short_rows_check(dev):
    """The launchers' skip of a pass with no rows (rem >= H: a 1-row image
    at stride 3, remainders 1 and 2; a 4-row image at stride 7, remainder
    5): assign, float assign, update and masked update equal their plain
    versions, the assignment and min_dists stay as they were and the sums
    are zero.  Run before the api phase's counts are reset."""
    import torch
    from fast_slic_tpu_torch import cluster as cl, pipeline
    from fast_slic_tpu_torch.config import StaticConfig, UNASSIGNED
    from fast_slic_tpu_torch.kernels import assign, assign_float, segsum

    rng = np.random.default_rng(7)
    for H, stride, rem in ((1, 3, 1), (1, 3, 2), (4, 7, 5)):
        W, K = 61, 5
        image = rng.integers(0, 256, size=(H, W, 3)).astype(np.uint8)
        cfg = StaticConfig(H=H, W=W, K=K, variant="real")
        scal = pipeline.derive_scalars(cfg, 10.0, 0.25)
        planes, st, _ = pipeline.stage_setup(
            torch.from_numpy(image).to(dev),
            cl.initialize_clusters(image, K).to_torch(dev), cfg, scal)
        cand, _ = pipeline.build_candidates(st.y, st.x, st.is_active, cfg)
        table = pipeline.center_table(st)
        old = torch.from_numpy(rng.integers(0, K, size=(H, W)).astype(
            np.int32)).to(dev)
        mask = torch.from_numpy(rng.random((H, W)) < 0.7).to(dev)
        for fill, fns in ((UNASSIGNED, (assign.assign, assign.plain)),
                          (-1.0, (assign_float.assign_float,
                                  assign_float.plain))):
            outs = []
            for fn in fns:
                a = old.clone()
                md = torch.full((H, W), fill, device=dev,
                                dtype=torch.int32 if fill == UNASSIGNED
                                else torch.float32)
                args = (() if fn in (assign.assign, assign.plain)
                        else ("real",))
                fn(planes, table, cand, a, scal.coef, cfg.S, stride, rem,
                   *args, True, md)
                outs.append((a, md))
            require(all(torch.equal(x, y) for x, y in zip(*outs))
                    and torch.equal(outs[0][0], old)
                    and bool((outs[0][1] == fill).all()),
                    "%s at H=%d stride %d rem %d: the skipped pass changed "
                    "its outputs" % (fns[0].__name__, H, stride, rem))
        for got, want in (
                (segsum.slic_update(old, planes, K, stride, rem),
                 segsum.slic_update_plain(old, planes, K, stride, rem)),
                (segsum.slic_update_masked(old, planes, mask, K, stride,
                                           rem),
                 segsum.slic_update_masked_plain(old, planes, mask, K,
                                                 stride, rem))):
            require(torch.equal(got, want) and not bool(got.any()),
                    "update at H=%d stride %d rem %d: sums not zero"
                    % (H, stride, rem))
    log("api: the launchers' rem >= H skip leaves assign, float assign, "
        "update and masked update equal to their plain versions (H=1 "
        "stride 3 rem 1, 2; H=4 stride 7 rem 5)")


def snapshots_equal(tag, got, ref, lsc=False):
    """Two runs' recorder snapshots (utils.recorder.Snapshots) compared as
    arrays: equal, or for LSC each snapshot's assignment agreeing >= 0.999,
    >= 0.999 of its min_dists within rtol 1e-4, atol 1e-6 and its clusters
    within 1 or 1 %."""
    require(got.iterations == ref.iterations,
            "%s: snapshot iterations %s vs %s" % (tag, got.iterations,
                                                 ref.iterations))
    worst = []
    for t, it in enumerate(got.iterations):
        a, b = got.assignments[t], ref.assignments[t]
        d, e = got.min_dists[t], ref.min_dists[t]
        require(a.shape == b.shape and d.dtype == e.dtype,
                "%s iteration %d: shapes or dtypes differ" % (tag, it))
        fields = list(zip(got.clusters[t].fields(),
                          ref.clusters[t].fields()))
        if not lsc:
            require(np.array_equal(a, b) and np.array_equal(d, e)
                    and all(np.array_equal(x, y) for x, y in fields),
                    "%s iteration %d: snapshot differs from the plain path"
                    % (tag, it))
            continue
        agree = float((a == b).mean())
        close = float(np.isclose(d, e, rtol=1e-4, atol=1e-6).mean())
        far = sum(int((~np.isclose(x.astype(np.float64),
                                   y.astype(np.float64), rtol=0.01,
                                   atol=1.0)).sum()) for x, y in fields)
        worst.append((agree, close, far))
        require(agree >= 0.999 and close >= 0.999 and far == 0,
                "%s iteration %d: assignment agreement %r, min_dists close "
                "%r, cluster values beyond 1 or 1 %% %d"
                % (tag, it, agree, close, far))
    if lsc:
        log("api %s: lowest assignment agreement %r, lowest min_dists share "
            "within rtol 1e-4 %r, cluster values beyond 1 or 1 %%: %d"
            % (tag, min(w[0] for w in worst), min(w[1] for w in worst),
               max(w[2] for w in worst)))


def section_sums(report: str):
    """The execute section's children of a timing report: (per-name sums
    in us, per-name lists of durations)."""
    rep = json.loads(report)
    exe = [c for c in rep["children"] if c["name"] == "execute"][0]
    sums, lists = {}, {}
    for c in exe["children"]:
        require(isinstance(c.get("duration"), int),
                "section %s has no integer duration" % c["name"])
        sums[c["name"]] = sums.get(c["name"], 0) + c["duration"]
        lists.setdefault(c["name"], []).append(c["duration"])
    return sums, lists


def api_phase(dev, frames, K: int):
    """The rest of the public API on ``dev`` (phase 9): debug_mode on
    SlicAvx2, LSCAvx2 and SlicAvx2(preemptive=True) on frame 0 (every
    snapshot against the plain path's; the labels against the default
    run's and, for SlicAvx2, the JAX package's; SlicAvx2's report rendered
    once), profile=True on SlicAvx2 and LSCAvx2 (labels against the
    default run's, sections summed), and the standalone
    enforce_connectivity on frames 0-2's raw pre-CCA assignments (against
    the frames' labels, the JAX package's and the plain path).  Returns
    the launch counts of the device runs."""
    import torch
    from fast_slic_tpu_torch import (LSCAvx2, SlicAvx2, enforce_connectivity,
                                     pipeline)
    from fast_slic_tpu_torch import cluster as cl
    from fast_slic_tpu_torch.config import UNASSIGNED, StaticConfig
    from fast_slic_tpu_torch.kernels import launch_counts, reset_launches
    from fast_slic_tpu_torch.ops.cca import enforce_connectivity_flagged

    short_rows_check(dev)
    fixture = np.load(FIXTURE)
    frame = frames[0]
    runs = {}
    reset_launches()
    for name, cls, kw in (("SlicAvx2", SlicAvx2, {}),
                          ("LSCAvx2", LSCAvx2, {}),
                          ("SlicAvx2 preemptive", SlicAvx2,
                           {"preemptive": True})):
        default = cls(num_components=K, device=dev, **kw)
        ref, _, default_ms = timed_call(lambda: default.iterate(frame))
        dbg = cls(num_components=K, device=dev, debug_mode=True, **kw)
        labels, _, debug_ms = timed_call(lambda: dbg.iterate(frame))
        require(np.array_equal(labels, ref),
                "%s debug_mode: labels differ from the default run" % name)
        prof = None
        if not kw:
            prof = cls(num_components=K, device=dev, **kw)
            prof.slic_model.profile = True
            prof_labels, _, prof_ms = timed_call(lambda: prof.iterate(frame))
            require(np.array_equal(prof_labels, ref),
                    "%s profile=True: labels differ from the default run"
                    % name)
            prof = (prof.slic_model.last_timing_report, prof_ms)
        runs[name] = (cls, kw, labels, dbg.slic_model, prof, default_ms,
                      debug_ms)

    # the standalone enforce_connectivity on frames 0-2's raw assignments:
    # each frame's pre-CCA assignment from the state the model had before it
    slic = SlicAvx2(num_components=K, device=dev)
    cfg = StaticConfig(H=frame.shape[0], W=frame.shape[1], K=K)
    scal = pipeline.derive_scalars(cfg, 10.0, 0.25)
    thres = int(scal.thres)
    standalone = []
    for f in frames[:3]:
        model = slic.slic_model
        start = (model._clusters.copy() if model.initialized
                 else cl.initialize_clusters(f, K))
        labels = slic.iterate(f)
        raw = pipeline.iterate_graph(torch.from_numpy(f).to(dev),
                                     start.to_torch(dev), cfg, scal, 10,
                                     3).raw_assignment
        raw_np = raw.cpu().numpy()
        k_inferred = int(raw_np[raw_np != UNASSIGNED].max()) + 1
        _, tie = enforce_connectivity_flagged(raw, k_inferred, thres)
        got, _, host_ms = timed_call(
            lambda: enforce_connectivity(raw_np.copy(), thres, device=dev))
        standalone.append((labels, raw_np, k_inferred, bool(tie), got,
                           host_ms))
    counts = launch_counts()

    for name, (cls, kw, labels, model, prof, default_ms,
               debug_ms) in runs.items():
        lsc = cls is LSCAvx2
        plain = cls(num_components=K, device="cpu", debug_mode=True, **kw)
        t0 = time.perf_counter()
        plain.iterate(frame)
        plain_s = time.perf_counter() - t0
        snaps = model.last_recorder_snapshots
        snapshots_equal(name, snaps,
                        plain.slic_model.last_recorder_snapshots, lsc)
        copy_us = [c["duration"] for c in json.loads(
            model.last_timing_report)["children"] if c["name"] == "recorder"]
        log("api %s debug_mode (%dx%d, K=%d, max_iter 10): %d snapshots "
            "equal the plain path's%s (the plain path took %.1f s on the "
            "CPU); labels equal the default run's; host clock %.3f ms the "
            "debug frame, %.3f ms the default frame before it; snapshots' "
            "copy to the host %s us (CUDA events), %d bytes"
            % (name, frame.shape[1], frame.shape[0], K, len(snaps.iterations),
               " within the LSC contract" if lsc else "", plain_s, debug_ms,
               default_ms, copy_us,
               snaps.assignments.nbytes + snaps.min_dists.nbytes))
        if name == "SlicAvx2":
            require_fixture("api SlicAvx2 debug frame 1", labels,
                            fixture["slice_labels"][0])
            t0 = time.perf_counter()
            report = model.last_recorder_report
            render_s = time.perf_counter() - t0
            require(report.startswith('{"height": %d, "width": %d, '
                                      '"snapshots": [' % frame.shape[:2])
                    and report.count('"iteration": ') == len(snaps.iterations)
                    and report.endswith("]}]}"),
                    "SlicAvx2: the recorder report is malformed")
            log("api SlicAvx2 debug_mode: the recorder report rendered once "
                "in %.3f s on the host, %d bytes"
                % (render_s, len(report.encode())))
        if prof is not None:
            sums, lists = section_sums(prof[0])
            log("api %s profile=True: labels equal the default run's; host "
                "clock %.3f ms; section sums (us, CUDA events) %s"
                % (name, prof[1], json.dumps(sums)))
            for sec in ("assign", "update", "after_update"):
                if sec in lists:
                    log("api %s profile=True: %s a iteration (us) %s"
                        % (name, sec, lists[sec]))

    for t, (labels, raw_np, k_inferred, tie, got,
            host_ms) in enumerate(standalone):
        plain = enforce_connectivity(raw_np.copy(), thres, device="cpu")
        require(k_inferred == K, "frame %d: K inferred %d" % (t, k_inferred))
        require(got.dtype == raw_np.dtype and np.array_equal(got, plain),
                "frame %d: enforce_connectivity differs from the plain path"
                % t)
        require(np.array_equal(got, labels.astype(np.int32)),
                "frame %d: enforce_connectivity differs from the frame's "
                "labels" % t)
        require_fixture("api enforce_connectivity frame %d" % (t + 1),
                        got.astype(np.int16), fixture["slice_labels"][t])
        log("api enforce_connectivity frame %d (K inferred %d, threshold "
            "%d): %.3f ms host clock, top-K boundary tie %s; equals the "
            "frame's labels and the plain path"
            % (t + 1, k_inferred, thres, host_ms, tie))
    return counts


def mesh_frames(H: int, W: int, K: int, sharded, single, frames, tag: str):
    """``sharded`` (a ShardedSlicExplicit or ShardedSlic) and ``single``
    (its single-device class on the card) over the frames, each carrying its
    state: labels and the cluster state equal frame by frame (LSC: labels
    agree >= 0.99).  Logs ms a frame (CUDA events, host clock), launches
    a frame, tie escalations, seam-fixpoint rounds and bytes copied
    between shards.  Returns the sharded run's launch counts."""
    from fast_slic_tpu_torch.kernels import launch_counts, reset_launches
    lsc = sharded.variant == "lsc"
    rows = []
    reset_launches()
    for f in frames:
        moved = sharded.mesh.bytes_moved
        before = sum(launch_counts().values())
        lab, ev_ms, host_ms = timed_call(lambda: sharded.iterate(f))
        rows.append((lab, sharded.state, ev_ms, host_ms,
                     "%s, %d re-runs" % (sharded.last_tie,
                                         sharded.last_reruns),
                     list(sharded.last_seam_rounds),
                     sum(launch_counts().values()) - before,
                     sharded.mesh.bytes_moved - moved))
    counts = launch_counts()
    for t, (f, (lab, st, ev_ms, host_ms, tie, rounds, launches,
                moved)) in enumerate(zip(frames, rows)):
        before = sum(launch_counts().values())
        ref, ref_ev, ref_host = timed_call(lambda: single.iterate(f))
        ref_launches = sum(launch_counts().values()) - before
        agree = float((lab == ref).mean())
        log("mesh %s %dx%d K=%d frame %d: sharded %.3f ms (CUDA events), "
            "%.3f ms (host clock), %d kernel launches, tie escalation %s, "
            "seam rounds %s, %d bytes between shards; single device %.3f "
            "ms, %.3f ms, %d kernel launches, tie escalation %s; label "
            "agreement %r"
            % (tag, W, H, K, t + 1, ev_ms, host_ms, launches, tie, rounds,
               moved, ref_ev, ref_host, ref_launches,
               single.slic_model.last_cca_tie, agree))
        require(lab.shape == (H, W) and lab.dtype == np.int16
                and lab.min() >= 0 and lab.max() < K,
                "mesh %s frame %d: labels shape or range" % (tag, t))
        if lsc:
            require(agree >= 0.99, "mesh %s frame %d: LSC agreement %r"
                    % (tag, t, agree))
            continue
        require(agree == 1.0 and states_equal(
                    st, single.slic_model._clusters),
                "mesh %s frame %d: labels or state differ from the single "
                "device" % (tag, t))
    return counts


def cca_on_slabs(mesh, frame, K: int, res: Results, tag: str,
                 time_rows: bool):
    """The sharded CCA's kernels at the mesh path's own shapes and inputs:
    one frame through a fresh ShardedSlicExplicit with the shard step's
    connected_components, seam_min, lookup and selection wrapped to hold
    each call against its plain version on the same inputs, bit for bit
    (the components, every seam, with its changed flag, every gather of
    seam values, final gather and relabel, the substitute table and tie
    flag of each run), and its halo propagations to count
    their rounds (spatial_shardmap looks these names up at call time).
    Each round makes one two-row gather a shard and one seam_min a seam
    side; each propagation one gather of a whole slab a shard, and the
    relabel one more.  ``time_rows``: time seam_min's JSON row on the
    first seam of slab 1 in the second propagation (the leader ranks),
    and region_table's and propagate_min's on that slab's seed and roots,
    12 bytes a pixel moved."""
    import torch
    from fast_slic_tpu_torch.kernels import cca
    from fast_slic_tpu_torch.parallel import spatial_shardmap as ssm

    D = mesh.shape["space"]
    Hl, W = frame.shape[0] // D, frame.shape[1]
    comps, seams, gathers, rounds, selects, inputs = [], [], [], [], [], {}

    def components(labels):
        out = cca.connected_components(labels)
        res.check("connected_components", max_abs_err(
            out, cca.connected_components_plain(labels)))
        comps.append(labels.shape)
        return out

    def seam_min(table, roots_row, lab_row, lab_nb, val_nb, changed,
                 stamp):
        args = (roots_row, lab_row, lab_nb, val_nb)
        want, want_changed = table.clone(), changed.clone()
        cca.seam_min_plain(want, *args, want_changed, stamp)
        if "slab" in inputs and table is inputs["slab"][2] and (
                "seam" not in inputs):
            inputs["seam"] = (table.clone(), args, changed.clone(), stamp)
        cca.seam_min(table, *args, changed, stamp)
        res.check("seam_min", max(max_abs_err(table, want),
                                  max_abs_err(changed, want_changed)))
        seams.append((len(rounds), roots_row.numel()))

    def lookup(ids, table):
        out = cca.lookup(ids, table)
        res.check("lookup", max_abs_err(out, cca.lookup_plain(ids, table)))
        gathers.append(ids.numel())
        return out

    def substitutes(areas, target, ncomp, K, thres, n_pixels=None):
        got = cca.cca_select(areas, target, ncomp, K, thres, n_pixels)
        want = cca.cca_select_plain(areas, target, ncomp, K, thres, n_pixels)
        res.check("cca_select", max(max_abs_err(got[0], want[0]),
                                    max_abs_err(got[1], want[1])))
        selects.append((areas.numel(), n_pixels))
        return got

    def halo_propagate(mesh, labs, tables, roots, n_rounds):
        if time_rows and len(rounds) == 1:
            inputs["slab"] = (tables[1].clone().reshape(Hl, W), roots[1],
                              tables[1])
        out = real_propagate(mesh, labs, tables, roots, n_rounds)
        rounds.append(n_rounds[-1])
        return out

    real_propagate = ssm._halo_propagate
    sharded = ssm.ShardedSlicExplicit(num_components=K, mesh=mesh)
    names = ("connected_components", "seam_min", "lookup", "_halo_propagate",
             "_substitutes")
    saved = [getattr(ssm, k) for k in names]
    for k, fn in zip(names, (components, seam_min, lookup, halo_propagate,
                             substitutes)):
        setattr(ssm, k, fn)
    try:
        sharded.iterate(frame)
    finally:
        for k, fn in zip(names, saved):
            setattr(ssm, k, fn)
    # a candidate overflow re-runs the frame: every run's CCA counts
    runs = sharded.last_reruns + 1
    slab = Hl * W
    require(len(comps) == D * runs and len(rounds) == 2 * runs
            and rounds[-2:] == list(sharded.last_seam_rounds)
            and all(c == (Hl, W) for c in comps)
            and len(seams) == 2 * (D - 1) * sum(rounds)
            and all(w == W for _, w in seams)
            and gathers.count(2 * W) == D * sum(rounds)
            and gathers.count(slab) == 3 * D * runs
            and len(gathers) == D * sum(rounds) + 3 * D * runs
            and len(selects) == runs
            and all(p == D * slab and b < p for b, p in selects),
            "mesh %s: %d components, %d seam_min, %d lookup and %d "
            "selection calls (bins, pixels %s) in %d runs for seam rounds %s"
            % (tag, len(comps), len(seams), len(gathers), len(selects),
               selects, runs, rounds))
    log("mesh %s: the path's %d connected_components, %d seam_min, %d "
        "lookup calls (%d of a whole %dx%d slab) and %d cca_select calls "
        "(bins, pixels %s) in %d runs, seam rounds %s, equal their plain "
        "versions"
        % (tag, len(comps), len(seams), len(gathers), gathers.count(slab),
           W, Hl, len(selects), selects, runs, rounds))
    if not time_rows:
        return
    (m0, roots, _), (table, args, changed, stamp) = (inputs["slab"],
                                                     inputs["seam"])
    n = m0.numel()
    res.check("region_table", max_abs_err(
        cca.region_table(m0, roots), cca.region_table_plain(m0, roots)))
    res.time("region_table", lambda: cca.region_table(m0, roots),
             lambda: cca.region_table_plain(m0, roots), 12 * n, n)
    res.check("propagate_min", max_abs_err(
        cca.propagate_min(m0, roots), cca.propagate_min_plain(m0, roots)))
    res.time("propagate_min", lambda: cca.propagate_min(m0, roots),
             lambda: cca.propagate_min_plain(m0, roots), 12 * n, 2 * n)
    # the seam's bytes: its four rows read, each slot it meets read and
    # written, the flag written
    roots_row, lab_row, lab_nb, _ = args
    slots = int(torch.unique(roots_row[lab_row == lab_nb]).numel())
    w = roots_row.numel()
    t1, c1 = table.clone(), changed.clone()
    t2, c2 = table.clone(), changed.clone()
    res.time("seam_min", lambda: cca.seam_min(t1, *args, c1, stamp),
             lambda: cca.seam_min_plain(t2, *args, c2, stamp),
             16 * w + 8 * slots + 4, w)
    log("mesh %s: seam_min timed on slab 1's first seam of the leader-rank "
        "propagation: %d pixels, %d slots met; region_table and "
        "propagate_min on that slab (%d pixels)" % (tag, w, slots, n))


def mesh_phase(dev, batch, res: Results):
    """The mesh path (phase 10): ShardedSlicExplicit over four shards of
    one card at 3840x2160, K=14400, two frames, against SlicAvx2; the
    variants and ShardedSlic over four shards at 1920x1080, K=1600; a
    BatchedSlic batch over data=2, space=2 against no mesh; the JAX
    package's sharded classes (tests/data/port_mesh_ref.npz) on eight
    shards; and the path's own CCA kernel calls on one 4K and one 1080p
    frame against their plain versions (cca_on_slabs), the 4K run timing
    the rows of seam_min, region_table and propagate_min.  Returns (launch counts of the 4K
    run, of the 1080p runs)."""
    import torch
    from fast_slic_tpu_torch import (LSCAvx2, SlicAvx2, SlicRealDist,
                                     SlicRealDistL2, SlicRealDistNoQ)
    from fast_slic_tpu_torch.parallel.batch import BatchedSlic
    from fast_slic_tpu_torch.parallel.mesh import make_mesh
    from fast_slic_tpu_torch.parallel.spatial import ShardedSlic
    from fast_slic_tpu_torch.parallel.spatial_shardmap import (
        ShardedSlicExplicit)

    t0 = time.perf_counter()
    mesh4 = make_mesh(data=1, space=4, devices=[dev] * 4)
    log("mesh: %r; torch.cuda.device_count() %d"
        % (mesh4, torch.cuda.device_count()))
    frames = make_frames(2, H4K, W4K)
    counts = mesh_frames(
        H4K, W4K, K4K,
        ShardedSlicExplicit(num_components=K4K, mesh=mesh4),
        SlicAvx2(num_components=K4K, device=dev), frames, "4K")
    log("mesh: 4K launches %s" % json.dumps(counts))
    log("mesh: 4K launches of propagate_min %d, region_table %d (the "
        "sharded CCA keeps region tables and builds none)"
        % (counts["propagate_min"], counts["region_table"]))
    cca_on_slabs(mesh4, frames[0], K4K, res, "4K", True)

    f1080 = make_frames(1, H1080, W1080)
    variant_counts = {}
    for name, variant, cls, kw in (
            ("real", "real", SlicRealDist, {}),
            ("real_l2", "real_l2", SlicRealDistL2, {}),
            ("real_noq", "real_noq", SlicRealDistNoQ, {}),
            ("preemptive", "standard", SlicAvx2, {"preemptive": True}),
            ("lsc", "lsc", LSCAvx2, {})):
        c = mesh_frames(H1080, W1080, K720, ShardedSlicExplicit(
            num_components=K720, variant=variant, mesh=mesh4, **kw),
            cls(num_components=K720, device=dev, **kw), f1080, name)
        for k, v in c.items():
            variant_counts[k] = variant_counts.get(k, 0) + v
    mesh_frames(H1080, W1080, K720,
                ShardedSlic(num_components=K720, mesh=mesh4),
                SlicAvx2(num_components=K720, device=dev), f1080,
                "ShardedSlic")
    cca_on_slabs(mesh4, f1080[0], K720, res, "1080p", False)

    mesh22 = make_mesh(data=2, space=2, devices=[dev] * 4)
    for mode in ("stack", "map"):
        meshed = BatchedSlic(num_components=K720, batch_mode=mode,
                             mesh=mesh22)
        plain = BatchedSlic(num_components=K720, batch_mode=mode, device=dev)
        got, ev_ms, host_ms = timed_call(lambda: meshed.iterate(batch))
        want, ref_ev, ref_host = timed_call(lambda: plain.iterate(batch))
        require(torch.equal(got, want) and states_equal(meshed.state,
                                                        plain.state)
                and torch.equal(meshed.last_flags, plain.last_flags),
                "mesh BatchedSlic %s: labels, state or flags differ from "
                "no mesh" % mode)
        log("mesh BatchedSlic %s B=%d over data=2, space=2: %.3f ms (CUDA "
            "events), %.3f ms (host clock); without a mesh %.3f ms, %.3f "
            "ms; labels, state and tie flags %s equal"
            % (mode, len(batch), ev_ms, host_ms, ref_ev, ref_host,
               meshed.last_flags.tolist()))

    mesh_fixture(dev)
    log("mesh phase: %.1f s" % (time.perf_counter() - t0))
    return counts, variant_counts


def mesh_fixture(dev):
    """The JAX package's ShardedSlicExplicit (each variant, preemptive, a
    warm start), ShardedSlic and BatchedSlic(mesh=data 4, space 2) arrays
    (MESH_FIXTURE) against the port on eight shards of the card."""
    from fast_slic_tpu_torch.parallel.batch import BatchedSlic
    from fast_slic_tpu_torch.parallel.mesh import make_mesh
    from fast_slic_tpu_torch.parallel.spatial import ShardedSlic
    from fast_slic_tpu_torch.parallel.spatial_shardmap import (
        ShardedSlicExplicit)

    ref = np.load(MESH_FIXTURE)
    mesh8 = make_mesh(data=1, space=8, devices=[dev] * 8)
    kw = dict(num_components=9, min_size_factor=0.1)
    fields = ("y", "x", "r", "g", "b", "num_members", "is_active",
              "is_updatable")

    def same(name, labels, st, lsc=False):
        agree = float((np.asarray(labels) == ref[name + "_labels"]).mean())
        state = all(np.array_equal(getattr(st, f), ref[name + "_" + f])
                    for f in fields)
        log("mesh fixture %s: label agreement with the JAX package %r, "
            "state equal %s" % (name, agree, state))
        require(agree >= 0.99 if lsc else (agree == 1.0 and state),
                "mesh fixture %s differs from the JAX package's" % name)

    image = ref["image"]
    for v in ("standard", "real", "real_l2", "real_noq", "lsc"):
        sh = ShardedSlicExplicit(variant=v, mesh=mesh8, **kw)
        same("x_" + v, sh.iterate(image, 3), sh.state, v == "lsc")
    sh = ShardedSlicExplicit(preemptive=True, mesh=mesh8, **kw)
    same("x_preemptive", sh.iterate(image, 4), sh.state)
    sh = ShardedSlicExplicit(mesh=mesh8, **kw)
    same("warm1", sh.iterate(image, 2), sh.state)
    same("warm2", sh.iterate(image, 2), sh.state)
    for name, extra in (("s_standard", {}),
                        ("s_preemptive", {"preemptive": True})):
        sh = ShardedSlic(mesh=mesh8, **kw, **extra)
        same(name, sh.iterate(image, 3), sh.state)
    for mode in ("map", "stack"):
        bs = BatchedSlic(mesh=make_mesh(data=4, space=2, devices=[dev] * 8),
                         batch_mode=mode, **kw)
        same("b_" + mode, bs.iterate(ref["frames"], 3).cpu().numpy(),
             bs.state)


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


def profile_crf(dev, frames):
    """torch.profiler over one frame's graphs and pushes, and over one
    steady initialize(); inference(CRF_ITERS) cycle of the adjacency CRF."""
    from fast_slic_tpu_torch import SimpleCRF, SlicAvx2
    slic = SlicAvx2(num_components=K720, device=dev)
    crf = SimpleCRF(CRF_C, K720, device=dev)
    for t, f in enumerate(frames):
        slic.iterate(f)
        if t + 1 < len(frames):
            crf.push_slic_frame(slic).set_proba(crf_proba(t, CRF_C, K720))

    def push_last():
        slic.slic_model.get_knn_connectivity(slic.last_assignment, CRF_KNN)
        crf.push_slic_frame(slic).set_proba(
            crf_proba(len(frames) - 1, CRF_C, K720))

    profile_phase("crf graphs and push, one frame", lambda: None, push_last)

    def cycle():
        crf.initialize()
        crf.inference(CRF_ITERS)

    profile_phase("crf initialize(); inference(%d), T=%d" % (
        CRF_ITERS, len(frames)), cycle, cycle)


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
    knn_kernel_phase(dev, res)

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
    counts["crf"] = crf_phase(dev, frames, K720)
    counts["api"] = api_phase(dev, frames, K720)
    counts["mesh"], counts["mesh variants"] = mesh_phase(dev, batches[0],
                                                         res)
    res.log()
    for path, need in (("standard", STANDARD_PATH), ("float", FLOAT_PATH),
                       ("preemptive", PREEMPTIVE_PATH),
                       ("batch", BATCH_PATH), ("crf", CRF_PATH),
                       ("api", API_PATH), ("mesh", MESH_PATH),
                       ("mesh variants", MESH_VARIANT_PATH)):
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
        profile_crf(dev, frames)
        from fast_slic_tpu_torch.parallel.mesh import make_mesh
        from fast_slic_tpu_torch.parallel.spatial_shardmap import (
            ShardedSlicExplicit)
        big = make_frames(2, H4K, W4K)
        for name, slic in (
                ("SlicAvx2 4K", SlicAvx2(num_components=K4K, device=dev)),
                ("ShardedSlicExplicit 4K space=4", ShardedSlicExplicit(
                    num_components=K4K, mesh=make_mesh(
                        data=1, space=4, devices=[dev] * 4)))):
            profile_phase(name, lambda: slic.iterate(big[0]),
                          lambda: slic.iterate(big[1]))
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
