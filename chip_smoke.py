#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths once on one NVIDIA GPU and check
them: the standard main path and the float-distance path (the real
variants and LSC).

    python3 chip_smoke.py            # from the repository root, on a GPU
    python3 chip_smoke.py --profile  # also: torch.profiler over one frame
                                     # of the standard and the LSC path

Phases (any failure exits non-zero; no phase's error is caught):

1. the card: torch.cuda.is_available(), name and power limit (nvidia-smi);
2. build: the CUDA kernels of fast_slic_tpu_torch/csrc, compiled by nvcc;
3. kernels: each kernel against its plain PyTorch version, both on the
   card, at the paths' shapes (1280x720, K=1600, S=24, 16 candidate slots;
   assign, float assign (each variant) and update at stride 3 with each
   remainder and stride 1; CCA on a real raw assignment of the frame; the
   LSC features and the f32 segment sum on an LSC state of the frame);
   bit-exact, except the f32 segment sum (within 1e-5 of each bin's sum of
   absolute values: its float atomics add in a different order), with times;
4. slice, standard path: SlicAvx2(num_components=1600, device="cuda") on
   four 1280x720 frames made from tests/data/golden_ref.npz; labels and
   clusters equal the plain path (device="cpu") on the same frames, and
   every kernel of the path was launched;
5. slice, float path: LSCAvx2 on two frames (labels agree >= 0.999 with the
   plain path, clusters within 1 of it or 1 %), SlicRealDist,
   SlicRealDistL2 and SlicRealDistNoQ on one frame each (labels and
   clusters equal the plain path), and every kernel of the path was
   launched;
6. golden: the six standard and the three real-distance golden cases agree
   1.0 with golden_ref.npz, lsc_k256 >= 0.999.

Each path's launch counts are set to 0 just before it runs and read just
after.  The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.  Imports nothing of JAX.
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
}


# the kernels each path must launch
STANDARD_PATH = ("lab", "assign", "slic_update", "segment_sum",
                 "connected_components", "lookup")
FLOAT_PATH = ("lab", "lsc_feat", "assign_float", "slic_update", "fsegsum",
              "segment_sum", "connected_components", "lookup")


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


def paired_times(kernel_fn, plain_fn, reps: int, plain_reps: int):
    """Times in turns (plain, kernel, kernel, plain); the min of each pair."""
    p1 = time_ms(plain_fn, plain_reps)
    k1 = time_ms(kernel_fn, reps)
    k2 = time_ms(kernel_fn, reps)
    p2 = time_ms(plain_fn, plain_reps)
    return min(k1, k2), min(p1, p2)


def max_abs_err(a, b):
    require(a.shape == b.shape and a.dtype == b.dtype,
            "shape/dtype differ: %s %s vs %s %s"
            % (tuple(a.shape), a.dtype, tuple(b.shape), b.dtype))
    if not a.numel():
        return 0
    if a.is_floating_point():
        return float((a.double() - b.double()).abs().max())
    return int((a.long() - b.long()).abs().max())


def kernel_phase(dev, frame, K: int, timed: bool):
    """Each kernel vs its plain version on ``dev`` at the frame's shapes.
    Returns {name: {"max_abs_err", "ms", "plain_ms"}}."""
    import torch
    from fast_slic_tpu_torch import cluster as cl, pipeline
    from fast_slic_tpu_torch.config import StaticConfig, UNASSIGNED
    from fast_slic_tpu_torch.kernels import assign, cca, lab, segsum
    from fast_slic_tpu_torch.ops.cca import leader_ranks, segsum_values

    H, W = frame.shape[:2]
    cfg = StaticConfig(H=H, W=W, K=K)
    scal = pipeline.derive_scalars(cfg, 10.0, 0.25)
    res = {}

    def record(name, err, ms=None, plain_ms=None, ok=None):
        r = res.setdefault(name, {"max_abs_err": 0, "ms": None,
                                  "plain_ms": None})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        require(err == 0 if ok is None else ok, "%s disagrees with its "
                "plain version: max abs err %r" % (name, err))
        if ms is not None:
            r["ms"], r["plain_ms"] = ms, plain_ms

    def timing(kernel_fn, plain_fn, reps=50, plain_reps=5):
        return paired_times(kernel_fn, plain_fn, reps, plain_reps) \
            if timed else (None, None)

    image = torch.from_numpy(frame).to(dev)
    record("lab", max_abs_err(lab.rgb_to_lab_planar(image), lab.plain(image)),
           *timing(lambda: lab.rgb_to_lab_planar(image),
                   lambda: lab.plain(image)))

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
        err = max(max_abs_err(outs[0][0], outs[1][0]),
                  max_abs_err(outs[0][1], outs[1][1]))
        a_k = outs[0][0]
        t = (None, None)
        if rem == 0:  # the pass is idempotent, so it is timed in place
            t = timing(
                lambda: assign.assign(planes, table, cand, a_k, scal.coef,
                                      cfg.S, stride, rem, True),
                lambda: assign.plain(planes, table, cand, a_k, scal.coef,
                                     cfg.S, stride, rem, True))
        if stride == 1 and timed:
            log("kernel assign at stride 1: kernel %.4f ms, plain %.4f ms"
                % t)
            t = (None, None)
        record("assign", err, *t)
        upd_k = segsum.slic_update(a_k, planes, K, stride, rem)
        upd_p = segsum.slic_update_plain(a_k, planes, K, stride, rem)
        record("slic_update", max_abs_err(upd_k, upd_p),
               *(timing(lambda: segsum.slic_update(a_k, planes, K, stride,
                                                   rem),
                        lambda: segsum.slic_update_plain(a_k, planes, K,
                                                         stride, rem))
                 if (stride, rem) == (3, 0) else (None, None)))

    # CCA kernels on a real raw assignment of the frame
    out = pipeline.iterate_graph(
        image, cl.initialize_clusters(frame, K).to_torch(dev), cfg, scal,
        10, 3)
    raw = out.raw_assignment
    L_k = cca.connected_components(raw)
    L_p = cca.connected_components_plain(raw)
    record("connected_components", max_abs_err(L_k, L_p),
           *timing(lambda: cca.connected_components(raw),
                   lambda: cca.connected_components_plain(raw),
                   plain_reps=2))
    L = L_p.reshape(-1)
    is_leader, rank, ncomp = leader_ranks(L)
    record("lookup", max_abs_err(cca.lookup(L, rank),
                                 cca.lookup_plain(L, rank)),
           *timing(lambda: cca.lookup(L, rank),
                   lambda: cca.lookup_plain(L, rank)))
    comp2 = cca.lookup_plain(L, rank).reshape(H, W)
    vals = segsum_values(comp2, is_leader).contiguous()
    ids = comp2.reshape(-1)
    n = H * W
    record("segment_sum", max_abs_err(segsum.segment_sum(ids, vals, n),
                                      segsum.segment_sum_plain(ids, vals, n)),
           *timing(lambda: segsum.segment_sum(ids, vals, n),
                   lambda: segsum.segment_sum_plain(ids, vals, n)))
    log("kernel phase: raw assignment has %d components" % int(ncomp))
    float_kernel_phase(dev, image, K, record, timing)
    return res


def float_kernel_phase(dev, image, K: int, record, timing):
    """The float path's kernels vs their plain versions: the float assign
    of each variant on a mid-loop state of that variant (setup and three
    loop iterations through the kernels), and LSC's colour features and f32
    segment sum on the LSC state."""
    import torch
    from fast_slic_tpu_torch import cluster as cl, pipeline
    from fast_slic_tpu_torch.config import StaticConfig
    from fast_slic_tpu_torch.kernels import assign_float, fsegsum, lsc_feat

    H, W = image.shape[:2]
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
            err = max(max_abs_err(outs[0][0], outs[1][0]),
                      max_abs_err(outs[0][1], outs[1][1]))
            t = (None, None)
            if rem == 0:  # the pass is idempotent, so it is timed in place
                a_k = outs[0][0]
                t = timing(
                    lambda: assign_float.assign_float(
                        planes, table, cand, a_k, scal.coef, cfg.S, stride,
                        rem, variant, True, None, feats, cent),
                    lambda: assign_float.plain(
                        planes, table, cand, a_k, scal.coef, cfg.S, stride,
                        rem, variant, True, None, feats, cent))
                if t[0] is not None:
                    log("kernel assign_float %s at stride %d: kernel %.4f "
                        "ms, plain %.4f ms" % ((variant, stride) + t))
            # the JSON line carries LSC's stride-3 times (the path's
            # heaviest variant); the log has every variant's
            record("assign_float", err,
                   *(t if (variant, stride) == ("lsc", 3) else (None, None)))

    # the loop ended on lsc: planes, scal, feats, weights, a0 are its state
    tabs = [torch.from_numpy(scal.lsc_tables[k]).to(dev)
            for k in ("L_cos", "L_sin", "color_cos", "color_sin")]
    record("lsc_feat", max_abs_err(lsc_feat.lsc_color_feats(planes, *tabs),
                                   lsc_feat.plain(planes, *tabs)),
           *timing(lambda: lsc_feat.lsc_color_feats(planes, *tabs),
                   lambda: lsc_feat.plain(planes, *tabs)))

    # the segment sum as after_update calls it at stride 3, rem 0
    ok = a0[0::3] != 0xFFFF
    ids = torch.where(ok, a0[0::3], K).reshape(-1).to(torch.int32)
    mask = ok.reshape(-1).to(torch.int32)
    vals = torch.cat([feats[:, 0::3], weights[None, 0::3]]).reshape(11, -1)
    got = fsegsum.float_segsum(ids, mask, vals, K, 10)
    ref = fsegsum.plain(ids, mask, vals, K, 10)
    bound = 1e-5 * fsegsum.plain(ids, mask, vals.abs(), K, 10)
    record("fsegsum", max_abs_err(got, ref),
           *timing(lambda: fsegsum.float_segsum(ids, mask, vals, K, 10),
                   lambda: fsegsum.plain(ids, mask, vals, K, 10)),
           ok=bool(((got - ref).abs() <= bound).all()))
    log("kernel phase: float path at N=%d segment-sum pixels, fsegsum max "
        "abs err %r (bound: 1e-5 of each bin's sum of |w*f|, max %r)"
        % (ids.numel(), max_abs_err(got, ref), float(bound.max())))


def slice_phase(dev, frames, K: int):
    """The standard path: SlicAvx2 on the frames on ``dev`` and on the CPU
    (plain path); the results must be equal.  Returns (launch counts of the
    device run, host ms per frame, device ms per frame from the timing
    report, tie count, last timing report)."""
    from fast_slic_tpu_torch import SlicAvx2
    from fast_slic_tpu_torch.kernels import launch_counts, reset_launches

    H, W = frames[0].shape[:2]
    slic = SlicAvx2(num_components=K, device=dev)
    results, ms, dev_ms, ties = [], [], [], 0
    reset_launches()
    for f in frames:
        t0 = time.perf_counter()
        labels = slic.iterate(f)  # returns numpy: the device has finished
        ms.append((time.perf_counter() - t0) * 1e3)
        report = slic.slic_model.last_timing_report
        dev_ms.append(json.loads(report)["duration"] / 1e3)
        ties += int(slic.slic_model.last_cca_tie)
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


def float_slice_phase(dev, frames, K: int):
    """The float path: LSCAvx2 on two frames and SlicRealDist,
    SlicRealDistL2 and SlicRealDistNoQ on one frame each, on ``dev`` and on
    the CPU (plain path).  Returns the launch counts of the device runs."""
    from fast_slic_tpu_torch import (LSCAvx2, SlicRealDist, SlicRealDistL2,
                                     SlicRealDistNoQ)
    from fast_slic_tpu_torch.kernels import launch_counts, reset_launches

    runs = [(LSCAvx2, frames[:2])] + [
        (cls, frames[:1])
        for cls in (SlicRealDist, SlicRealDistL2, SlicRealDistNoQ)]
    results = []
    reset_launches()
    for cls, fs in runs:
        slic = cls(num_components=K, device=dev)
        for f in fs:
            labels = slic.iterate(f)
            report = json.loads(slic.slic_model.last_timing_report)
            results.append((labels, slic.slic_model.to_yxmrgb(),
                            report["duration"] / 1e3))
    counts = launch_counts()

    out = iter(results)
    for cls, fs in runs:
        plain = cls(num_components=K, device="cpu")
        for i, f in enumerate(fs):
            labels, yxmrgb, dev_ms = next(out)
            ref = plain.iterate(f)
            ref_yxm = plain.slic_model.to_yxmrgb()
            agree = float((labels == ref).mean())
            moved = int((yxmrgb != ref_yxm).any(axis=1).sum())
            log("slice %s frame %d: %.3f ms (CUDA events over iterate), "
                "label agreement with the plain path %r, clusters that "
                "differ %d" % (cls.__name__, i + 1, dev_ms, agree, moved))
            require(labels.shape == ref.shape and labels.min() >= 0,
                    "%s frame %d: labels shape or range" % (cls.__name__, i))
            if cls is LSCAvx2:
                require(agree >= 0.999, "LSC frame %d: agreement %r"
                        % (i, agree))
                require(np.allclose(yxmrgb, ref_yxm, rtol=0.01, atol=1.0),
                        "LSC frame %d: clusters differ from the plain path"
                        % i)
            else:
                require(agree == 1.0 and np.array_equal(yxmrgb, ref_yxm),
                        "%s: labels or clusters differ from the plain path"
                        % cls.__name__)
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


def profile_phase(dev, frames, K: int, cls):
    """torch.profiler over one steady-state frame of ``cls`` (a path's
    class): device time by kernel and the device's busy share of the
    frame's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    slic = cls(num_components=K, device=dev)
    slic.iterate(frames[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        slic.iterate(frames[1])
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
    name = cls.__name__
    log("profile %s: frame wall %.1f us, device busy %.1f us (%.1f%%), "
        "idle %.1f%%" % (name, wall_us, busy, 100 * busy / wall_us,
                         100 - 100 * busy / wall_us))
    for us, count, key in rows[:20]:
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
    kres = kernel_phase(dev, frames[0], K720, timed=True)
    for name, r in kres.items():
        log("kernel %s: max abs err %r, kernel %.4f ms, plain %.4f ms"
            % (name, r["max_abs_err"], r["ms"], r["plain_ms"]))

    counts, ms, dev_ms, ties, report = slice_phase(dev, frames, K720)
    log("slice: standard path launches %s" % json.dumps(counts))
    log("slice: ms per frame, CUDA events over iterate: %s"
        % ", ".join("%.3f" % m for m in dev_ms))
    log("slice: ms per frame, host clock around SlicAvx2.iterate: %s"
        % ", ".join("%.3f" % m for m in ms))
    log("slice: tie escalations %d of %d frames" % (ties, len(frames)))
    log("slice: last frame phases (CUDA events, us) " + report)
    missing = [k for k in STANDARD_PATH if counts[k] <= 0]
    require(not missing, "kernels never launched on the standard path: %s"
            % missing)

    fcounts = float_slice_phase(dev, frames, K720)
    log("slice: float path launches %s" % json.dumps(fcounts))
    missing = [k for k in FLOAT_PATH if fcounts[k] <= 0]
    require(not missing, "kernels never launched on the float path: %s"
            % missing)
    # each kernel's launches as counted on its path: the standard path's,
    # or the float path's for the kernels only that path runs
    launches = {k.name: counts[k.name] if k.name in STANDARD_PATH
                else fcounts[k.name] for k in KERNELS}

    golden_phase(dev)
    if "--profile" in sys.argv[1:]:
        from fast_slic_tpu_torch import LSCAvx2, SlicAvx2
        for cls in (SlicAvx2, LSCAvx2):
            profile_phase(dev, frames, K720, cls)
    require("jax" not in sys.modules, "the port imported jax")

    log(json.dumps({"kernels": [
        {"name": k.name, "route": k.route, "source": k.source,
         "replaces": k.replaces, "launches": launches[k.name],
         "max_abs_err": kres[k.name]["max_abs_err"],
         "ms": kres[k.name]["ms"], "plain_ms": kres[k.name]["plain_ms"]}
        for k in KERNELS]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
