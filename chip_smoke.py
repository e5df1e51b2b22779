#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU and
check it.

    python3 chip_smoke.py            # from the repository root, on a GPU
    python3 chip_smoke.py --profile  # also: torch.profiler over one frame

Phases (any failure exits non-zero; no phase's error is caught):

1. the card: torch.cuda.is_available(), name and power limit (nvidia-smi);
2. build: the CUDA kernels of fast_slic_tpu_torch/csrc, compiled by nvcc;
3. kernels: each kernel against its plain PyTorch version, both on the
   card, at the main path's shapes (1280x720, K=1600, S=24, 16 candidate
   slots; assign and update at stride 3 with each remainder and stride 1;
   CCA on a real raw assignment of the frame); bit-exact, with times;
4. slice: SlicAvx2(num_components=1600, device="cuda") on four 1280x720
   frames made from tests/data/golden_ref.npz; labels and clusters equal the
   plain path (device="cpu") on the same frames, and every kernel of the
   path was launched;
5. golden: the six standard golden cases agree 1.0 with golden_ref.npz.

The line before the last is {"kernels": [...]}; the last line is
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
    "std_k256_msf01": (256, {}, {}),
    "std_k256_msf0": (256, {}, {"min_size_factor": 0.0}),
    "std_k100_nolab": (100, {"convert_to_lab": False},
                       {"min_size_factor": 0.25}),
    "std_k256_euclid": (256, {"manhattan_spatial_dist": False}, {}),
    "std_k256_stride1": (256, {}, {"subsample_stride": 1}),
    "std_k256_comp20": (256, {}, {"compactness": 20.0}),
}


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


def max_abs_err(a, b) -> int:
    require(a.shape == b.shape and a.dtype == b.dtype,
            "shape/dtype differ: %s %s vs %s %s"
            % (tuple(a.shape), a.dtype, tuple(b.shape), b.dtype))
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


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

    def record(name, err, ms=None, plain_ms=None):
        r = res.setdefault(name, {"max_abs_err": 0, "ms": None,
                                  "plain_ms": None})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        require(err == 0, "%s disagrees with its plain version: max abs "
                "err %d" % (name, err))
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
    planes, st = pipeline.stage_setup(image, st, cfg)
    st, a0, _ = pipeline.stage_loop(planes, st, cfg, scal, 3, 3)
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
    return res


def slice_phase(dev, frames, K: int):
    """SlicAvx2 on the frames on ``dev`` and on the CPU (plain path); the
    results must be equal.  Returns (launch counts of the device run, host
    ms per frame, device ms per frame from the timing report, tie count,
    last timing report)."""
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
        require(agree == 1.0, "golden %s: agreement %r" % (name, agree))
        require(np.array_equal(st.y, ref[:, 0])
                and np.array_equal(st.x, ref[:, 1])
                and np.array_equal(st.num_members.astype(np.float32),
                                   ref[:, 5]),
                "golden %s: cluster y/x/num_members differ" % name)
        log("golden %s: agreement %r, tie escalation %s"
            % (name, agree, res.cca_tie))


def profile_phase(dev, frames, K: int):
    """torch.profiler over one steady-state frame of the main path: device
    time by kernel and the device's busy share of the frame's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from fast_slic_tpu_torch import SlicAvx2

    slic = SlicAvx2(num_components=K, device=dev)
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
    log("profile: frame wall %.1f us, device busy %.1f us (%.1f%%), "
        "idle %.1f%%" % (wall_us, busy, 100 * busy / wall_us,
                         100 - 100 * busy / wall_us))
    for us, count, key in rows[:20]:
        log("profile: %10.1f us %5d x %8.1f us  %s"
            % (us, count, us / count, key[:90]))


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
        log("kernel %s: exact, kernel %.4f ms, plain %.4f ms"
            % (name, r["ms"], r["plain_ms"]))

    counts, ms, dev_ms, ties, report = slice_phase(dev, frames, K720)
    log("slice: launches %s" % json.dumps(counts))
    log("slice: ms per frame, CUDA events over iterate: %s"
        % ", ".join("%.3f" % m for m in dev_ms))
    log("slice: ms per frame, host clock around SlicAvx2.iterate: %s"
        % ", ".join("%.3f" % m for m in ms))
    log("slice: tie escalations %d of %d frames" % (ties, len(frames)))
    log("slice: last frame phases (CUDA events, us) " + report)
    missing = [k.name for k in KERNELS if counts[k.name] <= 0]
    require(not missing, "kernels never launched on the main path: %s"
            % missing)

    golden_phase(dev)
    if "--profile" in sys.argv[1:]:
        profile_phase(dev, frames, K720)
    require("jax" not in sys.modules, "the port imported jax")

    log(json.dumps({"kernels": [
        {"name": k.name, "route": k.route, "source": k.source,
         "replaces": k.replaces, "launches": counts[k.name],
         "max_abs_err": kres[k.name]["max_abs_err"],
         "ms": kres[k.name]["ms"], "plain_ms": kres[k.name]["plain_ms"]}
        for k in KERNELS]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
