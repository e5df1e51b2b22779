#!/usr/bin/env python3
"""Device time of the CCA components and the assign kernel beside the
variants their designs were chosen from, at 1280x720, K=1600, on a CUDA GPU.

    python3 scripts/kernel_variants.py

Builds ``scripts/kernel_variants.cu`` (which includes the library's
``csrc/cca.cu`` and ``csrc/assign.cu``) with the library's nvcc flags into
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
  rows a block); ``no_table`` (the spatial term computed in the loop).

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


def build():
    """Compile the variants; returns their two C entry points."""
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
    for fn in (lib.cc_variant, lib.assign_variant):
        fn.restype = I
    return lib.cc_variant, lib.assign_variant


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
    cc_variant, assign_variant = build()
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
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
