#!/usr/bin/env python3
"""Device time a launch of the SLIC update kernel and of the variants its
design was chosen from, at 1280x720, K=1600, on a CUDA GPU.

    python3 scripts/update_variants.py

Builds ``scripts/update_variants.cu`` with the library's nvcc flags into
``build/update_variants/``, makes real inputs (the raw assignments of
SlicAvx2's loop on the four frames of chip_smoke.py, and their LAB planes),
holds each variant that sums against the plain version, then times 20
launches of each, in turns, under torch.profiler at B=1 stride 3 (the main
path), B=4 stride 3 (a stacked batch) and B=4 stride 1.  Kernels:

- ``library``: the library's ``slic_update`` (``csrc/segsum.cu``): each
  lane's runs of equal ids into a shared table a block, flushed once;
- ``warp_table``: as ``library``, but a warp's equal ids are summed first
  (``__match_any_sync``, ``__reduce_add_sync``);
- ``warp_global``: the warp's sums straight to device memory, no table;
- ``loads``: the same tiles loaded, one device atomic a warp (a floor).

Prints the card's name and power limit, then one JSON line of device
microseconds a launch.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VARIANTS = {"warp_table": 0, "warp_global": 1, "loads": 2}


def build():
    """Compile the variants; returns their C entry point."""
    from fast_slic_tpu_torch.kernels import _lib
    out_dir = os.path.join(ROOT, "build", "update_variants")
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, "libupdate_variants.so")
    subprocess.run([_lib._nvcc(), *_lib.NVCC_FLAGS, "-shared", "-o", so,
                    os.path.join(ROOT, "scripts", "update_variants.cu")],
                   check=True)
    fn = ctypes.CDLL(so).update_variant
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [I, P, P, P, I, I, I, I, I, I, P]
    fn.restype = ctypes.c_int
    return fn


def inputs(dev):
    """Raw assignments int32 [4, H, W] and planes int32 [3, 4, H, W]."""
    import torch
    from chip_smoke import H720, K720, W720, make_frames
    from fast_slic_tpu_torch import cluster as cl, pipeline
    from fast_slic_tpu_torch.config import StaticConfig
    from fast_slic_tpu_torch.kernels import lab

    cfg = StaticConfig(H=H720, W=W720, K=K720)
    scal = pipeline.derive_scalars(cfg, 10.0, 0.25)
    raws, planes = [], []
    for frame in make_frames(4, H720, W720):
        image = torch.from_numpy(frame).to(dev)
        out = pipeline.iterate_graph(
            image, cl.initialize_clusters(frame, K720).to_torch(dev), cfg,
            scal, 10, 3)
        raws.append(out.raw_assignment)
        planes.append(lab.rgb_to_lab_planar(image))
    return torch.stack(raws).contiguous(), torch.stack(planes, 1).contiguous()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("update_variants: needs a CUDA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from chip_smoke import K720, gpu_line
    from fast_slic_tpu_torch.kernels import _lib, segsum
    from torch.profiler import ProfilerActivity, profile

    print(gpu_line(), flush=True)
    dev = torch.device("cuda")
    fn = build()
    a4, p4 = inputs(dev)
    K = K720
    H, W = a4.shape[-2:]
    result = {"device": torch.cuda.get_device_name(0), "cases": {}}
    for B, stride in ((1, 3), (4, 3), (4, 1)):
        a, p = (a4[0], p4[:, 0].contiguous()) if B == 1 else (a4, p4)
        ref = segsum.slic_update_plain(a, p, K, stride, 0)
        out = torch.zeros((6, B * K), dtype=torch.int32, device=dev)

        def variant(v, o=out):
            err = fn(v, a.data_ptr(), p.data_ptr(), o.data_ptr(), H, W, K, B,
                     stride, 0, _lib.stream())
            if err:
                raise RuntimeError("update_variant %d: cudaError %d"
                                   % (v, err))

        calls = {"library": lambda: segsum.slic_update(a, p, K, stride, 0)}
        for name, v in VARIANTS.items():
            calls[name] = lambda v=v: variant(v)
            if name != "loads":
                got = torch.zeros_like(out)
                variant(v, got)
                if not torch.equal(got, ref):
                    raise RuntimeError("%s differs from the plain version"
                                       % name)
        if not torch.equal(calls["library"](), ref):
            raise RuntimeError("slic_update differs from the plain version")
        for call in calls.values():
            call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                for call in calls.values():
                    call()
            torch.cuda.synchronize()
        keys = {"slic_update_kernel": "library"}
        keys.update(("update_variant<%d>" % v, name)
                    for name, v in VARIANTS.items())
        row = {}
        for e in prof.key_averages():
            for key, name in keys.items():
                if key in e.key:
                    row[name] = e.self_device_time_total / e.count
        result["cases"]["B=%d stride %d" % (B, stride)] = row
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
