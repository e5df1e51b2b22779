#!/usr/bin/env python3
"""The candidate slots a row shard needs: ShardedSlicExplicit's shard step
at 3840x2160, K=14400 over four shards of one card, with 16 and with 32
slots in each shard's candidate lists, against the single-device pipeline
(16 slots) on chip_smoke.py's first 4K frame.

    python3 scripts/mesh_slots.py          # on a GPU, from the repository root

A shard's first and last cell rows also take the clusters within S+1 rows
outside its slab, so its lists fill further than the image's.  For each
slot count the script prints whether the shard step flagged a candidate
overflow, how far its raw assignment agrees with the single device's, the
first differing pixel, and how far the labels of the JAX package's
escalation for an overflow (the exact CCA of that raw assignment) agree
with the single device's labels.
"""

from __future__ import annotations

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    import dataclasses

    import torch

    import chip_smoke as cs
    from fast_slic_tpu_torch import cluster as cl, pipeline
    from fast_slic_tpu_torch.config import StaticConfig
    from fast_slic_tpu_torch.ops.cca import enforce_connectivity_exact
    from fast_slic_tpu_torch.parallel.mesh import make_mesh
    from fast_slic_tpu_torch.parallel.spatial_shardmap import shard_step

    if not torch.cuda.is_available():
        raise SystemExit("needs a GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    dev = torch.device("cuda")
    H, W, K = cs.H4K, cs.W4K, cs.K4K
    frame = cs.make_frames(2, H, W)[0]
    cfg = StaticConfig(H=H, W=W, K=K)
    scal = pipeline.derive_scalars(cfg, 10.0, 0.25)
    st0 = cl.initialize_clusters(frame, K)
    single = pipeline.iterate_graph(torch.from_numpy(frame).to(dev),
                                    st0.to_torch(dev), cfg, scal, 10, 3)
    print("single device, 16 slots: overflow %s, tie %s"
          % (bool(single.cand_overflow), bool(single.cca_tie)))
    mesh = make_mesh(data=1, space=4, devices=[dev] * 4)
    for local in (16, 32):
        # the shard step gives each shard twice the image's slots
        c = dataclasses.replace(cfg, cand_slots=local // 2)
        out = shard_step(mesh, frame, st0.to_torch(dev), c, scal, 10, 3)
        raw = torch.cat(out.raw_assignment)
        diff = (raw != single.raw_assignment).nonzero()
        fixed, _ = enforce_connectivity_exact(raw, K, int(scal.thres))
        labels = torch.where(fixed == 0xFFFF, -1, fixed)
        print("shards with %d slots: overflow %s, raw agreement %r, first "
              "differing pixel %s, escalated labels' agreement %r"
              % (local, bool(out.cand_overflow),
                 float((raw == single.raw_assignment).double().mean()),
                 diff[0].tolist() if len(diff) else None,
                 float((labels == single.labels).double().mean())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
