#!/usr/bin/env python3
"""Write tests/data/port_mesh_ref.npz: the JAX package's sharded classes on
an 8-device CPU mesh, for tests/test_torch_mesh.py and chip_smoke.py to
hold the PyTorch port's mesh against (the GPU machine has no jax).

    JAX_PLATFORMS=cpu python3 scripts/make_port_fixture_mesh.py

Every case runs at K=9, compactness 10, min_size_factor 0.1, stride 3 on
images made by tests/conftest.py's ``make_image`` from numpy seed 1234.
For each case ``<name>`` the file holds ``<name>_labels`` (int16 [H, W],
or int32 [B, H, W] for a batch) and the final cluster state
``<name>_<field>`` for the eight Clusters fields:

* ``x_standard``, ``x_real``, ``x_real_l2``, ``x_real_noq``, ``x_lsc``:
  ``ShardedSlicExplicit(variant=...)`` on ``image`` (64x64), max_iter 3,
  space=8;
* ``x_preemptive``: ``ShardedSlicExplicit(preemptive=True)``, max_iter 4;
* ``warm1``, ``warm2``: one ``ShardedSlicExplicit`` iterated twice on
  ``image`` at max_iter 2 (the second warm-starts from the first's state);
* ``s_standard``, ``s_preemptive``: ``ShardedSlic`` (the GSPMD class),
  max_iter 3;
* ``b_map``, ``b_stack``: ``BatchedSlic(mesh=make_mesh(8, data=4,
  space=2))`` on ``frames`` (4x48x64), max_iter 3, in map and stack mode.

About two minutes on the CPU; the file is ~80 KB.
"""

from __future__ import annotations

import os
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")

import numpy as np  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data", "port_mesh_ref.npz")
FIELDS = ("y", "x", "r", "g", "b", "num_members", "is_active",
          "is_updatable")
K, MSF = 9, 0.1


def make_image(rng, H, W):
    """tests/conftest.py's ``make_image`` (smooth): 8x8 blocks plus noise."""
    base = rng.integers(0, 256, size=(-(-H // 8), -(-W // 8), 3))
    img = np.kron(base, np.ones((8, 8, 1)))[:H, :W]
    noise = rng.integers(-10, 10, size=(H, W, 3))
    return np.clip(img + noise, 0, 255).astype(np.uint8)


def main() -> int:
    sys.path.insert(0, ROOT)
    import jax
    jax.config.update("jax_platforms", "cpu")
    from fast_slic_tpu.parallel.batch import BatchedSlic
    from fast_slic_tpu.parallel.mesh import make_mesh
    from fast_slic_tpu.parallel.spatial import ShardedSlic
    from fast_slic_tpu.parallel.spatial_shardmap import ShardedSlicExplicit

    if len(jax.devices()) < 8:
        raise SystemExit("needs 8 CPU devices (XLA_FLAGS)")
    rng = np.random.default_rng(1234)
    image = make_image(rng, 64, 64)
    frames = np.stack([make_image(rng, 48, 64) for _ in range(4)])
    out = {"image": image, "frames": frames}
    space8 = make_mesh(8, data=1, space=8)

    def keep(name, labels, state):
        out[name + "_labels"] = np.asarray(labels)
        for f in FIELDS:
            out["%s_%s" % (name, f)] = np.asarray(getattr(state, f))

    t0 = time.perf_counter()
    for variant in ("standard", "real", "real_l2", "real_noq", "lsc"):
        sh = ShardedSlicExplicit(num_components=K, min_size_factor=MSF,
                                 variant=variant, mesh=space8)
        keep("x_" + variant, sh.iterate(image, max_iter=3), sh._state)
    sh = ShardedSlicExplicit(num_components=K, min_size_factor=MSF,
                             preemptive=True, mesh=space8)
    keep("x_preemptive", sh.iterate(image, max_iter=4), sh._state)
    sh = ShardedSlicExplicit(num_components=K, min_size_factor=MSF,
                             mesh=space8)
    keep("warm1", sh.iterate(image, max_iter=2), sh._state)
    keep("warm2", sh.iterate(image, max_iter=2), sh._state)
    for name, kw in (("s_standard", {}), ("s_preemptive",
                                          {"preemptive": True})):
        sh = ShardedSlic(num_components=K, min_size_factor=MSF, mesh=space8,
                         **kw)
        keep(name, sh.iterate(image, max_iter=3), sh._state)
    for mode in ("map", "stack"):
        bs = BatchedSlic(num_components=K, min_size_factor=MSF,
                         mesh=make_mesh(8, data=4, space=2), batch_mode=mode)
        keep("b_" + mode, bs.iterate(frames, max_iter=3), bs._state)
    np.savez_compressed(OUT, **out)
    print("wrote %s (%d bytes) in %.1f s" % (OUT, os.path.getsize(OUT),
                                             time.perf_counter() - t0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
