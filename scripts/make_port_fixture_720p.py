#!/usr/bin/env python3
"""Write tests/data/port_720p_ref.npz: the JAX package's results at the
size the PyTorch port runs on the card, for tests/test_torch_720p.py and
chip_smoke.py to hold the port against.

    JAX_PLATFORMS=cpu python3 scripts/make_port_fixture_720p.py

Runs on the CPU (JAX's "standard" arch, the XLA path), over the frames of
chip_smoke.py (``make_frames``, 1280x720):

* ``Slic(num_components=1600)`` over ``make_frames(4, 720, 1280)``, one
  model carrying its clusters from frame to frame: ``slice_labels`` int16
  [4, 720, 1280] and ``slice_clusters`` float32 [4, 1600, 6] (each frame's
  final clusters, ``to_yxmrgb``: y, x, num_members, r, g, b);
* ``BatchedSlic(num_components=1600, batch_mode="stack")`` over the two
  batches of four frames of ``make_frames(8, 720, 1280, seed=1)``, one
  model for both: ``batch_labels`` int16 [2, 4, 720, 1280].

About a minute on the CPU; the file is ~1.3 MB.
"""

from __future__ import annotations

import os
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"

import numpy as np  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data", "port_720p_ref.npz")


def main() -> int:
    import jax
    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, ROOT)
    from chip_smoke import BATCH, H720, K720, W720, make_frames
    from fast_slic_tpu import Slic
    from fast_slic_tpu.parallel.batch import BatchedSlic

    t0 = time.perf_counter()
    slic = Slic(num_components=K720)
    labels, clusters = [], []
    for f in make_frames(4, H720, W720):
        labels.append(np.asarray(slic.iterate(f)))
        clusters.append(slic.slic_model.to_yxmrgb().astype(np.float32))
        print("slice frame %d: %.1f s" % (len(labels),
                                          time.perf_counter() - t0),
              flush=True)
    more = make_frames(2 * BATCH, H720, W720, seed=1)
    bs = BatchedSlic(num_components=K720, batch_mode="stack")
    batch = [np.asarray(bs.iterate(np.stack(more[t * BATCH:(t + 1) * BATCH])))
             for t in range(2)]
    print("batches: %.1f s" % (time.perf_counter() - t0), flush=True)

    slice_labels = np.stack(labels)
    batch_labels = np.stack(batch)
    for name, lab in (("slice", slice_labels), ("batch", batch_labels)):
        if lab.min() < 0 or lab.max() >= K720:
            raise SystemExit("%s labels outside [0, K)" % name)
    np.savez_compressed(
        OUT, slice_labels=slice_labels.astype(np.int16),
        slice_clusters=np.stack(clusters),
        batch_labels=batch_labels.astype(np.int16))
    print("wrote %s: %d bytes" % (OUT, os.path.getsize(OUT)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
