#!/usr/bin/env python3
"""Write tests/data/port_crf_ref.npz: the JAX package's superpixel graphs,
densities and CRF posteriors on the four 720p frames of
tests/data/port_720p_ref.npz, for tests/test_torch_graph.py,
tests/test_torch_crf.py and chip_smoke.py to hold the PyTorch port against.

    JAX_PLATFORMS=cpu python3 scripts/make_port_fixture_crf.py

Runs on the CPU from the fixture's ``slice_labels`` and ``slice_clusters``
(SLIC is not run again).  For each frame t, a JAX ``SlicModel(1600)``
holding that frame's clusters gives:

* ``adj_nbr`` int16 [4, 1600, 12] (-1 pad) and ``adj_lens`` [4, 1600]:
  ``get_connectivity`` of the labels;
* ``knn_nbr`` int16 [4, 1600, 4] (-1 pad) and ``knn_lens`` [4, 1600]:
  ``get_knn_connectivity(labels, 4)``;
* ``density`` u8 [4, 1600] and ``density_mask`` u8 [4, 720, 1280]:
  ``get_mask_density`` of ``chip_smoke.crf_mask(t)`` and its
  ``broadcast_density_to_mask``;
* ``q_adj`` and ``q_knn`` float32 [4, 21, 1600]: the posteriors of a
  ``SimpleCRF(21, 1600)`` fed each frame by ``push_slic_frame`` (adjacency,
  then ``knn=4``), ``set_proba(chip_smoke.crf_proba(t))``, then
  ``initialize(); inference(5)``.

A few seconds on the CPU; the file is ~0.8 MB.
"""

from __future__ import annotations

import os
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"

import numpy as np  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data", "port_crf_ref.npz")


class _SlicResult:
    """What ``SimpleCRF.push_slic_frame`` reads of a Slic object."""

    def __init__(self, slic_model, labels):
        self.slic_model = slic_model
        self.last_assignment = labels


def jax_model(K: int, yxmrgb: np.ndarray):
    """A JAX SlicModel holding the clusters of a [K, 6] yxmrgb row."""
    from fast_slic_tpu import SlicModel
    from fast_slic_tpu import cluster as cl
    st = cl.zeros(K)
    st.y[:], st.x[:] = yxmrgb[:, 0], yxmrgb[:, 1]
    st.num_members[:] = yxmrgb[:, 2].astype(np.uint32)
    st.r[:], st.g[:], st.b[:] = yxmrgb[:, 3], yxmrgb[:, 4], yxmrgb[:, 5]
    model = SlicModel(K)
    model._clusters = st
    model.initialized = True
    return model


def _pad(nbr, lens, D):
    out = np.full((nbr.shape[0], D), -1, np.int16)
    out[:, :nbr.shape[1]] = nbr
    return out


def main() -> int:
    import jax
    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, ROOT)
    from chip_smoke import (CRF_C, CRF_ITERS, CRF_KNN, FIXTURE, K720,
                            crf_mask, crf_proba)
    from fast_slic_tpu.crf import SimpleCRF

    t0 = time.perf_counter()
    ref = np.load(FIXTURE)
    out = {k: [] for k in ("adj_nbr", "adj_lens", "knn_nbr", "knn_lens",
                           "density", "density_mask")}
    crfs = {"q_adj": SimpleCRF(CRF_C, K720), "q_knn": SimpleCRF(CRF_C, K720)}
    for t, (labels, yxm) in enumerate(zip(ref["slice_labels"],
                                          ref["slice_clusters"])):
        model = jax_model(K720, yxm)
        nbr, lens = model.get_connectivity(labels).matrix()
        out["adj_nbr"].append(_pad(nbr, lens, 12))
        out["adj_lens"].append(lens.astype(np.int16))
        nbr, lens = model.get_knn_connectivity(labels, CRF_KNN).matrix()
        out["knn_nbr"].append(_pad(nbr, lens, CRF_KNN))
        out["knn_lens"].append(lens.astype(np.int16))
        dens = model.get_mask_density(crf_mask(t, *labels.shape), labels)
        out["density"].append(dens)
        out["density_mask"].append(
            model.broadcast_density_to_mask(dens, labels))
        slic = _SlicResult(model, labels)
        for name, crf in crfs.items():
            frame = crf.push_slic_frame(
                slic, knn=CRF_KNN if name == "q_knn" else None)
            frame.set_proba(crf_proba(t, CRF_C, K720))
        print("frame %d: %.1f s" % (t + 1, time.perf_counter() - t0),
              flush=True)
    arrays = {k: np.stack(v) for k, v in out.items()}
    for name, crf in crfs.items():
        crf.initialize()
        crf.inference(CRF_ITERS)
        arrays[name] = np.asarray(crf.inferred_stack(), np.float32)
        if not np.isfinite(arrays[name]).all():
            raise SystemExit("%s: posteriors not finite" % name)
    print("crf: %.1f s" % (time.perf_counter() - t0), flush=True)
    np.savez_compressed(OUT, **arrays)
    print("wrote %s: %d bytes" % (OUT, os.path.getsize(OUT)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
