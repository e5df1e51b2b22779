"""PyTorch port: the float-distance variants end to end.

* ``pipeline.iterate_graph`` against ``fast_slic_tpu.pipeline
  .compiled_iterate`` with arch "xla", from the same cluster state, per
  variant: exact for real, real_l2 and real_noq (labels, raw assignment,
  min_dists, every cluster field, flags); for LSC, label agreement >= 0.999
  and clusters within rtol 1e-5 (its f32 sums differ in order, see
  tests/test_torch_lsc.py);
* the public classes with ``device="cpu"`` reproduce the goldens
  ``real_k256``, ``l2_k256`` and ``noq_k256`` (agreement 1.0, y/x/
  num_members equal) and ``lsc_k256`` (agreement >= 0.999), the check of
  tests/test_golden.py;
* the runner's candidate-overflow re-run works for them (the golden
  ``real_k256`` also takes the CCA tie escalation);
* the LSC shims import and the variant names resolve.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from conftest import make_image
from fast_slic_tpu import cluster as jcl
from fast_slic_tpu import pipeline as jpipe
from fast_slic_tpu.config import StaticConfig as JaxConfig
from fast_slic_tpu_torch import (LSC, SlicModel, SlicRealDist, SlicRealDistL2,
                                 SlicRealDistNoQ)
from fast_slic_tpu_torch import cluster as tcl
from fast_slic_tpu_torch import pipeline as tpipe
from fast_slic_tpu_torch import runner
from fast_slic_tpu_torch.config import RuntimeParams, StaticConfig
from torch_threads import one_torch_thread  # noqa: F401

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "golden_ref.npz")


@pytest.mark.parametrize("variant", ["real", "real_l2", "real_noq", "lsc"])
@pytest.mark.parametrize("flags,stride", [({}, 3),
                                          ({"manhattan_spatial_dist": False},
                                           1)])
def test_iterate_matches_jax_pipeline(rng, variant, flags, stride):
    H, W, K = 96, 128, 64
    image = make_image(rng, H, W)
    st = jcl.initialize_clusters(image, K)
    cfg_j = JaxConfig(H=H, W=W, K=K, arch="xla", variant=variant, **flags)
    scal_j = jpipe.derive_scalars(cfg_j, 10.0, 0.25, 0.05)
    out_j = jpipe.compiled_iterate(cfg_j, 10, stride)(
        image, jax.tree.map(jnp.asarray, st), scal_j)

    cfg_t = StaticConfig(H=H, W=W, K=K, variant=variant, **flags)
    scal_t = tpipe.derive_scalars(cfg_t, 10.0, 0.25)
    assert scal_t.c_spatial == scal_j.c_spatial
    st_t = tcl.clusters_from_numpy(st.y, st.x, st.r, st.g, st.b,
                                   st.num_members, st.is_active,
                                   st.is_updatable).to_torch("cpu")
    out_t = tpipe.iterate_graph(torch.from_numpy(image), st_t, cfg_t, scal_t,
                                10, stride)
    assert out_t.min_dists.dtype == torch.float32
    got = out_t.clusters.as_numpy()
    fields = ("y", "x", "r", "g", "b", "num_members", "is_active",
              "is_updatable")
    if variant == "lsc":
        agree = float((out_t.labels.numpy() == np.asarray(out_j.labels)
                       ).mean())
        assert agree >= 0.999, agree
        for f in fields:
            np.testing.assert_allclose(getattr(got, f),
                                       np.asarray(getattr(out_j.clusters, f)),
                                       rtol=1e-5, err_msg=f)
        return
    np.testing.assert_array_equal(out_t.raw_assignment.numpy(),
                                  np.asarray(out_j.raw_assignment))
    np.testing.assert_array_equal(out_t.labels.numpy(),
                                  np.asarray(out_j.labels))
    np.testing.assert_array_equal(out_t.min_dists.numpy(),
                                  np.asarray(out_j.min_dists))
    assert bool(out_t.cca_tie) == bool(np.asarray(out_j.cca_tie))
    assert bool(out_t.cand_overflow) == bool(np.asarray(out_j.cand_overflow))
    for f in fields:
        np.testing.assert_array_equal(getattr(got, f),
                                      np.asarray(getattr(out_j.clusters, f)),
                                      err_msg=f)


@pytest.fixture(scope="module")
def golden():
    return np.load(DATA)


@pytest.mark.parametrize("name,cls,kw", [
    ("real_k256", SlicRealDist, {}),
    ("l2_k256", SlicRealDistL2, {}),
    ("noq_k256", SlicRealDistNoQ, {"float_color": False}),
    ("lsc_k256", LSC, {}),
])
def test_golden_through_public_classes(golden, name, cls, kw):
    image = golden["image"]
    slic = cls(num_components=256, min_size_factor=0.1, device="cpu", **kw)
    labels = slic.iterate(image)
    assert labels.dtype == np.int16 and slic.last_assignment is labels
    agreement = float((labels.astype(np.int64) == golden[name]).mean())
    ref = golden[name + "_clusters"]
    yxm = slic.slic_model.to_yxmrgb()
    if cls is LSC:
        assert agreement >= 0.999, agreement
        return
    assert agreement == 1.0, agreement
    np.testing.assert_array_equal(yxm[:, 0], ref[:, 0])
    np.testing.assert_array_equal(yxm[:, 1], ref[:, 1])
    np.testing.assert_array_equal(yxm[:, 2], ref[:, 5])


@pytest.mark.parametrize("variant", ["real_noq", "lsc"])
def test_cand_overflow_reruns_with_more_slots(rng, variant):
    H, W, K = 48, 64, 30
    image = make_image(rng, H, W)
    params = RuntimeParams(max_iter=4)

    def run(slots):
        return runner.run_iterate(
            StaticConfig(H=H, W=W, K=K, variant=variant, cand_slots=slots),
            image, tcl.initialize_clusters(image, K), params, "cpu")

    small, full = run(2), run(18)
    assert small.cand_slots == 18 and full.cand_slots == 18
    np.testing.assert_array_equal(small.labels, full.labels)


def test_lsc_shims_and_variant_resolution():
    from fast_slic_tpu_torch.avx2 import LSCAvx2
    from fast_slic_tpu_torch.neon import LSCNeon
    for cls, arch in ((LSCAvx2, "x64/avx2"), (LSCNeon, "arm/neon")):
        m = cls(num_components=9, device="cpu").slic_model
        assert issubclass(cls, LSC) and m.arch_name == arch
        assert m._static_config(32, 32).variant == "lsc"
    for cls, variant in ((SlicRealDist, "real"), (SlicRealDistL2, "real_l2"),
                         (SlicRealDistNoQ, "real_noq"), (LSC, "lsc")):
        assert cls(num_components=9, device="cpu").slic_model._static_config(
            32, 32).variant == variant
    noq = SlicRealDistNoQ(num_components=9, float_color=False, device="cpu")
    assert noq.slic_model._static_config(32, 32).float_color is False
    m = SlicModel(9, device="cpu")
    m.real_dist, m.real_dist_type = True, "bogus"
    with pytest.raises(RuntimeError, match="real_dist_type"):
        m._static_config(32, 32)

