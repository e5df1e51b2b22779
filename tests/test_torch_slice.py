"""PyTorch port: the whole slice against the JAX package and the goldens.

* ``pipeline.iterate_graph`` (labels, raw assignment, clusters, flags)
  equals ``fast_slic_tpu.pipeline.compiled_iterate`` with arch "xla", from
  the same cluster state carried over with ``clusters_from_numpy``;
* the public API reproduces ``tests/data/golden_ref.npz`` on the six
  standard cases, the check of tests/test_golden.py;
* the package imports without jax, and its API contracts hold.
Exact.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from conftest import make_image
from fast_slic_tpu import cluster as jcl
from fast_slic_tpu import pipeline as jpipe
from fast_slic_tpu.config import StaticConfig as JaxConfig
from fast_slic_tpu_torch import Slic, SlicAvx2, SlicModel, SlicNeon
from fast_slic_tpu_torch import cluster as tcl
from fast_slic_tpu_torch import pipeline as tpipe
from fast_slic_tpu_torch import runner
from fast_slic_tpu_torch.config import RuntimeParams, StaticConfig
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data", "golden_ref.npz")

GOLDEN_CASES = {
    "std_k256_msf01": (256, {}, {}),
    "std_k256_msf0": (256, {}, {"min_size_factor": 0.0}),
    "std_k100_nolab": (100, {"convert_to_lab": False},
                       {"min_size_factor": 0.25}),
    "std_k256_euclid": (256, {"manhattan_spatial_dist": False}, {}),
    "std_k256_stride1": (256, {}, {"subsample_stride": 1}),
    "std_k256_comp20": (256, {}, {"compactness": 20.0}),
}


@pytest.mark.parametrize("flags,stride", [({}, 3),
                                          ({"manhattan_spatial_dist": False},
                                           1)])
def test_iterate_matches_jax_pipeline(rng, flags, stride):
    H, W, K = 96, 128, 64
    image = make_image(rng, H, W)
    st = jcl.initialize_clusters(image, K)
    cfg_j = JaxConfig(H=H, W=W, K=K, arch="xla", **flags)
    scal_j = jpipe.derive_scalars(cfg_j, 10.0, 0.25, 0.05)
    out_j = jpipe.compiled_iterate(cfg_j, 10, stride)(
        image, jax.tree.map(jnp.asarray, st), scal_j)

    cfg_t = StaticConfig(H=H, W=W, K=K, **flags)
    scal_t = tpipe.derive_scalars(cfg_t, 10.0, 0.25)
    st_t = tcl.clusters_from_numpy(st.y, st.x, st.r, st.g, st.b,
                                   st.num_members, st.is_active,
                                   st.is_updatable).to_torch("cpu")
    out_t = tpipe.iterate_graph(torch.from_numpy(image), st_t, cfg_t, scal_t,
                                10, stride)

    np.testing.assert_array_equal(out_t.raw_assignment.numpy(),
                                  np.asarray(out_j.raw_assignment))
    np.testing.assert_array_equal(out_t.labels.numpy(),
                                  np.asarray(out_j.labels))
    np.testing.assert_array_equal(out_t.min_dists.numpy(),
                                  np.asarray(out_j.min_dists))
    assert bool(out_t.cca_tie) == bool(np.asarray(out_j.cca_tie))
    assert bool(out_t.cand_overflow) == bool(np.asarray(out_j.cand_overflow))
    got = out_t.clusters.as_numpy()
    for f in ("y", "x", "r", "g", "b", "num_members", "is_active",
              "is_updatable"):
        np.testing.assert_array_equal(getattr(got, f),
                                      np.asarray(getattr(out_j.clusters, f)),
                                      err_msg=f)


@pytest.fixture(scope="module")
def golden():
    return np.load(DATA)


@pytest.mark.parametrize("name", sorted(GOLDEN_CASES))
def test_golden_exact(golden, name):
    K, flags, over = GOLDEN_CASES[name]
    image = golden["image"]
    H, W = image.shape[:2]
    cfg = StaticConfig(H=H, W=W, K=K, **flags)
    params = RuntimeParams(compactness=10.0, min_size_factor=0.1,
                           subsample_stride=3, max_iter=10)
    for k, v in over.items():
        setattr(params, k, v)
    res = runner.run_iterate(cfg, image, tcl.initialize_clusters(image, K),
                             params, "cpu")
    assert res.labels.dtype == np.int16
    agreement = float((res.labels.astype(np.int64) == golden[name]).mean())
    assert agreement == 1.0, agreement
    ref = golden[name + "_clusters"]
    np.testing.assert_array_equal(res.clusters.y, ref[:, 0])
    np.testing.assert_array_equal(res.clusters.x, ref[:, 1])
    np.testing.assert_array_equal(
        res.clusters.num_members.astype(np.float32), ref[:, 5])


def test_public_api_matches_golden(golden):
    # the golden std_k256_msf01 case through SlicAvx2 (defaults but msf)
    image = golden["image"]
    slic = SlicAvx2(num_components=256, min_size_factor=0.1, device="cpu")
    labels = slic.iterate(image)
    np.testing.assert_array_equal(labels, golden["std_k256_msf01"])
    assert slic.last_assignment is labels
    np.testing.assert_array_equal(slic.slic_model.to_yxmrgb()[:, 0],
                                  golden["std_k256_msf01_clusters"][:, 0])


def test_imports_without_jax():
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.path.insert(0, %r); import fast_slic_tpu_torch as p; "
            "import fast_slic_tpu_torch.runner, fast_slic_tpu_torch.kernels, "
            "fast_slic_tpu_torch.parallel.batch; "
            "assert 'jax' not in [m.split('.')[0] for m, v in "
            "sys.modules.items() if v is not None]; print('ok')" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_cand_overflow_reruns_with_more_slots(rng):
    H, W, K = 48, 64, 30
    image = make_image(rng, H, W)
    params = RuntimeParams(max_iter=4)
    small = runner.run_iterate(StaticConfig(H=H, W=W, K=K, cand_slots=2),
                               image, tcl.initialize_clusters(image, K),
                               params, "cpu")
    assert small.cand_slots == 18          # 2 -> 6 -> 18, then kept
    full = runner.run_iterate(StaticConfig(H=H, W=W, K=K, cand_slots=18),
                              image, tcl.initialize_clusters(image, K),
                              params, "cpu")
    assert full.cand_slots == 18           # no overflow at 18 slots
    np.testing.assert_array_equal(small.labels, full.labels)


def test_default_device_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works")
    with pytest.raises(RuntimeError, match="cuda"):
        Slic(num_components=16)


def test_constructor_contracts():
    with pytest.raises(NotImplementedError):
        SlicModel(10, "riscv", device="cpu")
    with pytest.raises(ValueError):
        SlicModel(65534, device="cpu")
    with pytest.raises(ValueError):
        SlicModel(0, device="cpu")
    for cls in (Slic, SlicAvx2, SlicNeon):
        assert cls(num_components=9, device="cpu").num_components == 9
    for arch in ("standard", "x64/avx2", "arm/neon", "xla", "pallas"):
        SlicModel(4, arch, device="cpu")
    for variant in ("standard", "real", "real_l2", "real_noq", "lsc"):
        assert StaticConfig(H=8, W=8, K=4, variant=variant).variant == variant
    with pytest.raises(RuntimeError):
        StaticConfig(H=8, W=8, K=4, variant="bogus")


@pytest.mark.parametrize("attr", ["debug_mode", "profile"])
def test_debug_and_profile_run(image_factory, attr):
    """Both were outside the slice until the rest of the API was ported:
    each now runs and gives the default run's labels."""
    image = image_factory(32, 32)
    ref = SlicModel(4, device="cpu")
    ref.initialize(image)
    m = SlicModel(4, device="cpu")
    m.initialize(image)
    setattr(m, attr, True)
    np.testing.assert_array_equal(m.iterate(image, 2, 10, 0.25, 3),
                                  ref.iterate(image, 2, 10, 0.25, 3))
    assert bool(m.last_recorder_report) == (attr == "debug_mode")


def test_paths_outside_the_slice_raise(image_factory):
    from fast_slic_tpu_torch.parallel.batch import BatchedSlic
    from fast_slic_tpu_torch.parallel.mesh import make_mesh
    image = image_factory(32, 32)
    # multi-device meshes are ported: two groups of a frame equal no mesh
    frames = np.stack([image, image_factory(32, 32)])
    mesh = make_mesh(devices=[torch.device("cpu")] * 2, data=2)
    got = BatchedSlic(num_components=4, mesh=mesh).iterate(frames, 2)
    ref = BatchedSlic(num_components=4, device="cpu").iterate(frames, 2)
    np.testing.assert_array_equal(got.numpy(), ref.numpy())
    m = SlicModel(4, device="cpu")
    # the graph utilities are ported: one label has no neighbours
    conn = m.get_connectivity(np.zeros((4, 4), np.int16))
    assert conn.tolist() == [[], [], [], []]
    with pytest.raises(RuntimeError):
        m.iterate(image, 2, 10, 0.25, 3)     # not initialized


def test_cluster_state_round_trip(image_factory):
    image = image_factory(40, 40)
    slic = Slic(num_components=9, device="cpu")
    slic.iterate(image, max_iter=3)
    model = slic.slic_model
    dicts = model.clusters
    assert len(dicts) == 9 and dicts[0]["number"] == 0
    other = SlicModel(9, device="cpu")
    other.clusters = dicts
    np.testing.assert_array_equal(other.to_yxmrgb()[:, :3],
                                  model.to_yxmrgb()[:, :3])
    copy = model.copy()
    assert copy.initialized and copy is not model
    np.testing.assert_array_equal(copy.to_yxmrgb(), model.to_yxmrgb())
    # a second iterate starts from the carried state, like the reference
    labels = Slic(num_components=9, slic_model=model,
                  device="cpu").iterate(image, max_iter=2)
    assert labels.shape == (40, 40) and labels.min() >= 0
