"""PyTorch port: the rest of the public API against the JAX package.

* Short images, where a row remainder lies past the image (H=1, and
  ``subsample_stride`` > H): every variant and the preemptive grid give the
  JAX package's labels and clusters, and ``BatchedSlic`` in map and stack
  mode gives the single-frame results;
* ``debug_mode=True``: ``last_recorder_report`` is byte-equal to the JAX
  package's for the standard, real, real_l2 and real_noq variants and the
  preemptive grid; for LSC the parsed snapshots agree (assignments >=
  0.999, min_dists and clusters within rtol 1e-5, the tolerance of
  tests/test_torch_variants.py); the labels equal the default run's;
* ``profile=True``: the JAX report's structure
  (tests/test_api.py::test_profile_timing_report), with LSC's
  ``after_update`` sections, and the default labels;
* ``enforce_connectivity`` equals ``fast_slic_tpu.enforce_connectivity``
  on tests/test_api.py's blob, tests/test_cca.py's patterns, maps with
  unassigned pixels and maps whose areas tie at the top-K boundary, and
  keeps its write-back contract;
* ``SlicPallas`` and ``LSCPallas`` equal ``Slic`` and ``LSC``.

The JAX runs are shared through a module-scoped cache: each configuration
runs once, in debug mode, whose labels and clusters are the default run's.
"""

import json

import numpy as np
import pytest
import torch

import fast_slic_tpu as fj
import fast_slic_tpu_torch as ft
from conftest import make_image
from fast_slic_tpu_torch import cluster as tcl
from fast_slic_tpu_torch import runner
from fast_slic_tpu_torch.config import UNASSIGNED, RuntimeParams, StaticConfig
from fast_slic_tpu_torch.parallel.batch import BatchedSlic
from torch_threads import one_torch_thread  # noqa: F401

K = 4
# name: (image shape, subsample_stride, max_iter); every shape but
# "square" has iterations whose remainder lies at or past the last row
SHAPES = {"h1": ((1, 50), 3, 3), "stride7": ((4, 60), 7, 7),
          "square": ((40, 40), 3, 3)}
# name: (class name in both packages, constructor flags)
CONFIGS = {"standard": ("Slic", {}), "real": ("SlicRealDist", {}),
           "real_l2": ("SlicRealDistL2", {}),
           "real_noq": ("SlicRealDistNoQ", {}), "lsc": ("LSC", {}),
           "preemptive": ("Slic", {"preemptive": True})}
SHORT_CASES = [(s, c) for s in ("h1", "stride7") for c in CONFIGS]
RECORDER_CASES = SHORT_CASES + [("square", "standard"), ("square", "lsc")]
FIELDS = ("y", "x", "r", "g", "b", "num_members", "is_active",
          "is_updatable")
LSC_CLOSE = dict(rtol=1e-5, atol=1e-6)


def image_for(shape_name):
    (H, W), _, _ = SHAPES[shape_name]
    return make_image(np.random.default_rng(H * 1000 + W), H, W)


@pytest.fixture(scope="module")
def jax_run():
    """(shape, config) -> the JAX package's debug run: (labels, Clusters,
    recorder report), each configuration run once for the module."""
    cache = {}

    def run(shape_name, config):
        key = (shape_name, config)
        if key not in cache:
            _, stride, max_iter = SHAPES[shape_name]
            cls, kw = CONFIGS[config]
            slic = getattr(fj, cls)(num_components=K, subsample_stride=stride,
                                    debug_mode=True, **kw)
            labels = slic.iterate(image_for(shape_name), max_iter=max_iter)
            cache[key] = (labels, slic.slic_model._clusters,
                          slic.slic_model.last_recorder_report)
        return cache[key]

    return run


def port_run(shape_name, config, cls=None, **flags):
    """The port's model of ``config`` on the shape's image, on the CPU."""
    _, stride, max_iter = SHAPES[shape_name]
    name, kw = CONFIGS[config]
    slic = (cls or getattr(ft, name))(num_components=K,
                                      subsample_stride=stride, device="cpu",
                                      **kw, **flags)
    labels = slic.iterate(image_for(shape_name), max_iter=max_iter)
    return labels, slic.slic_model


def assert_clusters(got, ref, lsc=False):
    for f in FIELDS:
        a, b = np.asarray(getattr(got, f)), np.asarray(getattr(ref, f))
        if lsc:
            np.testing.assert_allclose(a.astype(np.float64),
                                       b.astype(np.float64), rtol=1e-5,
                                       err_msg=f)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f)


def assert_labels(got, ref, lsc=False):
    assert got.shape == ref.shape and got.dtype == ref.dtype
    if lsc:
        agree = float((got == ref).mean())
        assert agree >= 0.999, agree
    else:
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("shape_name,config", SHORT_CASES)
def test_short_images_match_jax(jax_run, shape_name, config):
    ref_labels, ref_clusters, _ = jax_run(shape_name, config)
    labels, model = port_run(shape_name, config)
    assert_labels(labels, ref_labels, config == "lsc")
    assert_clusters(model._clusters, ref_clusters, config == "lsc")


@pytest.mark.parametrize("shape_name", ["h1", "stride7"])
@pytest.mark.parametrize("mode", ["map", "stack"])
def test_batch_short_images(jax_run, shape_name, mode):
    """Frame 0 is the JAX run's image, frame 1 its mirror image; each frame
    equals the single-frame model on it."""
    (H, W), stride, max_iter = SHAPES[shape_name]
    img = image_for(shape_name)
    frames = np.stack([img, np.ascontiguousarray(img[:, ::-1])])
    bs = BatchedSlic(num_components=K, subsample_stride=stride,
                     batch_mode=mode, device="cpu")
    labels = bs.iterate(frames, max_iter=max_iter).numpy()
    np.testing.assert_array_equal(labels[0],
                                  jax_run(shape_name, "standard")[0])
    st = bs.state
    for f in range(2):
        slic = ft.Slic(num_components=K, subsample_stride=stride,
                       device="cpu")
        np.testing.assert_array_equal(
            labels[f], slic.iterate(frames[f], max_iter=max_iter))
        assert_clusters(tcl.Clusters(*(x[f] for x in st.fields())),
                        slic.slic_model._clusters)


@pytest.mark.parametrize("shape_name,config", RECORDER_CASES)
def test_recorder_matches_jax(jax_run, shape_name, config):
    ref_labels, _, ref_report = jax_run(shape_name, config)
    labels, model = port_run(shape_name, config, debug_mode=True)
    report = model.last_recorder_report
    if config != "lsc":
        np.testing.assert_array_equal(labels, ref_labels)
        assert report == ref_report
        return
    got, ref = json.loads(report), json.loads(ref_report)
    assert (got["height"], got["width"]) == (ref["height"], ref["width"])
    assert ([s["iteration"] for s in got["snapshots"]]
            == [s["iteration"] for s in ref["snapshots"]])
    for sg, sr in zip(got["snapshots"], ref["snapshots"]):
        agree = float(np.mean(np.array(sg["assignment"])
                              == np.array(sr["assignment"])))
        assert agree >= 0.999, (sg["iteration"], agree)
        np.testing.assert_allclose(np.array(sg["min_dists"], np.float64),
                                   np.array(sr["min_dists"], np.float64),
                                   **LSC_CLOSE)
        for cg, cr in zip(sg["clusters"], sr["clusters"]):
            for key in ("yx", "color"):
                np.testing.assert_allclose(cg[key], cr[key], rtol=1e-5)
            for key in ("is_updatable", "is_active", "number",
                        "num_members"):
                assert cg[key] == cr[key]


@pytest.mark.parametrize("config", list(CONFIGS))
def test_debug_labels_equal_default(config):
    ref, ref_model = port_run("square", config)
    labels, model = port_run("square", config, debug_mode=True)
    np.testing.assert_array_equal(labels, ref)
    assert_clusters(model._clusters, ref_model._clusters)
    snaps = model.last_recorder_snapshots
    _, _, max_iter = SHAPES["square"]
    assert snaps.iterations == list(range(-1, max_iter))
    assert snaps.assignments.shape == (max_iter + 1, 40, 40)
    dtype = np.int32 if config in ("standard", "preemptive") else np.float32
    assert snaps.min_dists.dtype == dtype
    # the first snapshot is the fill, each pass writes only its rows
    assert (snaps.assignments[0] == UNASSIGNED).all()
    for t in range(1, max_iter + 1):
        rem = (t - 1) % 3
        written = snaps.min_dists[t] != snaps.min_dists[0]
        assert not written[np.arange(40) % 3 != rem].any()
        assert written[rem::3].any()
    assert ref_model.last_recorder_report == ""
    assert ref_model.last_recorder_snapshots is None


def section_names(report):
    rep = json.loads(report)
    assert rep["name"] == "iterate"
    exe = [c for c in rep["children"] if c["name"] == "execute"]
    assert len(exe) == 1
    children = exe[0]["children"]
    assert all(isinstance(c.get("duration"), int) for c in children)
    return [c["name"] for c in children], [c["name"] for c in rep["children"]]


@pytest.mark.parametrize("config", ["standard", "lsc", "preemptive"])
def test_profile_timing_report(config):
    """slic_model.profile = True: one assign / update (/ after_update)
    section an iteration under execute, as the JAX package's report, and
    the default run's labels."""
    ref, _ = port_run("square", config)
    name, kw = CONFIGS[config]
    image = image_for("square")
    slic = getattr(ft, name)(num_components=K, device="cpu", **kw)
    slic.slic_model.profile = True
    labels = slic.iterate(image, max_iter=3)
    np.testing.assert_array_equal(labels, ref)
    names, top = section_names(slic.slic_model.last_timing_report)
    assert names.count("assign") == 3
    assert names.count("update") == 3
    assert names.count("after_update") == (3 if config == "lsc" else 0)
    assert names[:2] == ["cielab_conversion", "write_to_buffer"]
    assert names[-2:] == ["full_assign", "enforce_connectivity"]
    assert top == ["execute", "write_back"]
    assert slic.slic_model.last_recorder_report == ""


def test_debug_timing_report_is_phased():
    """debug_mode (with or without profile): the phases under execute with
    the loop as one section, as the JAX package's phased run, and the
    snapshots' copy as ``recorder``."""
    for profile in (False, True):
        slic = ft.Slic(num_components=K, debug_mode=True, device="cpu")
        slic.slic_model.profile = profile
        slic.iterate(image_for("square"), max_iter=2)
        names, top = section_names(slic.slic_model.last_timing_report)
        assert names == ["cielab_conversion", "iteration_loop",
                         "full_assign", "enforce_connectivity"]
        assert top == ["execute", "write_back", "recorder"]


def test_recorder_comes_from_the_kept_run(image_factory):
    """A candidate overflow re-runs the pipeline; the report is the kept
    run's alone."""
    image = image_factory(48, 64)
    params = RuntimeParams(max_iter=3)

    def run(slots):
        cfg = StaticConfig(H=48, W=64, K=48, cand_slots=slots,
                           debug_mode=True)
        return runner.run_iterate(cfg, image,
                                  tcl.initialize_clusters(image, 48), params,
                                  "cpu")

    small = run(2)
    assert small.cand_slots > 2
    kept = run(small.cand_slots)
    assert small.snapshots.iterations == [-1, 0, 1, 2]
    assert small.recorder_json == kept.recorder_json
    np.testing.assert_array_equal(small.labels, kept.labels)


@pytest.mark.parametrize("pair", [("SlicPallas", "Slic"),
                                  ("LSCPallas", "LSC")])
def test_pallas_aliases(pair):
    alias, base = (getattr(ft, n) for n in pair)
    image = image_for("square")
    a = alias(num_components=K, device="cpu")
    b = base(num_components=K, device="cpu")
    assert a.slic_model.arch_name == "pallas"
    np.testing.assert_array_equal(a.iterate(image), b.iterate(image))
    assert_clusters(a.slic_model._clusters, b.slic_model._clusters)


def _spiral():
    H = W = 33
    labels = np.ones([H, W], np.uint16)
    y, x, dy, dx = 0, 0, 0, 1
    seen = np.zeros([H, W], bool)
    for _ in range(H * W):
        labels[y, x] = 0
        seen[y, x] = True
        ny, nx = y + 2 * dy, x + 2 * dx
        if not (0 <= ny < H and 0 <= nx < W) or seen[ny, nx]:
            dy, dx = dx, -dy
        if 0 <= y + dy < H and 0 <= x + dx < W and not seen[y + dy, x + dx]:
            y, x = y + dy, x + dx
        else:
            break
    return labels


def _stripes():
    labels = np.zeros([12, 40], np.uint16)
    x = 1
    for w in (2, 3, 4, 5, 6):
        labels[:, x:x + w] = 1
        x += w + 2
    return labels


def _maps():
    rng = np.random.default_rng(1234)
    blob = np.zeros([10, 10], np.int16)
    blob[2:4, 2:4] = 1
    rand = rng.integers(0, 6, size=(24, 31)).astype(np.uint16)
    unassigned = rng.integers(0, 5, size=(20, 20)).astype(np.uint16)
    unassigned[unassigned == 4] = UNASSIGNED
    minus_one = rng.integers(-1, 5, size=(20, 20)).astype(np.int16)
    # equal-area blocks (tests/test_cca.py's tie case); with this seed the
    # top-K boundary ties and std::partial_sort keeps other components than
    # the device's rule
    blocks = np.random.default_rng(1).integers(0, 4, size=(6, 8))
    tied = np.kron(blocks, np.ones((4, 4))).astype(np.uint16)
    return {
        "blob_5": (blob, 5),
        "random_0": (rand, 0), "random_3": (rand, 3), "random_25": (rand, 25),
        "unassigned_4": (unassigned, 4),
        "minus_one_3": (minus_one, 3),
        "spiral_2": (_spiral(), 2),
        "uniform_10": (np.zeros([16, 16], np.uint16), 10),
        "stripes_1": (_stripes(), 1),
        "checkerboard_1": ((np.indices((17, 19)).sum(axis=0) % 2
                            ).astype(np.uint16), 1),
        "tied_0": (tied, 0), "tied_5": (tied, 5),
        "all_unassigned_1": (np.full([5, 7], -1, np.int32), 1),
    }


MAPS = _maps()


@pytest.mark.parametrize("name", list(MAPS))
def test_enforce_connectivity_matches_jax(name):
    labels, thres = MAPS[name]
    ref = fj.enforce_connectivity(labels.copy(), thres)
    got = ft.enforce_connectivity(labels.copy(), thres, device="cpu")
    assert got.dtype == labels.dtype
    np.testing.assert_array_equal(got, ref)


def test_enforce_connectivity_takes_the_tie_escalation():
    """The tied maps reach the exact selection, and the flagged device
    labels alone would differ from it there."""
    from fast_slic_tpu_torch.ops.cca import (enforce_connectivity_exact,
                                             enforce_connectivity_flagged)
    labels, thres = MAPS["tied_0"]
    t = torch.from_numpy(labels.astype(np.int32))
    flagged, tie = enforce_connectivity_flagged(t, 4, thres)
    exact, escalated = enforce_connectivity_exact(t, 4, thres)
    assert bool(tie) and escalated
    np.testing.assert_array_equal(
        exact.numpy(), fj.enforce_connectivity(labels.copy(), thres))
    assert not torch.equal(flagged, exact)


def test_enforce_connectivity_write_back():
    labels, thres = MAPS["random_3"]
    arr = labels.copy()
    out = ft.enforce_connectivity(arr, thres, device="cpu")
    assert out is arr
    assert not np.array_equal(arr, labels)
    frozen = labels.copy()
    frozen.setflags(write=False)
    out = ft.enforce_connectivity(frozen, thres, device="cpu")
    assert out is not frozen
    np.testing.assert_array_equal(frozen, labels)
    np.testing.assert_array_equal(out, fj.enforce_connectivity(
        labels.copy(), thres))
    listed = ft.enforce_connectivity(labels.tolist(), thres, device="cpu")
    np.testing.assert_array_equal(listed, out)


def test_enforce_connectivity_device_rule():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ft.enforce_connectivity(np.zeros([4, 4], np.int16), 1)
