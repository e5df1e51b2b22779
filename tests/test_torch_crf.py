"""PyTorch port: SimpleCRF against the JAX package's
(``fast_slic_tpu/models/crf.py``), on the CPU.

Every test of ``tests/test_crf.py`` on the port, each result beside the JAX
CRF's on the same seeded inputs: the lifecycle, the unary setters, the
yxmrgb and connectivity round trips, both pairwise energies, mean-field
inference at T=1 and T=3 from the unaries (also against that file's
straight-line numpy reference), from a carried device stack and from host
posteriors (also with changed params and compatibilities), and
``inferred_stack`` residency.  One test runs at full width: the four 720p
frames of ``tests/data/port_720p_ref.npz`` wired in by ``push_slic_frame``
(adjacency, and ``knn=4``), N=1600, C=21, ``inference(5)``, against the
JAX posteriors in ``tests/data/port_crf_ref.npz``.

Posteriors within rtol=2e-4, atol=1e-6 (the tolerance of
``tests/test_crf.py``: the port sums each message over the neighbour list,
the JAX package as a dense product), and the argmax class of at least
0.999 of the nodes equal.
"""

import gc
import os

import numpy as np
import pytest
import torch

from fast_slic_tpu.crf import SimpleCRF as JaxCRF
from fast_slic_tpu_torch import SimpleCRF, SimpleCRFFrame, SlicModel
from fast_slic_tpu_torch import cluster as tcl
from fast_slic_tpu_torch import crf as crf_reexport
from torch_threads import one_torch_thread  # noqa: F401

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
RTOL, ATOL = 2e-4, 1e-6


def _pair(C, N):
    return SimpleCRF(C, N, device="cpu"), JaxCRF(C, N)


def test_reexport_and_default_device():
    assert crf_reexport.SimpleCRF is SimpleCRF
    assert crf_reexport.SimpleCRFFrame is SimpleCRFFrame
    if torch.cuda.is_available():
        assert SimpleCRF(3, 4).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            SimpleCRF(3, 4)


def test_lifecycle():
    for crf in _pair(3, 100):
        assert crf.space_size == 300
        assert (crf.first_time, crf.last_time, crf.num_frames) == (-1, -1, 0)
        with pytest.raises(IndexError):
            crf.get_frame(10)
        assert crf.pop_frame() == -1
        f1 = crf.push_frame()
        assert (crf.num_frames, crf.first_time, crf.last_time) == (1, 0, 0)
        assert f1.space_size == 300 and f1.time == 0
        assert crf.get_frame(0).time == 0
        f2 = crf.push_frame()
        assert (crf.num_frames, crf.first_time, crf.last_time) == (2, 0, 1)
        assert crf.pop_frame() == 0
        assert crf.first_time == crf.last_time == 1
        assert f2.time == 1


def test_frame_outlives_crf():
    crf = SimpleCRF(3, 100, device="cpu")
    frame = crf.push_frame()
    del crf
    gc.collect()
    frame.unaries
    np.testing.assert_array_equal(frame.get_inferred(), np.zeros((3, 100)))


def test_unary_setters():
    prob = np.array([[0.7, 0.5, 0.1], [0.1, 0.3, 0.15], [0.2, 0.2, 0.75]],
                    np.float32)
    seen = []
    for crf in _pair(3, 3):
        frame = crf.push_frame()
        frame.set_unbiased()
        got = [frame.unaries]
        frame.set_mask(np.array([0, 1, 2], np.int32), 0.5)
        got.append(frame.unaries)
        frame.set_proba(prob)
        got.append(frame.get_unary())
        got.append(frame.get_inferred())
        crf.initialize()
        got.append(frame.get_inferred())
        frame.set_unbiased()
        frame.reset_inferred()
        got.append(frame.get_inferred())
        frame.normalize()
        got.append(frame.get_inferred())
        seen.append(got)
    port, jax_ = seen
    for a, b in zip(port, jax_):
        np.testing.assert_array_equal(a, b)
    assert np.allclose(port[0], np.log(3))
    expected = -np.log(np.where(np.eye(3, dtype=bool), 2 / 3.0, 1 / 6.0))
    assert np.allclose(port[1], expected, atol=1e-6)
    assert np.allclose(port[2], -np.log(prob), atol=1e-6)
    assert np.allclose(port[3], 0)
    assert np.allclose(port[4], prob, atol=1e-6)
    assert np.allclose(port[5], 1 / 3.0, atol=1e-6)


def test_yxmrgb_roundtrip_and_connectivity():
    data = np.array([[1, 2, 1, 3, 4, 5],
                     [6, 7, 2, 8, 9, 10],
                     [11.7, 12, 3, 13, 14, 15]])
    for crf in _pair(3, 3):
        frame = crf.push_frame()
        frame.set_yxmrgb(data)
        assert frame.get_yxmrgb() == data.astype(np.int32).tolist()
        assert frame.get_connectivity() == [[], [], []]
        with pytest.raises(TypeError):
            frame.set_connectivity([None, None, None])
        frame.set_connectivity([[0, 1], [2], [0]])
        assert frame.get_connectivity() == [[0, 1], [2], [0]]
        assert frame.connected_nodes(0) == [0, 1]
        with pytest.raises(ValueError):
            frame.set_connectivity([[0]])
        with pytest.raises(ValueError):
            frame.set_yxmrgb(np.zeros((3, 5)))


def test_spatial_energy_formula():
    w, srgb, sxy = 1.9, 3.5, 2.4
    vals = []
    for crf in _pair(3, 2):
        crf.spatial_w, crf.spatial_srgb, crf.spatial_sxy = w, srgb, sxy
        crf.spatial_smooth_w = 0.5
        assert np.isclose(crf.spatial_w, w)
        frame = crf.push_frame()
        frame.set_yxmrgb(np.array([[1, 1, 1, 1, 2, 6],
                                   [0, 0, 1, 4, 5, 3]], np.int32))
        vals.append([frame.spatial_pairwise_energy(0, 1),
                     frame.spatial_pairwise_energy(1, 0),
                     frame.spatial_pairwise_energy(0, 0)])
        with pytest.raises(ValueError):
            frame.spatial_pairwise_energy(0, 2)
    expected = w * np.exp(
        -((1 - 4) ** 2 + (2 - 5) ** 2 + (6 - 3) ** 2) / (2 * srgb ** 2)
        - ((1 - 0) ** 2 + (1 - 0) ** 2) / (2 * sxy ** 2)) + 0.5 * np.exp(
        -2 / (2 * 3.0 ** 2))
    assert np.isclose(vals[0][0], expected, rtol=1e-5)
    assert vals[0][2] == 0
    np.testing.assert_allclose(vals[0], vals[1], rtol=1e-6)


def test_temporal_energy_formula():
    w, srgb = 1.9, 3.5
    vals = []
    for crf in _pair(3, 1):
        crf.temporal_w, crf.temporal_srgb = w, srgb
        f1, f2 = crf.push_frame(), crf.push_frame()
        f1.set_yxmrgb(np.array([[0, 0, 1, 1, 2, 6]], np.int32))
        f2.set_yxmrgb(np.array([[0, 0, 1, 4, 5, 3]], np.int32))
        vals.append([f1.temporal_pairwise_energy(0, f2),
                     f2.temporal_pairwise_energy(0, f1),
                     f1.temporal_pairwise_energy(0, f1)])
        with pytest.raises(TypeError):
            f1.temporal_pairwise_energy(0, None)
    expected = w * np.exp(
        -((1 - 4) ** 2 + (2 - 5) ** 2 + (6 - 3) ** 2) / (2 * srgb ** 2))
    assert np.isclose(vals[0][0], expected, rtol=1e-5)
    assert vals[0][2] == 0
    np.testing.assert_allclose(vals[0], vals[1], rtol=1e-6)


def _fill(crf, rng, T, N, C):
    """tests/test_crf.py's random frames: features, up to three neighbours
    each (with a self-pair and a duplicate now and then), unaries."""
    for t in range(T):
        f = crf.push_frame()
        f.set_yxmrgb(np.concatenate(
            [rng.integers(0, 20, size=(N, 2)),
             rng.integers(0, 9, size=(N, 1)),
             rng.integers(0, 256, size=(N, 3))], axis=1).astype(np.int32))
        f.set_connectivity([rng.integers(0, N, size=rng.integers(0, 4))
                            .tolist() for _ in range(N)])
        proba = rng.random(size=(C, N)).astype(np.float32) + 0.05
        f.set_proba(proba / proba.sum(0))


def _posteriors(crf):
    return np.stack([crf.get_frame(t).get_inferred()
                     for t in range(crf.first_time, crf.last_time + 1)])


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert (got.argmax(-2) == want.argmax(-2)).mean() >= 0.999


@pytest.mark.parametrize("T", [1, 3])
def test_inference_matches_jax(T):
    C, N = 3, 7
    crfs = _pair(C, N)
    for crf in crfs:
        crf.spatial_sxy = 5.0
        _fill(crf, np.random.default_rng(1234), T, N, C)
        crf.initialize()
        crf.inference(2)
    _close(_posteriors(crfs[0]), _posteriors(crfs[1]))


@pytest.mark.parametrize("T", [1, 3])
def test_inference_matches_numpy(T):
    """tests/test_crf.py's straight-line numpy infer_once
    (simple-crf.cpp:62-151) run on the port's frames."""
    from test_crf import _numpy_infer_once
    C, N = 3, 7
    crf = SimpleCRF(C, N, device="cpu")
    crf.spatial_sxy = 5.0
    _fill(crf, np.random.default_rng(7), T, N, C)
    frames = [crf.get_frame(t) for t in range(T)]
    crf.initialize()
    qs = [f.get_inferred() for f in frames]
    for _ in range(2):
        qs = _numpy_infer_once(crf, frames, qs)
    crf.inference(2)
    for t, f in enumerate(frames):
        np.testing.assert_allclose(f.get_inferred(), qs[t], rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("T", [1, 3])
def test_inference_continues_from_carried_stack(T):
    """A second inference continues from the device stack; after a frame's
    get_inferred, from the host posteriors; after new params and
    compatibilities, with the energies staged again."""
    C, N = 4, 9
    crfs = _pair(C, N)
    outs = []
    for crf in crfs:
        crf.spatial_sxy = 6.0
        _fill(crf, np.random.default_rng(99), T, N, C)
        crf.initialize()
        crf.inference(2)
        crf.inference(3)            # from the stack left on the device
        got = [_posteriors(crf)]    # materializes every frame on the host
        crf.inference(1)            # from the host posteriors
        got.append(_posteriors(crf))
        crf.temporal_w = 4.0
        crf.spatial_smooth_w = 2.0
        crf.compat_by_class = np.array([1.0, 0.5, 2.0, 1.5], np.float32)
        crf.initialize()
        crf.inference(3)
        got.append(_posteriors(crf))
        outs.append(got)
    for a, b in zip(*outs):
        _close(a, b)


def test_inferred_stack_device_residency():
    C, N, T = 3, 5, 2
    rng = np.random.default_rng(1234)
    crf = SimpleCRF(C, N, device="cpu")
    frames = []
    for t in range(T):
        f = crf.push_frame()
        f.set_connectivity([[j for j in range(N) if j != i][:2]
                            for i in range(N)])
        proba = rng.random(size=(C, N)).astype(np.float32) + 0.05
        f.set_proba(proba / proba.sum(0))
        frames.append(f)
    assert crf.inferred_stack() is None  # nothing inferred yet
    crf.initialize()
    crf.inference(2)
    stack = crf.inferred_stack()
    assert isinstance(stack, torch.Tensor)
    assert stack.shape == (T, C, N) and stack.dtype == torch.float32
    assert stack.device == crf.device
    got = stack.cpu().numpy()
    for t, f in enumerate(frames):
        np.testing.assert_array_equal(got[t], f.get_inferred())
    # get_inferred materialized on the host -> the device stack is stale
    assert crf.inferred_stack() is None
    crf.inference(1)
    assert crf.inferred_stack() is not None
    frames[1].set_unbiased()
    frames[1].reset_inferred()
    assert crf.inferred_stack() is None


class _SlicResult:
    """What push_slic_frame reads of a Slic object."""

    def __init__(self, slic_model, labels):
        self.slic_model = slic_model
        self.last_assignment = labels


def _port_model(yxm):
    st = tcl.zeros(yxm.shape[0])
    st.y[:], st.x[:] = yxm[:, 0], yxm[:, 1]
    st.num_members[:] = yxm[:, 2].astype(np.uint32)
    st.r[:], st.g[:], st.b[:] = yxm[:, 3], yxm[:, 4], yxm[:, 5]
    model = SlicModel(yxm.shape[0], device="cpu")
    model._clusters = st
    model.initialized = True
    return model


@pytest.mark.parametrize("graph", ["adjacency", "knn"])
def test_crf_720p_matches_jax_fixture(graph):
    """The full-width CRF path: four 720p frames, N=1600, C=21."""
    from chip_smoke import CRF_C, CRF_ITERS, CRF_KNN, K720, crf_proba
    ref = np.load(os.path.join(DATA, "port_720p_ref.npz"))
    crf_ref = np.load(os.path.join(DATA, "port_crf_ref.npz"))
    crf = SimpleCRF(CRF_C, K720, device="cpu")
    for t, (labels, yxm) in enumerate(zip(ref["slice_labels"],
                                          ref["slice_clusters"])):
        frame = crf.push_slic_frame(
            _SlicResult(_port_model(yxm), labels),
            knn=CRF_KNN if graph == "knn" else None)
        frame.set_proba(crf_proba(t, CRF_C, K720))
    crf.initialize()
    crf.inference(CRF_ITERS)
    got = crf.inferred_stack().numpy()
    want = crf_ref["q_adj" if graph == "adjacency" else "q_knn"]
    assert got.shape == want.shape == (4, CRF_C, K720)
    assert np.isfinite(got).all()
    _close(got, want)
