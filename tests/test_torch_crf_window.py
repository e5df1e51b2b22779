"""PyTorch port: the temporal CRF window of the benchmark's ``crf720.window``
cell against its plain reference, on the CPU.

A stream of six panned frames, one call a frame through the port's public
objects (``SlicAvx2``, ``SimpleCRF.push_slic_frame(knn=4)``,
``pop_frame`` past a window of four, ``initialize(); inference(5)``,
``get_inferred``, ``broadcast_density_to_mask``), at 96x72, K=24, C=21,
with seeded Dirichlet unaries, beside ``bench_port/reference/slic_ref.py``
and ``bench_port/reference/crf_ref.py`` replaying the same frames: labels,
cluster state and every window frame's KNN lists equal, posteriors within
the configuration's ``posteriors_gap_max``, no pixel's class decisively
different.
The reference itself is held to the JAX package's KNN lists and posteriors
at 720p (``tests/data/port_crf_ref.npz``) and imports neither JAX nor a
package of this repository.
"""

import ast
import collections
import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

import fast_slic_tpu_torch as ft
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "bench_port")
CRF_REF = os.path.join(BENCH, "reference", "crf_ref.py")
CONFIG = json.load(open(os.path.join(BENCH, "configs", "crf_720p_c21.json")))
DATA = os.path.join(ROOT, "tests", "data")

H, W, K, C, T, KNN, ITERS, FRAMES = 72, 96, 24, 21, 4, 4, 5, 6


def _load(path, name):
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[name]


crf_ref = _load(CRF_REF, "bench_crf_ref")
slic_ref = _load(os.path.join(BENCH, "reference", "slic_ref.py"),
                 "bench_slic_ref")
frames_lib = _load(os.path.join(BENCH, "frames.py"), "bench_frames")


@pytest.mark.parametrize("seed", [11, 2 ** 31 + 5, 987654321])
def test_window_matches_the_reference(seed):
    clip = frames_lib.clip(H, W, FRAMES, 8, 2.0, seed, 0, "cpu")
    slic = ft.SlicAvx2(num_components=K, device="cpu")
    crf = ft.SimpleCRF(C, K, device="cpu")
    p = slic_ref.Params(H=H, W=W, K=K)
    tables = slic_ref.lab_tables()
    st = None
    ref = collections.deque(maxlen=T)          # (feat, nbr, unary)
    gap_limit = CONFIG["limits"]["posteriors_gap_max"]
    tie = CONFIG["class_map_tie_gap"]
    for t in range(FRAMES):
        proba = crf_ref.dirichlet(seed, t, C, K)
        # the port's call
        labels = slic.iterate(clip[t])
        fr = crf.push_slic_frame(slic, knn=KNN)
        fr.set_proba(proba)
        if crf.num_frames > T:
            crf.pop_frame()
        crf.initialize()
        crf.inference(ITERS)
        cls = fr.get_inferred().argmax(0).astype(np.uint8)
        class_map = slic.slic_model.broadcast_density_to_mask(cls, labels)
        # the reference's
        if st is None:
            st = slic_ref.seed_state(clip[t:t + 1], K, "cpu")
        ref_labels = slic_ref.iterate(torch.from_numpy(clip[t:t + 1]), st, p,
                                      tables=tables)[0]
        nbr, lens = crf_ref.knn(st.y, st.x, H, W, KNN)
        ref.append((crf_ref.features(st.y, st.x, st.num_members, st.r, st.g,
                                     st.b)[0], nbr[0], lens[0],
                    crf_ref.unaries(proba)))
        feat, nbrs, lenss, unary = (torch.stack(a) for a in zip(*ref))
        q = crf_ref.meanfield(feat, nbrs, unary, ITERS)

        np.testing.assert_array_equal(labels, ref_labels.numpy())
        np.testing.assert_array_equal(slic.slic_model.to_yxmrgb(),
                                      st.yxmrgb()[0])
        window = [crf.get_frame(i) for i in range(crf.first_time,
                                                  crf.last_time + 1)]
        assert [f.time for f in window] == list(range(max(0, t - T + 1),
                                                      t + 1))
        for i, f in enumerate(window):
            got = np.full((K, KNN), -1, np.int64)
            got[:, :f._nbr.shape[1]] = f._nbr
            np.testing.assert_array_equal(got, nbrs[i].numpy())
            np.testing.assert_array_equal(f._lens, lenss[i].numpy())
            post = torch.from_numpy(f.get_inferred())
            assert float((post - q[i]).abs().max()) <= gap_limit
        want = crf_ref.broadcast(q[-1].argmax(0), ref_labels)
        node = ref_labels.clamp(0, K - 1).reshape(-1)
        cm = torch.from_numpy(class_map).long().reshape(-1)
        differ = (cm != want.long().reshape(-1)) & (
            q[-1][cm, node] < q[-1].max(0).values[node] - tie)
        assert not differ.any()
    assert crf.num_frames == T and crf.first_time == FRAMES - T


def test_reference_matches_the_jax_fixture():
    """The reference on the fixture's four 720p cluster states: the JAX
    package's KNN lists exactly, its posteriors within rtol 2e-4, atol
    1e-6 (``tests/test_torch_crf.py``'s tolerance)."""
    from chip_smoke import CRF_C, CRF_ITERS, CRF_KNN, H720, K720, W720
    from chip_smoke import crf_proba
    yxm = torch.from_numpy(np.load(os.path.join(DATA, "port_720p_ref.npz"))
                           ["slice_clusters"])
    want = np.load(os.path.join(DATA, "port_crf_ref.npz"))
    nbr, lens = crf_ref.knn(yxm[..., 0], yxm[..., 1], H720, W720, CRF_KNN)
    np.testing.assert_array_equal(nbr.numpy(), want["knn_nbr"])
    np.testing.assert_array_equal(lens.numpy(), want["knn_lens"])
    feat = crf_ref.features(*(yxm[..., i] for i in range(6)))
    unary = torch.stack([crf_ref.unaries(crf_proba(t, CRF_C, K720))
                         for t in range(yxm.shape[0])])
    q = crf_ref.meanfield(feat, nbr, unary, CRF_ITERS)
    np.testing.assert_allclose(q.numpy(), want["q_knn"], rtol=2e-4,
                               atol=1e-6)


def test_reference_imports_no_jax_and_no_package_of_the_repo():
    banned = ("jax", "jaxlib", "fast_slic_tpu", "fast_slic_tpu_torch")
    names = set()
    for node in ast.walk(ast.parse(open(CRF_REF).read())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add((node.module or "").split(".")[0] or ".")
    assert names == {"__future__", "dataclasses", "math", "contextlib",
                     "numpy", "torch"}
    assert not names & set(banned)
