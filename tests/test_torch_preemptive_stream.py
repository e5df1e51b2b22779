"""PyTorch port: the benchmark's ``slic1080.preemptive`` call against its
plain reference, on the CPU.

A carried stream of six panned frames through the port's public
``SlicAvx2(preemptive=True, preemptive_thres=0.05).iterate`` at 96x128,
K=48, beside ``bench_port/reference/slic_preemptive_ref.py`` replaying the
same frames: labels, cluster state and the grid's activity of every call
equal, at a size where some iteration's mask is not all true.  The
reference itself equals fast-slic's C++ core with ``preemptive=True``
(``std_k256_preempt`` of ``tests/data/golden_ref.npz``) bit for bit, and
differs from it with the grid off; it imports neither JAX nor a package
of this repository.
"""

import ast
import os
import sys

import numpy as np
import pytest
import torch

import fast_slic_tpu_torch as ft
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "bench_port")
GOLDEN = os.path.join(ROOT, "tests", "data", "golden_ref.npz")

sys.path.insert(0, BENCH)
try:
    from reference import slic_preemptive_ref as pref
    from reference import slic_ref
    import frames as frames_lib
finally:
    sys.path.remove(BENCH)

H, W, K, FRAMES, THRES = 96, 128, 48, 6, 0.05


@pytest.mark.parametrize("seed", [11, 2 ** 31 + 5])
def test_stream_matches_the_reference(seed):
    clip = frames_lib.clip(H, W, FRAMES, 8, 2.0, seed, 0, "cpu")
    slic = ft.SlicAvx2(num_components=K, preemptive=True,
                       preemptive_thres=THRES, device="cpu")
    p = pref.Params(H=H, W=W, K=K, preemptive_thres=THRES)
    st = slic_ref.seed_state(clip[:1], K, "cpu")
    least_active = K
    for f in range(FRAMES):
        labels = slic.iterate(clip[f], max_iter=10)
        record = []
        ref = pref.iterate(torch.from_numpy(clip[f:f + 1]), st, p,
                           record=record)[0]
        np.testing.assert_array_equal(labels, ref.numpy())
        np.testing.assert_array_equal(slic.slic_model.to_yxmrgb(),
                                      st.yxmrgb()[0])
        act = slic.slic_model.last_preemptive_activity
        assert act.dtype == torch.int32 and tuple(act.shape) == (10, 2)
        assert act.tolist() == [list(r) for r in record], f
        least_active = min(least_active, min(a for a, _ in record))
    # some step left clusters inactive, so its mask was not all true
    assert least_active < K


def _golden_run(opts):
    g = np.load(GOLDEN)
    img = g["image"]
    p = pref.Params(H=img.shape[0], W=img.shape[1], K=256,
                    min_size_factor=0.1, preemptive_thres=0.05)
    st = slic_ref.seed_state(img[None], 256, "cpu")
    labels = pref.iterate(torch.from_numpy(img[None]), st, p, opts)[0]
    return labels.numpy(), st.yxmrgb()[0], g


def test_reference_matches_fast_slic_preemptive_golden():
    labels, got, g = _golden_run(pref.Options())
    np.testing.assert_array_equal(labels,
                                  g["std_k256_preempt"].astype(np.int64))
    ref = g["std_k256_preempt_clusters"]         # y, x, L, a, b, members
    np.testing.assert_array_equal(got[:, :2], ref[:, :2])
    np.testing.assert_array_equal(got[:, 2], ref[:, 5])
    np.testing.assert_array_equal(got[:, 3:], ref[:, 2:5])


def test_reference_without_the_grid_differs_from_the_golden():
    labels, got, g = _golden_run(pref.Options(preemptive=False))
    assert (labels != g["std_k256_preempt"].astype(np.int64)).any()
    assert (got[:, :2] != g["std_k256_preempt_clusters"][:, :2]).any()


def test_reference_imports_nothing_of_the_repo_or_jax():
    banned = {"jax", "jaxlib", "flax", "fast_slic_tpu", "fast_slic_tpu_torch"}
    tree = ast.parse(open(pref.__file__).read())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            tops.add((node.module or "").split(".")[0])
    assert tops and not tops & banned, tops
    assert tops <= {"__future__", "dataclasses", "math", "numpy", "torch",
                    "reference"}, tops
