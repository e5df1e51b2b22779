"""The plain reference: bit-exact against the reference fast-slic's own
outputs on its test image, and independent of the program and of JAX."""

import ast
import pathlib

import numpy as np
import pytest
import torch

from reference import slic_ref

DATA = pathlib.Path(slic_ref.__file__).resolve().parent.parent / "data"


@pytest.mark.parametrize("case,variant,msf", [
    ("std_k256_msf01", "standard", 0.1),
    ("std_k256_msf0", "standard", 0.0),
    ("lsc_k256", "lsc", 0.1)])
def test_matches_fast_slic_golden(case, variant, msf):
    """Labels and clusters of fast-slic's C++ core on the fish image
    (K=256, 10 iterations, stride 3), pinned from a build of it."""
    g = np.load(DATA / "fish.npz")
    img = g["image"]
    H, W = img.shape[:2]
    p = slic_ref.Params(H=H, W=W, K=256, variant=variant,
                        min_size_factor=msf)
    st = slic_ref.seed_state(img[None], 256, "cpu")
    labels = slic_ref.iterate(torch.from_numpy(img[None]), st, p)[0]
    np.testing.assert_array_equal(labels.numpy(), g[case].astype(np.int64))
    got = st.yxmrgb()[0]
    ref = g[case + "_clusters"]       # y, x, L, a, b, members
    np.testing.assert_array_equal(got[:, :2], ref[:, :2])
    np.testing.assert_array_equal(got[:, 2], ref[:, 5])
    np.testing.assert_array_equal(got[:, 3:], ref[:, 2:5])


def test_heap_select_is_partial_sort():
    """Ties at the K-th area keep libstdc++'s heap choice, which is not
    the first K by component order."""
    areas = np.array([5, 3, 3, 3, 9, 3, 3])
    keep = sorted(slic_ref.heap_select_topk(list(range(7)), areas, 3))
    assert [areas[k] for k in keep].count(3) == 1 and 4 in keep and 0 in keep


def test_components_join_equal_neighbours_only():
    lab = torch.tensor([[[1, 1, 2], [3, 1, 2], [3, 3, 2]],
                        [[4, 4, 4], [4, 5, 4], [4, 4, 4]]])
    L = slic_ref._components(lab).reshape(2, 3, 3)
    assert L[0, 1, 1] == 0 and L[0, 2, 2] == 2 and L[0, 2, 0] == 3
    assert int(L[1].max()) == 13 and L[1, 2, 2] == 9


def test_imports_nothing_of_the_program_or_jax():
    banned = {"jax", "jaxlib", "flax", "fast_slic_tpu", "fast_slic_tpu_torch"}
    root = pathlib.Path(slic_ref.__file__).resolve().parent
    files = sorted(root.rglob("*.py"))
    assert files
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                tops = {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom):
                tops = {(node.module or "").split(".")[0]}
            else:
                continue
            assert not tops & banned, (f.name, tops)
