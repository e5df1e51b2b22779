"""PyTorch port: connectivity enforcement against the JAX package.

On the fixtures of tests/test_cca.py (random labels, UNASSIGNED, a spiral,
top-K drops, a checkerboard and area ties at the top-K boundary) the port's
``enforce_connectivity_flagged`` must give the labels and the flag of
``fast_slic_tpu.ops.cca.enforce_connectivity_xla_flagged``; its component
ids those of the Pallas propagation kernel in interpret mode; and its tie
escalation the labels of the union-find oracle ``enforce_connectivity_np``.
Exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fast_slic_tpu.ops.cca import enforce_connectivity_xla_flagged
from fast_slic_tpu.oracle.numpy_ref import enforce_connectivity_np
from fast_slic_tpu.oracle.numpy_ref import heap_select_topk as jax_heap
from fast_slic_tpu.pallas.cca_tpu import (connected_components_pallas,
                                          propagate_min_pallas)
from fast_slic_tpu_torch.config import UNASSIGNED
from fast_slic_tpu_torch.kernels.cca import connected_components, lookup
from fast_slic_tpu_torch.ops.cca import (enforce_connectivity_flagged,
                                         heap_select_topk,
                                         selection_rerun_device)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one thread: beside the suite's workers and JAX's threads a
    full torch pool oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spiral(H=33, W=33):
    labels = np.ones([H, W], np.int32)
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
    labels = np.zeros([12, 40], np.int32)
    x = 1
    for w in (2, 3, 4, 5, 6):
        labels[:, x:x + w] = 1
        x += w + 2
    return labels


def _fixture(name, rng):
    """(labels int32 [H, W], K, threshold)."""
    if name.startswith("random"):
        thres = int(name.split("_")[1])
        return rng.integers(0, 6, size=(24, 31)).astype(np.int32), 6, thres
    if name == "unassigned":
        lab = rng.integers(0, 5, size=(20, 20)).astype(np.int32)
        lab[lab == 4] = UNASSIGNED
        return lab, 5, 4
    if name == "spiral":
        return _spiral(), 4, 2
    if name == "uniform":
        return np.zeros([16, 16], np.int32), 3, 10
    if name == "topk_drop":
        return _stripes(), 4, 1
    if name == "checkerboard":
        return (np.indices((17, 19)).sum(0) % 2).astype(np.int32), 30, 1
    if name.startswith("ties"):
        blocks = rng.integers(0, 4, size=(6, 8))
        lab = np.kron(blocks, np.ones((4, 4), np.int64)).astype(np.int32)
        return lab, 4, int(name.split("_")[1])
    raise KeyError(name)


FIXTURES = ["random_0", "random_3", "random_25", "unassigned", "spiral",
            "uniform", "topk_drop", "checkerboard", "ties_0", "ties_5"]


@pytest.mark.parametrize("name", FIXTURES)
def test_enforce_connectivity_matches_jax(rng, name):
    labels, K, thres = _fixture(name, rng)
    ref, ref_flag = enforce_connectivity_xla_flagged(
        jnp.asarray(labels), K, jnp.int32(thres))
    got, flag = enforce_connectivity_flagged(torch.from_numpy(labels), K,
                                             thres)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert bool(flag) == bool(np.asarray(ref_flag))
    if name.startswith("ties"):
        assert bool(flag)  # the boundary tie is what the flag is for


def test_no_component_overflow_on_fragmented_maps():
    # a checkerboard has n/2 components; the JAX package flags it for a
    # host re-run past a component cap, the port's bins are sized at n
    labels = (np.indices((16, 16)).sum(0) % 2).astype(np.int32)
    got, flag = enforce_connectivity_flagged(torch.from_numpy(labels), 300,
                                             1)
    ref = enforce_connectivity_np(labels.astype(np.uint16), 300, 1)
    np.testing.assert_array_equal(got.numpy(), ref.astype(np.int32))
    assert not bool(flag)


@pytest.mark.parametrize("name", FIXTURES)
def test_escalated_labels_match_oracle(rng, name):
    labels, K, thres = _fixture(name, rng)
    ref = enforce_connectivity_np(labels.astype(np.uint16), K, thres)
    got = selection_rerun_device(torch.from_numpy(labels), K, thres)
    np.testing.assert_array_equal(got.numpy(), ref.astype(np.int32))
    fused, flag = enforce_connectivity_flagged(torch.from_numpy(labels), K,
                                               thres)
    if not bool(flag):  # unflagged: the fused path is already exact
        np.testing.assert_array_equal(fused.numpy(), ref.astype(np.int32))


@pytest.mark.parametrize("name", ["random_0", "unassigned", "spiral",
                                  "checkerboard"])
def test_component_ids_match_pallas_interpret(rng, name):
    labels, _, _ = _fixture(name, rng)
    ref = np.asarray(connected_components_pallas(jnp.asarray(labels),
                                                 interpret=True))
    got = connected_components(torch.from_numpy(labels))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_component_ids_match_propagate_min_pallas(rng):
    labels = rng.integers(0, 4, size=(40, 70)).astype(np.int32)
    H, W = labels.shape
    iota = np.arange(H * W, dtype=np.int32).reshape(H, W)
    ref = np.asarray(propagate_min_pallas(jnp.asarray(labels),
                                          jnp.asarray(iota), interpret=True))
    got = connected_components(torch.from_numpy(labels))
    np.testing.assert_array_equal(got.numpy(), ref)
    # every id is the minimum linear index of its members
    flat = got.numpy().ravel()
    for leader in np.unique(flat):
        assert np.nonzero(flat == leader)[0].min() == leader


def test_lookup_is_a_gather(rng):
    table = rng.integers(0, 1 << 20, size=500).astype(np.int32)
    ids = rng.integers(0, 500, size=(30, 40)).astype(np.int32)
    got = lookup(torch.from_numpy(ids), torch.from_numpy(table))
    np.testing.assert_array_equal(got.numpy(), table[ids])


def test_heap_select_matches_oracle(rng):
    for _ in range(20):
        n = int(rng.integers(5, 60))
        areas = rng.integers(1, 6, size=n)          # many ties
        seq = list(rng.permutation(n))
        K = int(rng.integers(1, n))
        assert heap_select_topk(seq, areas, K) == jax_heap(seq, areas, K)
