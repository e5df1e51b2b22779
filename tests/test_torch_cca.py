"""PyTorch port: connectivity enforcement against the JAX package.

On the fixtures of tests/test_cca.py (random labels, UNASSIGNED, a spiral,
top-K drops, a checkerboard and area ties at the top-K boundary) the port's
``enforce_connectivity_flagged`` must give the labels and the flag of
``fast_slic_tpu.ops.cca.enforce_connectivity_xla_flagged``; its component
ids those of the Pallas propagation kernel in interpret mode; its tie
escalation the labels of the union-find oracle ``enforce_connectivity_np``;
and its orphan chase (``resolve_orphans_plain``) the JAX package's
``_resolve_orphans`` with gathers, on random orphan DAGs, a 3000-hop chain
and the flattened tables of three stacked frames.  Exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fast_slic_tpu.ops.cca import _resolve_orphans as jax_resolve_orphans
from fast_slic_tpu.ops.cca import enforce_connectivity_xla_flagged
from fast_slic_tpu.oracle.numpy_ref import enforce_connectivity_np
from fast_slic_tpu.oracle.numpy_ref import heap_select_topk as jax_heap
from fast_slic_tpu.pallas.cca_tpu import (connected_components_pallas,
                                          propagate_min_pallas)
from fast_slic_tpu_torch.config import UNASSIGNED
from fast_slic_tpu_torch.kernels.cca import (connected_components, lookup,
                                             resolve_orphans,
                                             resolve_orphans_plain)
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
    if name == "orphan_chain":
        # one-pixel-wide columns of alternating labels, each below the
        # threshold: every column adopts its left neighbour's label, a
        # chain of 299 hops down to column 0
        lab = np.tile(np.arange(300, dtype=np.int32) % 2, (4, 1))
        return lab, 8, 5
    raise KeyError(name)


FIXTURES = ["random_0", "random_3", "random_25", "unassigned", "spiral",
            "uniform", "topk_drop", "checkerboard", "ties_0", "ties_5",
            "orphan_chain"]


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


def _orphan_dag(rng, n):
    """Tables as ``ops.cca.orphan_tables`` builds them for one frame:
    component 0 labelled and pointing at itself, every other target
    strictly smaller, ~60 % of the components dropped (UNASSIGNED)."""
    sub = rng.integers(0, n, size=n).astype(np.int32)
    sub[rng.random(n) < 0.6] = UNASSIGNED
    sub[0] = 0
    target = np.zeros(n, np.int32)
    target[1:] = rng.integers(0, np.arange(1, n))
    return sub, target


def _orphan_case(rng, case):
    if case == "random":
        return _orphan_dag(rng, 700)
    if case == "chain_3000":
        sub = np.full(3001, UNASSIGNED, np.int32)
        sub[0] = 7
        return sub, np.maximum(np.arange(3001, dtype=np.int32) - 1, 0)
    if case == "stacked_3":
        frames = [_orphan_dag(rng, 400) for _ in range(3)]
        sub = np.concatenate([f[0] for f in frames])
        target = np.concatenate([f[1] + 400 * i for i, f in enumerate(frames)])
        return sub, target.astype(np.int32)
    if case == "unlabelled_loops":
        # dropped entries pointing at themselves or at such an entry: no
        # chain reaches a label, so they get 0
        sub, target = _orphan_dag(rng, 300)
        loops = rng.choice(np.arange(1, 300), 20, replace=False)
        sub[loops] = UNASSIGNED
        target[loops] = loops
        return sub, target
    raise KeyError(case)


@pytest.mark.parametrize("case", ["random", "chain_3000", "stacked_3",
                                  "unlabelled_loops"])
def test_resolve_orphans_matches_jax(rng, case):
    sub, target = _orphan_case(rng, case)
    ref, unresolved = jax_resolve_orphans(jnp.asarray(sub),
                                          jnp.asarray(target), sub.shape[0],
                                          True)
    assert not bool(unresolved)
    got = resolve_orphans_plain(torch.from_numpy(sub),
                                torch.from_numpy(target))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert UNASSIGNED not in got.numpy()
    # the dispatching wrapper takes the plain version for a CPU tensor
    np.testing.assert_array_equal(
        resolve_orphans(torch.from_numpy(sub), torch.from_numpy(target)),
        got)


def _walk_orphans(sub, target):
    """The orphan chase as cca.cpp:240-254 runs it: ascending, each dropped
    component takes its target's (already resolved) substitute."""
    out = sub.astype(np.int64).copy()
    for c in range(out.shape[0]):
        if out[c] == UNASSIGNED:
            t = target[c]
            out[c] = 0 if t >= c or out[t] == UNASSIGNED else out[t]
    return out


@pytest.mark.parametrize("case", ["random", "chain_3000", "stacked_3"])
def test_resolve_orphans_matches_sequential_adoption(rng, case):
    sub, target = _orphan_case(rng, case)
    got = resolve_orphans_plain(torch.from_numpy(sub),
                                torch.from_numpy(target))
    np.testing.assert_array_equal(got.numpy(), _walk_orphans(sub, target))


def test_heap_select_matches_oracle(rng):
    for _ in range(20):
        n = int(rng.integers(5, 60))
        areas = rng.integers(1, 6, size=n)          # many ties
        seq = list(rng.permutation(n))
        K = int(rng.integers(1, n))
        assert heap_select_topk(seq, areas, K) == jax_heap(seq, areas, K)
