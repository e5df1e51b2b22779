"""PyTorch port: connectivity enforcement against the JAX package.

On the fixtures of tests/test_cca.py (random labels, UNASSIGNED, a spiral,
top-K drops, a checkerboard and area ties at the top-K boundary) the port's
``enforce_connectivity_flagged`` must give the labels and the flag of
``fast_slic_tpu.ops.cca.enforce_connectivity_xla_flagged``; its component
ids those of the Pallas propagation kernel in interpret mode; its tie
escalation the labels of the union-find oracle ``enforce_connectivity_np``;
its orphan chase (``resolve_orphans_plain``) the JAX package's
``_resolve_orphans`` with gathers, on random orphan DAGs, a 3000-hop chain
and the flattened tables of three stacked frames; its selection with the
chase (``_substitutes`` on the CPU, the plain version of the card's
``cca_select``) the host's exact ``substitutes_np`` on tables with no tie
at the top-K boundary (one frame, stacked frames of their own component
counts, more pixels than bins), and its tie flag the tie's definition
where ties are planted.  The sharded CCA's
region table (``region_table``) and seam step (``seam_min``, with its
changed flag) must equal a numpy loop over the pixels on random, spiral
and serpentine maps.  Exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fast_slic_tpu.ops.cca import _resolve_orphans as jax_resolve_orphans
from fast_slic_tpu.ops.cca import connected_components as jax_components
from fast_slic_tpu.ops.cca import enforce_connectivity_xla_flagged
from fast_slic_tpu.oracle.numpy_ref import enforce_connectivity_np
from fast_slic_tpu.oracle.numpy_ref import heap_select_topk as jax_heap
from fast_slic_tpu.pallas.cca_tpu import (connected_components_pallas,
                                          propagate_min_pallas)
from fast_slic_tpu_torch.config import UNASSIGNED
from fast_slic_tpu_torch.kernels.cca import (connected_components, lookup,
                                             region_table,
                                             region_table_plain,
                                             resolve_orphans_plain, seam_min,
                                             seam_min_plain)
from fast_slic_tpu_torch.ops.cca import (_substitutes,
                                         enforce_connectivity_flagged,
                                         heap_select_topk,
                                         selection_rerun_device,
                                         substitutes_np)
from torch_threads import one_torch_thread  # noqa: F401


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


def _superpixel_labels(rng, H, W, S=24):
    """24x24 cells whose borders move by up to S/4 pixels a row and a
    column, ~5 % UNASSIGNED: regions that cross the card kernel's 32x32
    tile seams."""
    GH, GW = -(-H // S), -(-W // S)
    di = rng.integers(-(S // 4), S // 4 + 1, size=W)
    dj = rng.integers(-(S // 4), S // 4 + 1, size=H)
    ci = np.clip((np.arange(H)[:, None] + di) // S, 0, GH - 1)
    cj = np.clip((np.arange(W) + dj[:, None]) // S, 0, GW - 1)
    lab = (ci * GW + cj).astype(np.int32)
    lab[rng.random(lab.shape) < 0.05] = UNASSIGNED
    return lab, GH * GW


def _serpentine(H, W):
    """A 1-pixel serpentine: rows 0, 2, 4, ... of label 0 joined at
    alternating ends, in a field of label 1."""
    lab = np.ones([H, W], np.int32)
    lab[::2, :] = 0
    for i, r in enumerate(range(1, H, 2)):
        lab[r, (W - 1) if i % 2 == 0 else 0] = 0
    return lab


def _component_case(rng, case):
    H, W = 96, 160
    if case == "one_label":
        return np.zeros([H, W], np.int32)
    if case == "superpixels":
        return _superpixel_labels(rng, H, W)[0]
    if case == "serpentine":
        return _serpentine(H, W)
    if case == "row_1xn":
        return rng.integers(0, 2, size=(1, W)).astype(np.int32)
    if case == "col_nx1":
        return rng.integers(0, 2, size=(H, 1)).astype(np.int32)
    if case == "square_33":
        return rng.integers(0, 2, size=(33, 33)).astype(np.int32)
    if case == "stacked_frames":
        # four frames as ops.cca.framed_components labels them: frame f's
        # label k becomes f*K + k, its UNASSIGNED 0x10000 + f
        frames, K = zip(*(_superpixel_labels(rng, 24, W) for _ in range(4)))
        return np.concatenate([
            np.where(f == UNASSIGNED, 0x10000 + i, f + i * K[0])
            for i, f in enumerate(frames)]).astype(np.int32)
    raise KeyError(case)


@pytest.mark.parametrize("case", ["one_label", "superpixels", "serpentine",
                                  "row_1xn", "col_nx1", "square_33",
                                  "stacked_frames"])
def test_component_ids_match_jax_cases(rng, case):
    labels = _component_case(rng, case)
    ref = np.asarray(jax_components(jnp.asarray(labels)))
    got = connected_components(torch.from_numpy(labels))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)


def test_lookup_is_a_gather(rng):
    table = rng.integers(0, 1 << 20, size=500).astype(np.int32)
    ids = rng.integers(0, 500, size=(30, 40)).astype(np.int32)
    got = lookup(torch.from_numpy(ids), torch.from_numpy(table))
    np.testing.assert_array_equal(got.numpy(), table[ids])


_BIG = 0x7FFFFFFF


def _region_case(rng, case):
    """(labels int32 [H, W], seed int32 [H, W]) for the region table."""
    H, W = 40, 56
    if case == "spiral":
        labels = _spiral(H, W)
    elif case == "serpentine":
        labels = _serpentine(H, W)
    else:
        labels = rng.integers(0, 3, size=(H, W)).astype(np.int32)
    if case == "sparse_seed":   # _BIG but at a few pixels, as leader ranks
        m0 = np.full(H * W, _BIG, np.int32)
        keep = rng.choice(H * W, size=9, replace=False)
        m0[keep] = rng.integers(0, 1000, size=9)
    else:
        m0 = rng.permutation(H * W).astype(np.int32)
    return labels, m0.reshape(H, W)


def _region_table_loop(m0, roots):
    table = np.full(m0.size, _BIG, np.int64)
    for p, (r, v) in enumerate(zip(roots.ravel(), m0.ravel())):
        table[r] = min(table[r], v)
    return table


def _seam_min_loop(table, roots_row, lab_row, lab_nb, val_nb, changed,
                   stamp):
    table = table.astype(np.int64).copy()
    for x in range(roots_row.shape[0]):
        r = roots_row[x]
        if lab_row[x] == lab_nb[x] and val_nb[x] < table[r]:
            table[r] = val_nb[x]
            changed = stamp
    return table, changed


@pytest.mark.parametrize("case", ["random", "spiral", "serpentine",
                                  "sparse_seed"])
def test_region_table_and_seam_min_match_loop(rng, case):
    """The region table over a slab's roots, then one seam of it: the top
    rows of the map are the slab, the row below them the neighbour's edge
    row, whose values are drawn around the table's own."""
    labels, m0 = _region_case(rng, case)
    h = labels.shape[0] // 2
    lab_t = torch.from_numpy(labels[:h].copy())
    roots = connected_components(lab_t)
    m0_t = torch.from_numpy(m0[:h].copy())
    want = _region_table_loop(m0[:h], roots.numpy())
    table = region_table_plain(m0_t, roots)
    assert table.dtype == torch.int32 and table.shape == (h * labels.shape[1],)
    np.testing.assert_array_equal(table.numpy(), want)
    np.testing.assert_array_equal(region_table(m0_t, roots).numpy(), want)

    roots_row = roots[-1]
    lab_row = lab_t[-1]
    lab_nb = torch.from_numpy(labels[h].copy())
    base = table[roots_row.long()].numpy().astype(np.int64)
    val_nb = np.clip(base + rng.integers(-50, 50, size=base.shape), 0, _BIG)
    # one pixel where the labels meet surely lowers its slot
    val_nb[np.flatnonzero(lab_row.numpy() == lab_nb.numpy())[0]] = -1
    val_nb = torch.from_numpy(val_nb.astype(np.int32))
    for stamp, nb in ((5, lab_nb), (6, lab_nb + 7)):   # 2nd: no label meets
        exp_table, exp_changed = _seam_min_loop(
            table.numpy(), roots_row.numpy(), lab_row.numpy(), nb.numpy(),
            val_nb.numpy(), 3, stamp)
        for fn in (seam_min_plain, seam_min):
            got = table.clone()
            changed = torch.tensor(3, dtype=torch.int32)
            fn(got, roots_row, lab_row, nb, val_nb, changed, stamp)
            np.testing.assert_array_equal(got.numpy(), exp_table)
            assert int(changed) == exp_changed
        if stamp == 5:
            assert exp_changed == 5      # some slot went down
        else:
            np.testing.assert_array_equal(exp_table, table.numpy())
            assert exp_changed == 3


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


def _select_frame(rng, n, nc, n_pixels, ties):
    """One frame's component tables with n bins: nc components whose areas
    lie in [1, n_pixels] -- all distinct (``ties`` False) or drawn from a
    few values (True) --, targets below their own entry, and garbage in
    the empty bins."""
    areas = rng.integers(0, 1 << 20, size=n).astype(np.int32)
    if ties:
        areas[:nc] = rng.integers(1, 9, size=nc) * max(1, n_pixels // 9)
    else:
        areas[:nc] = rng.choice(np.arange(1, n_pixels + 1), nc,
                                replace=False)
    target = rng.integers(-3, 1 << 20, size=n).astype(np.int32)
    target[0] = 0
    target[1:nc] = rng.integers(0, np.arange(1, nc))
    return areas, target


# (frames' (bins, components), pixels a frame or None for the bins, K,
# threshold)
SELECT_TABLES = {
    "one_frame": ([(600, 450)], None, 120, 40),
    "one_frame_few_kept": ([(600, 450)], None, 400, 300),
    "one_frame_all_kept": ([(300, 300)], None, 80, 0),
    "stacked_3": ([(500, 480), (500, 7), (500, 260)], None, 90, 30),
    "sharded": ([(350, 350)], 40000, 100, 9000),
}


@pytest.mark.parametrize("case", sorted(SELECT_TABLES))
def test_plain_selection_matches_substitutes_np(rng, case):
    """On tables without a tie at the top-K boundary, the plain selection
    (``_substitutes`` on the CPU) gives the host's exact selection: every
    component's substitute, 0 in the empty bins, and no tie flag."""
    frames, n_pixels, K, thres = SELECT_TABLES[case]
    tabs = [_select_frame(rng, n, nc, n_pixels or n, False)
            for n, nc in frames]
    ncs = [nc for _, nc in frames]
    areas = torch.from_numpy(np.stack([a for a, _ in tabs]))
    target = torch.from_numpy(np.stack([t for _, t in tabs]))
    ncomp = torch.tensor(ncs, dtype=torch.int64)
    if len(frames) == 1:
        areas, target, ncomp = areas[0], target[0], ncomp[0]
    sub, tie = _substitutes(areas, target, ncomp, K, thres, n_pixels)
    assert sub.dtype == torch.int32 and sub.shape == areas.shape
    assert tie.shape == ncomp.shape and not bool(tie.any())
    sub = sub.reshape(len(frames), -1).numpy()
    for f, ((a, t), nc) in enumerate(zip(tabs, ncs)):
        np.testing.assert_array_equal(sub[f, :nc],
                                      substitutes_np(a, t, nc, K, thres))
        assert not sub[f, nc:].any()


def _brute_tie(areas, nc, K, thres, n_pixels):
    """The boundary tie by its definition: more than k = min(K, n_pixels)
    components pass the threshold, and the k-th and (k+1)-th largest of
    their areas are equal."""
    k = min(K, n_pixels)
    kept = np.sort(areas[:nc][areas[:nc] >= thres])[::-1]
    return bool(kept.size > k and k > 0 and kept[k - 1] == kept[k])


@pytest.mark.parametrize("case", ["planted", "none_at_boundary",
                                  "exactly_k", "stacked_4", "sharded"])
def test_plain_tie_flag_matches_brute_force(rng, case):
    """The plain selection's tie flag is the boundary tie's definition, on
    tables with ties planted at the boundary and beside it."""
    n, nc, n_pixels, K, thres = 400, 380, None, 60, 2
    frames = 1
    if case == "stacked_4":
        frames = 4
    if case == "sharded":
        n_pixels = 90000
    tabs = [_select_frame(rng, n, nc, n_pixels or n, True)
            for _ in range(frames)]
    for f, (a, _) in enumerate(tabs):
        if case == "none_at_boundary":
            # a tie inside the kept set and one outside it, none across
            a[:nc] = rng.choice(np.arange(1, n + 1), nc, replace=False)
            order = np.argsort(-a[:nc], kind="stable")
            a[order[5:9]] = a[order[5]]
            a[order[K:K + 4]] = a[order[K]]
        elif case == "exactly_k":
            a[K:nc] = 1
        elif f % 2 == 0:
            order = np.argsort(-a[:nc], kind="stable")
            a[order[K - 3:K + 3]] = a[order[K - 3]]
    ncs = [nc] * frames
    areas = torch.from_numpy(np.stack([a for a, _ in tabs]))
    target = torch.from_numpy(np.stack([t for _, t in tabs]))
    ncomp = torch.tensor(ncs, dtype=torch.int64)
    _, tie = _substitutes(areas, target, ncomp, K, thres, n_pixels)
    want = [_brute_tie(a, nc, K, thres, n_pixels or n) for a, _ in tabs]
    assert tie.tolist() == want
    if case in ("planted", "stacked_4", "sharded"):
        assert want[0]
    if case in ("none_at_boundary", "exactly_k"):
        assert not any(want)
