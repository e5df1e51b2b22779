"""PyTorch port: the superpixel graph and density utilities against the JAX
package (``fast_slic_tpu/ops/graph.py``), on the CPU.

* ``NodeConnectivity``: lists -> matrix -> lists round trips, equal to the
  JAX class's;
* ``adjacency_matrix``: seeded random label maps (with labels outside
  [0, K)), a map built so that one label borders 16 others (the
  12-neighbour cap drops edges in scan order) and the four 720p frames of
  ``tests/data/port_720p_ref.npz``, three of which hit the cap;
* ``knn_plain`` against the JAX ``graph.knn`` (its native helper) at
  m = 1, 4 and 8, on the 720p frames' clusters and on seeded random
  centres, some on the image's edge; ``knn_buckets_plain`` against a numpy
  rendering of ``fstpu_knn``'s bucketing (random centres, centres on and
  past the edges, identical centres); numpy models of the two CUDA
  kernels' algorithms (the bucketing's ranged, staged placement and the
  warp walk's batched rejection) against the plain versions;
* ``mask_density`` / ``density_to_mask``, and the ``SlicModel`` methods
  with their ValueErrors (as ``tests/test_api.py`` checks the JAX model);
* the device rule: tensors are used where they lie, numpy input goes to
  the card unless a device is named, and nothing moves between devices.

Exact.  The 720p results are also held to ``tests/data/port_crf_ref.npz``
(``scripts/make_port_fixture_crf.py``), which chip_smoke.py holds the card
to.
"""

import os

import numpy as np
import pytest
import torch

from fast_slic_tpu import cluster as jcl
from fast_slic_tpu.ops import graph as jgraph
from fast_slic_tpu_torch import NodeConnectivity, SlicModel
from fast_slic_tpu_torch import cluster as tcl
from fast_slic_tpu_torch.kernels import knn as knn_kernel
from fast_slic_tpu_torch.ops import graph
from torch_threads import one_torch_thread  # noqa: F401

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
K720 = 1600


@pytest.fixture(scope="module")
def ref720():
    return np.load(os.path.join(DATA, "port_720p_ref.npz"))


@pytest.fixture(scope="module")
def crf_ref():
    return np.load(os.path.join(DATA, "port_crf_ref.npz"))


def _clusters(yxmrgb):
    """Port and JAX cluster states of a [K, 6] (y, x, m, r, g, b) array."""
    K = yxmrgb.shape[0]
    out = []
    for st in (tcl.zeros(K), jcl.zeros(K)):
        st.y[:], st.x[:] = yxmrgb[:, 0], yxmrgb[:, 1]
        st.num_members[:] = yxmrgb[:, 2].astype(np.uint32)
        st.r[:], st.g[:], st.b[:] = yxmrgb[:, 3], yxmrgb[:, 4], yxmrgb[:, 5]
        out.append(st)
    return out


def _model(yxmrgb):
    """A port SlicModel on the CPU holding these clusters."""
    model = SlicModel(yxmrgb.shape[0], device="cpu")
    model._clusters = _clusters(yxmrgb)[0]
    model.initialized = True
    return model


def _random_labels(rng, H, W, K, blocks=True):
    if blocks:  # superpixel-like blocks with ragged borders
        base = rng.integers(0, K, size=(-(-H // 5), -(-W // 5)))
        lab = np.kron(base, np.ones((5, 5), np.int64))[:H, :W]
        flip = rng.random((H, W)) < 0.1
        lab[flip] = rng.integers(0, K, size=int(flip.sum()))
        return lab
    return rng.integers(0, K, size=(H, W))


def _hot_map():
    """Label 0 is a 6x6 block ringed by 16 other labels in a 12x12 map, so
    it has more than 12 candidate neighbours; the ring's labels touch each
    other and the background label 17."""
    lab = np.full((12, 12), 17, np.int64)
    ring = [(r, c) for r in range(2, 10) for c in range(2, 10)
            if r in (2, 9) or c in (2, 9)]
    for i, (r, c) in enumerate(ring):
        lab[r, c] = 1 + i * 16 // len(ring)
    lab[3:9, 3:9] = 0
    return lab, 18


@pytest.mark.parametrize("lists", [
    [[1, 2], [0], [0], []],
    [[], [], []],
    [[3, 1, 2], [0, 2, 3], [1], [0, 1]],
])
def test_node_connectivity_round_trip(lists):
    port = NodeConnectivity(lists)
    jax_ = jgraph.NodeConnectivity(lists)
    assert port.num_nodes == jax_.num_nodes == len(lists)
    assert port.tolist() == lists
    nbr, lens = port.matrix()
    jnbr, jlens = jax_.matrix()
    np.testing.assert_array_equal(nbr, jnbr)
    np.testing.assert_array_equal(lens, jlens)
    back = NodeConnectivity(matrix=nbr, lens=lens)
    assert back.num_nodes == len(lists) and back.tolist() == lists
    np.testing.assert_array_equal(back.matrix()[0], nbr)


@pytest.mark.parametrize("seed,H,W,K,blocks", [
    (0, 40, 57, 30, True), (1, 64, 64, 200, True), (2, 23, 31, 9, False),
    (3, 50, 33, 400, False), (4, 1, 20, 5, True), (5, 37, 2, 6, True),
])
def test_adjacency_matches_jax(seed, H, W, K, blocks):
    rng = np.random.default_rng(seed)
    lab = _random_labels(rng, H, W, K, blocks)
    # labels outside [0, K) are ignored, as UNASSIGNED is
    lab[rng.random((H, W)) < 0.03] = -1
    lab[rng.random((H, W)) < 0.01] = K
    jnbr, jlens = jgraph.adjacency_matrix(lab, K)
    # numpy input goes to the device named; a tensor decides for itself
    for args in ((lab.astype(np.int16), K, "cpu"), (torch.from_numpy(lab), K)):
        nbr, lens = graph.adjacency_matrix(*args)
        assert nbr.dtype == np.int32 and lens.dtype == np.int64
        np.testing.assert_array_equal(nbr, jnbr)
        np.testing.assert_array_equal(lens, jlens)
    assert graph.adjacency(lab, K, "cpu") == jgraph.adjacency(lab, K)


def test_adjacency_cap_on_hot_node():
    lab, K = _hot_map()
    jnbr, jlens = jgraph.adjacency_matrix(lab, K)
    assert jlens[0] == 12  # the cap fired: 16 candidates, 12 kept
    nbr, lens = graph.adjacency_matrix(lab, K, "cpu")
    np.testing.assert_array_equal(nbr, jnbr)
    np.testing.assert_array_equal(lens, jlens)


def test_adjacency_720p_frames(ref720, crf_ref):
    capped = 0
    for t, labels in enumerate(ref720["slice_labels"]):
        jnbr, jlens = jgraph.adjacency_matrix(labels, K720)
        nbr, lens = graph.adjacency_matrix(labels, K720, "cpu")
        np.testing.assert_array_equal(nbr, jnbr, err_msg="frame %d" % t)
        np.testing.assert_array_equal(lens, jlens, err_msg="frame %d" % t)
        np.testing.assert_array_equal(
            nbr, crf_ref["adj_nbr"][t][:, :nbr.shape[1]])
        np.testing.assert_array_equal(lens, crf_ref["adj_lens"][t])
        # a frame hits the cap where some label has > 12 candidate edges
        base = labels[:-1, :-1].astype(np.int64).ravel()
        keys = []
        for nb in (labels[:-1, 1:], labels[1:, :-1], labels[1:, 1:]):
            nb = nb.astype(np.int64).ravel()
            ok = nb != base
            keys.append(np.minimum(base, nb)[ok] * K720
                        + np.maximum(base, nb)[ok])
        keys = np.unique(np.concatenate(keys))
        deg = np.bincount(np.concatenate([keys // K720, keys % K720]),
                          minlength=K720)
        capped += int((deg > 12).any())
    assert capped >= 3


def _knn_lists(nbr, counts):
    nbr, counts = np.asarray(nbr), np.asarray(counts)
    return [nbr[k, :counts[k]].tolist() for k in range(nbr.shape[0])]


@pytest.mark.parametrize("m", [1, 4, 8])
def test_knn_plain_matches_jax_720p(ref720, crf_ref, m):
    for t, yxm in enumerate(ref720["slice_clusters"][:2 if m != 4 else 4]):
        st, jst = _clusters(yxm)
        want = jgraph.knn(jst, m, (720, 1280))
        nbr, counts = knn_kernel.knn_plain(torch.from_numpy(st.y),
                                           torch.from_numpy(st.x), 720,
                                           1280, m)
        assert nbr.dtype == torch.int32 and nbr.shape == (K720, m)
        assert _knn_lists(nbr, counts) == want
        gnbr, glens = graph.knn(st, m, (720, 1280), "cpu")
        jnbr, jlens = jgraph.NodeConnectivity(want).matrix()
        np.testing.assert_array_equal(gnbr, jnbr)
        np.testing.assert_array_equal(glens, jlens)
        if m == 4:
            np.testing.assert_array_equal(gnbr, crf_ref["knn_nbr"][t])
            np.testing.assert_array_equal(glens, crf_ref["knn_lens"][t])
            # the early skip drops candidates: fewer than m neighbours
            assert glens.sum() < K720 * m


@pytest.mark.parametrize("seed,K,H,W", [(0, 300, 240, 320), (1, 50, 97, 61),
                                        (2, 1000, 100, 900)])
@pytest.mark.parametrize("m", [1, 4, 8])
def test_knn_plain_matches_jax_random(seed, K, H, W, m):
    rng = np.random.default_rng(seed)
    yxm = np.zeros((K, 6), np.float32)
    yxm[:, 0] = rng.uniform(0, H, K)
    yxm[:, 1] = rng.uniform(0, W, K)
    # some centres on the image's edges and one past them (clamped cell)
    yxm[:5, 0], yxm[5:10, 1] = H - 1, W - 1
    yxm[10:15, 0], yxm[15:20, 1] = 0, 0
    yxm[20, 0], yxm[20, 1] = H + 3.5, W + 7.25
    st, jst = _clusters(yxm)
    want = jgraph.knn(jst, m, (H, W))
    got = knn_kernel.knn(torch.from_numpy(st.y), torch.from_numpy(st.x), H,
                         W, m)
    assert _knn_lists(*got) == want


def _c_cell(v, S: int) -> int:
    """C's (int)v / S: both steps truncate toward zero."""
    q = abs(int(v)) // S
    return q if int(v) >= 0 else -q


def _fstpu_buckets(y, x, H, W):
    """fstpu_knn's bucketing (fast_slic_tpu/native/cca_native.cpp:127-134)
    in numpy: each cluster appended to its clamped cell's list in cluster
    order; (sorted_ids, cell_start) as the concatenated lists and their
    offsets."""
    K = y.shape[0]
    S = max(int(np.sqrt(float(H * W // K))), 1)
    nh, nw = -(-H // S), -(-W // S)
    cells = [[] for _ in range(nh * nw)]
    for k in range(K):
        cy = min(max(_c_cell(y[k], S), 0), nh - 1)
        cx = min(max(_c_cell(x[k], S), 0), nw - 1)
        cells[cy * nw + cx].append(k)
    start = np.zeros(nh * nw + 1, np.int32)
    start[1:] = np.cumsum([len(c) for c in cells])
    return np.array([k for c in cells for k in c], np.int32), start


def _bucket_centres(kind, seed, K, H, W):
    """float32 centres: random; on and past the image's edges (negative,
    beyond H and W); or in a few groups of identical centres."""
    rng = np.random.default_rng(seed)
    y = rng.uniform(0, H, K).astype(np.float32)
    x = rng.uniform(0, W, K).astype(np.float32)
    if kind == "edges":
        n = max(K // 8, 1)
        y[:n], x[n:2 * n] = H - 1, W - 1
        y[2 * n:3 * n], x[3 * n:4 * n] = 0, 0
        y[4 * n:5 * n] = rng.uniform(-3 * H, -0.5, n)
        x[5 * n:6 * n] = rng.uniform(W, 3 * W, n)
        y[6 * n], x[6 * n] = H + 3.5, W + 7.25
    elif kind == "identical":
        groups = rng.integers(0, min(3, K), K)
        y, x = y[groups], x[groups]
    return y, x


BUCKET_CASES = [("random", 0, 300, 240, 320), ("random", 1, 1000, 100, 900),
                ("edges", 2, 300, 240, 320), ("edges", 3, 57, 33, 17),
                ("identical", 4, 200, 97, 61), ("identical", 5, 1, 10, 10)]


@pytest.mark.parametrize("kind,seed,K,H,W", BUCKET_CASES)
def test_knn_buckets_plain_matches_fstpu(kind, seed, K, H, W):
    y, x = _bucket_centres(kind, seed, K, H, W)
    want_ids, want_start = _fstpu_buckets(y, x, H, W)
    for fn in (knn_kernel.knn_buckets_plain, knn_kernel.knn_buckets):
        ids, start = fn(torch.from_numpy(y), torch.from_numpy(x), H, W)
        assert ids.dtype == start.dtype == torch.int32
        np.testing.assert_array_equal(ids.numpy(), want_ids)
        np.testing.assert_array_equal(start.numpy(), want_start)


def _bucket_kernel_model(y, x, H, W, range_cells, tile):
    """knn_buckets_kernel's algorithm (csrc/knn.cu) in numpy: the cells in
    ranges of ``range_cells``, each counted and scanned, then its clusters
    placed ``tile`` at a time in chunks of 32 lanes: a lane's rank among the
    chunk's lanes of its cell (__match_any_sync), the cell's cursor
    advanced by the group's last lane after the chunk."""
    K = y.shape[0]
    S, nh, nw = knn_kernel.grid(H, W, K)
    cy = np.clip([_c_cell(v, S) for v in y], 0, nh - 1)
    cx = np.clip([_c_cell(v, S) for v in x], 0, nw - 1)
    cell = cy * nw + cx
    ncell = nh * nw
    rng_ = min(range_cells, ncell)
    ids = np.full(K, -1, np.int32)
    start = np.zeros(ncell + 1, np.int32)
    base = 0
    for c0 in range(0, ncell, rng_):
        n = min(rng_, ncell - c0)
        rel = cell - c0
        inr = (rel >= 0) & (rel < n)
        table = np.bincount(rel[inr], minlength=n).astype(np.int64)
        cursor = base + np.concatenate([[0], np.cumsum(table)[:-1]])
        start[c0:c0 + n] = cursor
        for t0 in range(0, K, tile):
            for j in range(t0, min(t0 + tile, K), 32):
                lanes = range(j, min(j + 32, K))
                keys = [int(rel[k]) if inr[k] else -1 for k in lanes]
                cur = [cursor[c] if c >= 0 else 0 for c in keys]
                for i, (k, c) in enumerate(zip(lanes, keys)):
                    if c >= 0:
                        ids[cur[i] + keys[:i].count(c)] = k
                for i, c in enumerate(keys):
                    if c >= 0 and c not in keys[i + 1:]:
                        cursor[c] = cur[i] + keys.count(c)
        base += int(table.sum())
    start[ncell] = K
    return ids, start


@pytest.mark.parametrize("range_cells,tile", [(49152, 2048), (7, 32),
                                              (100, 64), (1, 96)])
@pytest.mark.parametrize("kind,seed,K,H,W", BUCKET_CASES[:5])
def test_knn_bucket_kernel_model(kind, seed, K, H, W, range_cells, tile):
    """The kernel's ranged, staged placement gives the stable buckets for
    any range of cells and tile of clusters."""
    y, x = _bucket_centres(kind, seed, K, H, W)
    ids, start = _bucket_kernel_model(y, x, H, W, range_cells, tile)
    want_ids, want_start = knn_kernel.knn_buckets_plain(
        torch.from_numpy(y), torch.from_numpy(x), H, W)
    np.testing.assert_array_equal(ids, want_ids.numpy())
    np.testing.assert_array_equal(start, want_start.numpy())


def _warp_walk(y, x, H, W, m):
    """knn_kernel's walk (csrc/knn.cu) in numpy: each query's window rows
    as one sequence of candidates, taken 32 a batch; the candidates whose
    distance reaches the heap's top at the batch's start are dropped at
    once, the others run one by one in lane order against the current
    top, with the heap's push and at most one pop."""
    K = y.shape[0]
    S, nh, nw = knn_kernel.grid(H, W, K)
    ids, start = (t.numpy() for t in knn_kernel.knn_buckets_plain(
        torch.from_numpy(y), torch.from_numpy(x), H, W))
    out = np.full((K, m), -1, np.int32)
    counts = np.zeros(K, np.int32)
    for k in range(K):
        cy, cx = _c_cell(y[k], S), _c_cell(x[k], S)
        gy0, gy1 = max(cy - 3, 0), min(cy + 3, nh)
        gx0, gx1 = max(cx - 3, 0), min(cx + 3, nw)
        seq = []
        if gx0 < gx1:
            for gy in range(gy0, gy1):
                seq.extend(ids[start[gy * nw + gx0]:start[gy * nw + gx1]])
        heap = []
        for b0 in range(0, len(seq), 32):
            batch = seq[b0:b0 + 32]
            dist = [int(abs(x[n] - x[k]) + abs(y[n] - y[k])) for n in batch]
            top = heap[0][0] if heap else None
            for d, n in zip(dist, batch):
                if n == k or (top is not None and d >= top):
                    continue
                if heap and heap[0][0] <= d:
                    continue
                knn_kernel._heap_push(heap, (d, int(n)))
                if len(heap) > m:
                    knn_kernel._heap_pop(heap)
        counts[k] = len(heap)
        out[k, :len(heap)] = [n for _, n in heap]
    return out, counts


@pytest.mark.parametrize("seed,K,H,W", [(0, 300, 240, 320), (1, 50, 97, 61),
                                        (2, 1000, 100, 900)])
@pytest.mark.parametrize("m", [1, 4, 8, 60])
def test_knn_warp_walk_matches_plain(seed, K, H, W, m):
    """Rejecting a batch's candidates against the top read at its start
    changes nothing: the heap's maximum never rises during a walk."""
    rng = np.random.default_rng(seed)
    yxm = np.zeros((K, 6), np.float32)
    yxm[:, 0] = rng.uniform(0, H, K)
    yxm[:, 1] = rng.uniform(0, W, K)
    yxm[:5, 0], yxm[5:10, 1] = H - 1, W - 1
    yxm[10:15, 0], yxm[15:20, 1] = 0, 0
    yxm[20, 0], yxm[20, 1] = H + 3.5, W + 7.25
    y, x = yxm[:, 0].copy(), yxm[:, 1].copy()
    nbr, counts = knn_kernel.knn_plain(torch.from_numpy(y),
                                       torch.from_numpy(x), H, W, m)
    got = _warp_walk(y, x, H, W, m)
    np.testing.assert_array_equal(got[0], nbr.numpy())
    np.testing.assert_array_equal(got[1], counts.numpy())


def test_knn_packed_layout():
    """knn(..., packed=True) is nbr's rows, then the counts."""
    y, x = _bucket_centres("edges", 6, 120, 60, 80)
    ys, xs = torch.from_numpy(y), torch.from_numpy(x)
    nbr, counts = knn_kernel.knn(ys, xs, 60, 80, 5)
    packed = knn_kernel.knn(ys, xs, 60, 80, 5, packed=True)
    assert packed.dtype == torch.int32 and packed.shape == (120 * 6,)
    np.testing.assert_array_equal(packed[:600].reshape(120, 5), nbr)
    np.testing.assert_array_equal(packed[600:], counts)


def test_knn_degenerate():
    st, _ = _clusters(np.zeros((3, 6), np.float32))
    nbr, counts = knn_kernel.knn_plain(torch.from_numpy(st.y),
                                       torch.from_numpy(st.x), 10, 10, 0)
    assert nbr.shape == (3, 0) and counts.tolist() == [0, 0, 0]
    gnbr, glens = graph.knn(st, 0, (10, 10), "cpu")
    assert gnbr.shape == (3, 1) and (gnbr == -1).all() and glens.sum() == 0


@pytest.mark.parametrize("seed,H,W,K", [(0, 40, 57, 30), (1, 64, 64, 200),
                                        (2, 9, 5, 60)])
def test_densities_match_jax(seed, H, W, K):
    rng = np.random.default_rng(seed)
    lab = _random_labels(rng, H, W, K)
    lab[rng.random((H, W)) < 0.05] = -1
    yxm = np.zeros((K, 6), np.float32)
    yxm[:, 2] = np.bincount(lab[lab >= 0], minlength=K)
    yxm[::7, 2] = 0  # num_members 0 divides by 1
    st, jst = _clusters(yxm)
    mask = rng.integers(0, 256, size=(H, W), dtype=np.uint8)
    want = jgraph.mask_density(mask, lab, jst)
    got = graph.mask_density(mask, lab, st, "cpu")
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    back = graph.density_to_mask(want, lab, K, "cpu")
    assert back.dtype == np.uint8
    np.testing.assert_array_equal(back, jgraph.density_to_mask(want, lab, K))


def test_model_methods_720p(ref720, crf_ref):
    from chip_smoke import CRF_KNN, crf_mask
    for t in range(len(ref720["slice_labels"])):
        labels = ref720["slice_labels"][t]
        model = _model(ref720["slice_clusters"][t])
        nbr, lens = model.get_connectivity(labels).matrix()
        np.testing.assert_array_equal(lens, crf_ref["adj_lens"][t])
        np.testing.assert_array_equal(
            nbr, crf_ref["adj_nbr"][t][:, :nbr.shape[1]])
        nbr, lens = model.get_knn_connectivity(labels, CRF_KNN).matrix()
        np.testing.assert_array_equal(nbr, crf_ref["knn_nbr"][t])
        np.testing.assert_array_equal(lens, crf_ref["knn_lens"][t])
        dens = model.get_mask_density(crf_mask(t, 720, 1280), labels)
        np.testing.assert_array_equal(dens, crf_ref["density"][t])
        np.testing.assert_array_equal(
            model.broadcast_density_to_mask(dens, labels),
            crf_ref["density_mask"][t])


def test_connectivity_and_density_on_slic(image_factory):
    """tests/test_api.py's test_connectivity_and_density on the port, and
    each result equal to a JAX model's holding the same clusters."""
    from fast_slic_tpu import SlicModel as JaxModel
    from fast_slic_tpu_torch import Slic
    img = image_factory(80, 80)
    slic = Slic(num_components=9, min_size_factor=0.2, device="cpu")
    assignment = slic.iterate(img)
    model = slic.slic_model
    jmodel = JaxModel(9)
    jmodel._clusters = _clusters(model.to_yxmrgb().astype(np.float32))[1]
    jmodel.initialized = True
    conn = model.get_connectivity(assignment)
    lists = conn.tolist()
    assert len(lists) == 9
    for i, l in enumerate(lists):  # symmetric and self-free
        assert i not in l
        for j in l:
            assert i in lists[j]
    assert lists == jmodel.get_connectivity(assignment).tolist()

    knn = model.get_knn_connectivity(assignment, 4)
    assert all(len(l) <= 4 for l in knn.tolist())
    assert knn.tolist() == jmodel.get_knn_connectivity(assignment, 4).tolist()

    mask = (img[..., 0] > 128).astype(np.uint8) * 255
    dens = model.get_mask_density(mask, assignment)
    assert dens.shape == (9,) and dens.dtype == np.uint8
    np.testing.assert_array_equal(
        dens, jmodel.get_mask_density(mask, assignment))
    back = model.broadcast_density_to_mask(dens, assignment)
    assert back.shape == (80, 80) and back.dtype == np.uint8
    np.testing.assert_array_equal(
        back, jmodel.broadcast_density_to_mask(dens, assignment))


def test_model_method_errors():
    model = SlicModel(4, device="cpu")
    with pytest.raises(ValueError):
        model.get_mask_density(np.zeros((3, 4), np.uint8),
                               np.zeros((4, 3), np.int16))
    with pytest.raises(ValueError):
        model.broadcast_density_to_mask(np.zeros(5, np.uint8),
                                        np.zeros((4, 3), np.int16))


def test_graph_ops_default_to_the_card():
    """Numpy input with no device goes to the card, which raises without a
    GPU (no silent run on the host)."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works")
    lab = np.zeros((4, 5), np.int32)
    st, _ = _clusters(np.zeros((3, 6), np.float32))
    mask = np.zeros((4, 5), np.uint8)
    for call in (lambda: graph.adjacency_matrix(lab, 3),
                 lambda: graph.adjacency(lab, 3),
                 lambda: graph.knn(st, 2, (4, 5)),
                 lambda: graph.mask_density(mask, lab, st),
                 lambda: graph.density_to_mask(np.zeros(3, np.uint8), lab,
                                               3)):
        with pytest.raises(RuntimeError, match="cuda"):
            call()


def test_graph_ops_tensors_decide_the_device():
    """Tensor arguments are used where they lie: CPU tensors with no device
    run on the CPU (equal to the numpy path); a tensor on another device
    than the one named raises rather than being moved."""
    rng = np.random.default_rng(7)
    lab = _random_labels(rng, 30, 41, 20, True)
    K = 20
    yxm = np.zeros((K, 6), np.float32)
    yxm[:, 0], yxm[:, 1] = rng.uniform(0, 30, K), rng.uniform(0, 41, K)
    yxm[:, 2] = np.bincount(lab.ravel(), minlength=K)
    st, _ = _clusters(yxm)
    tst = st.to_torch("cpu")
    mask = rng.integers(0, 256, size=lab.shape, dtype=np.uint8)
    tlab, tmask = torch.from_numpy(lab), torch.from_numpy(mask)
    for want, got in zip(graph.adjacency_matrix(lab, K, "cpu"),
                         graph.adjacency_matrix(tlab, K)):
        np.testing.assert_array_equal(got, want)
    for want, got in zip(graph.knn(st, 3, lab.shape, "cpu"),
                         graph.knn(tst, 3, lab.shape)):
        np.testing.assert_array_equal(got, want)
    dens = graph.mask_density(mask, lab, st, "cpu")
    np.testing.assert_array_equal(graph.mask_density(tmask, tlab, tst), dens)
    np.testing.assert_array_equal(
        graph.density_to_mask(torch.from_numpy(dens), tlab, K),
        graph.density_to_mask(dens, lab, K, "cpu"))
    with pytest.raises(ValueError, match="requested"):
        graph.adjacency_matrix(tlab, K, "cuda")
    with pytest.raises(ValueError, match="requested"):
        graph.knn(tst, 3, lab.shape, "cuda")
    with pytest.raises(ValueError, match="several devices"):
        graph.mask_density(tmask, tlab.to("meta"), st)
