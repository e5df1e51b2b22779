"""PyTorch port: each CUDA kernel against its plain PyTorch version.

Needs a CUDA device; every test here skips without one.  The file imports
neither jax nor tests/conftest.py's helpers, so on a GPU machine without
JAX it runs on its own:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

Exact: integer outputs (the CCA's selection and orphan chase too: every
bin of the substitute table and the tie flags, on random tables with
boundary ties, fewer, as many and more components over the threshold than
K, one component, a component a bin, a threshold of 0 and one above every
area, the row-sharded CCA's tables, four stacked frames of their own
component counts, targets anywhere below their entry, one chain of 8998
dropped components and a real 720p frame's tables, alone and stacked; one
launch a call whatever the frames, and no host sync; the
components on one label, superpixels across every tile seam, a serpentine,
1 x n, n x 1 and 33 x 33 maps and the stacked map of four frames; the
assign on cells without candidates, 4 and 48 slots, K=6000, W=1277, a view
off the 16-byte boundary, S=21, 67 and 151, duplicate centres and three
stacked frames, each remainder and both distances; the float assign on the
same cases and real_noq centres a hair either side of a whole pixel, for
each variant) and the float assign's distances must be equal;
the LSC colour features too, and so must both update sums on each branch
of their kernels (superpixel-like tiles, one cluster whose sums wrap,
random ids that overflow the shared table, ragged and misaligned rows,
empty and full masks), the segment sum (the CCA's ids and values of a 720p
superpixel map, runs, one id, random ids over more bins than its table,
ids outside the bins, which drop, sums that wrap, 1, 2, 3 and 5 planes, a
ragged length and a misaligned view), the per-frame
segment sum (each of those layouts in one and in three frames, with 1, 2
and 3 planes, and the CCA call of a stacked batch of four 720p frames)
and the frame-axis launches of assign, float assign and update.  The f32 segment sum must equal its plain version on the CPU,
whose order of addition it keeps, and give the same sums on every run
(on the card, index_add_ adds with float atomics in a changing order),
also with a preemptive-like mask at 720p, a single bin, empty bins and
unmasked pixels in the last bin.  On the card, the float variants' slices equal the CPU plain
path, and LSC's labels agree >= 0.999 (its image-wide f32 sums differ by
order between the two devices); so do the preemptive grid and the batched
frames (``BatchedSlic`` in stack and map mode).  The KNN kernel must
equal its host loop ``knn_plain`` (m from 1 to more than a window holds,
centres on and past the image's edges, identical centres, the 720p
clusters, heaps too large for shared memory, K=60,000 at 1080p) and the
JAX package's lists, in two launches a call; its bucketing kernel its
plain version (also in ranges of cells); the adjacency (a hot node past the
12-neighbour cap, labels outside [0, K), a 720p frame) and the densities
on the card those on the CPU; the CRF's class sum on the card the loop's
bits; and ``SimpleCRF`` at 720p (N=1600, C=21, four frames) the CPU's and
the JAX package's posteriors within rtol 2e-4, atol 1e-6, and the
counters of a sliding-window call the bytes its cycle moved.  The region
minimum of a seed per pixel (``propagate_min``) and per region
(``region_table``), and one seam of the sharded CCA's fixpoint
(``seam_min``, its changed flag too, and a seam where no label meets)
must equal their plain versions on random, serpentine, superpixel and
one-row or one-column maps, over the kernel's roots; four shards of one card
(``ShardedSlicExplicit``) must equal ``SlicAvx2`` at 720p, and a batch
over a mesh's data axis the batch without one.  The candidate kernel's
lists and overflow flag must equal the plain build's bit for bit (720p
K=1600 from the grid seeding and from a carried stream state, 4, 16 and 48
slots, no and one active cluster, four stacked frames, a row shard's call
with ``key=``, 4K K=14400, K=28000 and 40000 at 1080p, every centre in one
band on either side of the shared-memory limit, one cell row, one cell
column, a ragged grid), also OR-ed into a running flag; a build is at
most two device launches (one with a running flag) and no host sync.  A
carried 720p ``SlicAvx2`` stream re-runs for candidate overflow on its
first call at most, and its labels and clusters equal the JAX fixture's.
"""

import os
import sys

import numpy as np
import pytest
import torch

from fast_slic_tpu_torch import (LSCAvx2, SlicAvx2, SlicRealDist,
                                 SlicRealDistL2, SlicRealDistNoQ, pipeline,
                                 runner)
from fast_slic_tpu_torch import cluster as tcl
from fast_slic_tpu_torch.config import UNASSIGNED, RuntimeParams, StaticConfig
from fast_slic_tpu_torch.kernels import (assign, assign_float, cca, fsegsum,
                                         lab, launch_counts, lsc_feat, segsum)
from fast_slic_tpu_torch.ops.cca import (cca_parts, leader_ranks,
                                         segsum_values)
from fast_slic_tpu_torch.ops.cielab import rgb_to_lab_quantized_np
from fast_slic_tpu_torch.parallel.batch import BatchedSlic

pytestmark = pytest.mark.gpu

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data", "golden_ref.npz")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def rng():
    return np.random.default_rng(4321)


def _eq(a, b):
    torch.cuda.synchronize()
    np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy())


def test_lab_all_rgb_values(cuda):
    v = np.arange(1 << 24, dtype=np.uint32)
    cube = np.stack([(v >> 16) & 255, (v >> 8) & 255, v & 255],
                    -1).astype(np.uint8).reshape(4096, 4096, 3)
    got = lab.rgb_to_lab_planar(torch.from_numpy(cube).to(cuda)).cpu()
    for c in range(16):
        ref = rgb_to_lab_quantized_np(cube[c * 256:(c + 1) * 256])
        np.testing.assert_array_equal(
            got[:, c * 256:(c + 1) * 256].numpy(),
            np.moveaxis(ref, -1, 0).astype(np.int32))


def _state(rng, dev, H, W, K):
    image = rng.integers(0, 256, size=(H, W, 3)).astype(np.uint8)
    st = tcl.initialize_clusters(image, K)
    st.y = np.clip(st.y + rng.uniform(-6, 6, K), 0, H - 1).astype(np.float32)
    st.x = np.clip(st.x + rng.uniform(-6, 6, K), 0, W - 1).astype(np.float32)
    planes = lab.rgb_to_lab_planar(torch.from_numpy(image).to(dev))
    return image, st.to_torch(dev), planes


@pytest.mark.parametrize("manhattan", [True, False])
@pytest.mark.parametrize("stride,rem", [(3, 0), (3, 1), (3, 2), (1, 0),
                                        (2, 1)])
def test_assign_kernel_matches_plain(cuda, rng, manhattan, stride, rem):
    H, W, K = 123, 217, 57
    _, st, planes = _state(rng, cuda, H, W, K)
    cfg = StaticConfig(H=H, W=W, K=K, manhattan_spatial_dist=manhattan)
    coef = pipeline.derive_scalars(cfg, 10.0, 0.25).coef
    cand, _ = pipeline.build_candidates(st.y, st.x, st.is_active, cfg)
    table = pipeline.center_table(st)
    old = torch.from_numpy(rng.integers(0, K, size=(H, W)).astype(
        np.int32)).to(cuda)
    outs = []
    for fn in (assign.assign, assign.plain):
        a = old.clone()
        md = torch.full_like(a, UNASSIGNED)
        fn(planes, table, cand, a, coef, cfg.S, stride, rem, manhattan,
           min_dists=md)
        outs.append((a, md))
    _eq(outs[0][0], outs[1][0])
    _eq(outs[0][1], outs[1][1])


@pytest.mark.parametrize("stride,rem", [(3, 2), (1, 0)])
def test_slic_update_kernel_matches_plain(cuda, rng, stride, rem):
    H, W, K = 131, 250, 77
    a = rng.integers(0, K, size=(H, W)).astype(np.int32)
    a[rng.random((H, W)) < 0.05] = UNASSIGNED
    a = torch.from_numpy(a).to(cuda)
    planes = torch.from_numpy(rng.integers(0, 256, size=(3, H, W)).astype(
        np.int32)).to(cuda)
    _eq(segsum.slic_update(a, planes, K, stride, rem),
        segsum.slic_update_plain(a, planes, K, stride, rem))


def test_segment_sum_kernel_matches_plain(cuda, rng):
    N, V, S = 100003, 3, 4000
    ids = torch.from_numpy(rng.integers(0, S + 1, size=N).astype(
        np.int32)).to(cuda)
    vals = torch.from_numpy(rng.integers(0, 1 << 20, size=(V, N)).astype(
        np.int32)).to(cuda)
    _eq(segsum.segment_sum(ids, vals, S),
        segsum.segment_sum_plain(ids, vals, S))


def _spiral(H, W=None):
    W = H if W is None else W
    lab_ = np.ones([H, W], np.int32)
    lab_[::2, :] = 0
    for i, r in enumerate(range(1, H, 2)):
        lab_[r, (W - 1) if i % 2 == 0 else 0] = 0   # a serpentine
    return lab_


@pytest.mark.parametrize("kind", ["random", "few", "serpentine",
                                  "unassigned", "checker"])
def test_connected_components_kernel_matches_plain(cuda, rng, kind):
    H, W = 301, 517
    if kind == "random":
        labels = rng.integers(0, 5, size=(H, W))
    elif kind == "few":
        labels = rng.integers(0, 2, size=(H // 8, W // 8)).repeat(
            8, 0).repeat(8, 1)
    elif kind == "serpentine":
        labels = _spiral(257)
    elif kind == "unassigned":
        labels = rng.integers(0, 3, size=(H, W))
        labels[labels == 2] = UNASSIGNED
    else:
        labels = np.indices((H, W)).sum(0) % 2
    t = torch.from_numpy(np.ascontiguousarray(labels, np.int32)).to(cuda)
    _eq(cca.connected_components(t), cca.connected_components_plain(t))


# the kernel labels 32x32 tiles on chip, then unites across tile seams: one
# label over the whole map, superpixels that cross every seam (with
# UNASSIGNED pixels), a serpentine that threads every tile, maps of one row,
# one column and one tile plus a pixel (ragged tiles), and the stacked map of
# four frames that ops.cca.framed_components builds (label f*K + k,
# UNASSIGNED 0x10000 + f)
@pytest.mark.parametrize("case", ["one_label_720p", "superpixels_720p",
                                  "serpentine_720p", "row_1x1000",
                                  "col_1000x1", "square_33",
                                  "stacked_4x720p"])
def test_connected_components_kernel_cases(cuda, rng, case):
    if case == "one_label_720p":
        labels = np.zeros((720, 1280), np.int32)
    elif case == "superpixels_720p":
        labels = _superpixels(rng, 1, 720, 1280)[0][0]
    elif case == "serpentine_720p":
        labels = _spiral(720, 1280)
    elif case == "stacked_4x720p":
        a, K = _superpixels(rng, 4, 720, 1280)
        f = np.arange(4)[:, None, None]
        labels = np.where(a == UNASSIGNED, 0x10000 + f,
                          a + f * K).reshape(4 * 720, 1280)
    else:
        shape = {"row_1x1000": (1, 1000), "col_1000x1": (1000, 1),
                 "square_33": (33, 33)}[case]
        labels = rng.integers(0, 2, size=shape)
    t = torch.from_numpy(np.ascontiguousarray(labels, np.int32)).to(cuda)
    _eq(cca.connected_components(t), cca.connected_components_plain(t))


@pytest.mark.parametrize("n", ["311x97", 0, 1, 3, 5, "offset"])
def test_lookup_kernel_matches_plain(cuda, rng, n):
    table = torch.from_numpy(rng.integers(0, 1 << 30, size=7777).astype(
        np.int32)).to(cuda)
    shape = {"311x97": (311, 97), "offset": (30011,)}.get(n, (n,))
    ids = torch.from_numpy(rng.integers(0, 7777, size=shape).astype(
        np.int32)).to(cuda)
    if n == "offset":
        # a view one int past a 16-byte boundary: the scalar path
        ids = torch.cat([ids[:1], ids])[1:]
        assert ids.data_ptr() % 16 == 4
    _eq(cca.lookup(ids, table), cca.lookup_plain(ids, table))


def _frame_720p():
    image = np.load(DATA)["image"]
    ys = np.arange(720) * image.shape[0] // 720
    xs = np.arange(1280) * image.shape[1] // 1280
    return np.ascontiguousarray(image[ys][:, xs])


def _raw_720p_orphan_tables(dev):
    """The component tables of a real raw assignment: SlicAvx2's loop at
    720p, K=1600, then the CCA's components.  Returns (areas int32 [n],
    orphan target int32 [n], num_components int64, K, the area
    threshold)."""
    frame = _frame_720p()
    H, W, K = 720, 1280, 1600
    cfg = StaticConfig(H=H, W=W, K=K)
    scal = pipeline.derive_scalars(cfg, 10.0, 0.25)
    out = pipeline.iterate_graph(torch.from_numpy(frame).to(dev),
                                 tcl.initialize_clusters(frame, K).to_torch(
                                     dev), cfg, scal, 10, 3)
    _, areas, target, ncomp = cca_parts(out.raw_assignment)
    return areas, target, ncomp, K, int(scal.thres)


def _select_tables(rng, n, nc, high):
    """Random component tables of one frame with n bins: areas in [1, high]
    for the nc components (so ties are many where high is small), targets
    below their own entry, and garbage in the empty bins, which the
    selection must not read."""
    areas = rng.integers(1, high + 1, size=n).astype(np.int32)
    areas[nc:] = rng.integers(0, 1 << 20, size=n - nc)
    target = np.zeros(n, np.int32)
    target[1:] = rng.integers(0, np.arange(1, n))
    target[nc:] = rng.integers(-5, 1 << 20, size=n - nc)
    return areas, target


def _plant_tie(areas, nc, K, thr):
    """Give the K-th largest kept area to a few more components, so the
    top-K boundary ties."""
    kept = np.flatnonzero(areas[:nc] >= thr)
    order = kept[np.argsort(-areas[kept], kind="stable")]
    areas[order[K:K + 5]] = areas[order[K - 1]]
    return areas


def _select_case(rng, case, dev):
    """(areas, target, num_components, K, threshold, n_pixels, expected
    tie flags or None) of one case; stacked cases are [B, n] views with a
    frame stride of two tables, as the per-frame segment sum gives them."""
    def one(n, nc, high, K, thr, tie=None, n_pixels=None):
        areas, target = _select_tables(rng, n, nc, high)
        if tie:
            areas = _plant_tie(areas, nc, K, thr)
        return (torch.from_numpy(areas).to(dev),
                torch.from_numpy(target).to(dev),
                torch.tensor(nc, dtype=torch.int64, device=dev), K, thr,
                n_pixels, tie)

    if case == "boundary_ties":
        return one(20000, 5000, 5000, 1600, 10, tie=True)
    if case == "kept_below_k":
        return one(9000, 3000, 40, 1600, 25)       # ~1200 over 25
    if case == "kept_equal_k":
        areas, target = _select_tables(rng, 9000, 3000, 500)
        areas[:3000] = np.where(np.arange(3000) < 1600,
                                rng.integers(30, 500, 3000), 5)
        return (torch.from_numpy(areas).to(dev),
                torch.from_numpy(target).to(dev),
                torch.tensor(3000, dtype=torch.int64, device=dev), 1600, 30,
                None, False)
    if case == "kept_above_k":
        return one(9000, 6000, 300000, 1600, 10, n_pixels=921600)
    if case == "nc_1":
        return one(4096, 1, 4096, 1600, 10)
    if case == "nc_n":
        # a component a pixel at 720p: the kernel's most work
        return one(921600, 921600, 60, 1600, 4)
    if case == "threshold_0":
        return one(9000, 3000, 900, 1600, 0)
    if case == "threshold_above_all":
        return one(9000, 3000, 900, 1600, 901)
    if case == "sharded":
        # the row-sharded CCA's tables: as many bins as components, areas
        # up to the image's pixel count (above 2^24: three digit passes)
        return one(2800, 2800, 3840 * 4400, 1600, 3500,
                   n_pixels=3840 * 4400)
    if case == "sharded_ties":
        return one(2800, 2800, 700, 1600, 3, tie=True, n_pixels=3840 * 2160)
    if case in ("stacked_4", "raw_720p_stacked"):
        if case == "stacked_4":
            frames = [_select_tables(rng, 6000, nc, high)
                      for nc, high in ((4200, 600), (1, 50), (6000, 40),
                                       (1500, 3000))]
            frames[0] = (_plant_tie(frames[0][0], 4200, 1600, 5),
                         frames[0][1])
            ncs = [4200, 1, 6000, 1500]
            K, thr = 1600, 5
        else:
            areas, target, ncomp, K, thr = _raw_720p_orphan_tables(dev)
            nc = int(ncomp)
            a, t = areas.cpu().numpy(), target.cpu().numpy()
            frames = [(a, t), (_plant_tie(a.copy(), nc, K, thr), t),
                      (a, t), (a, t)]
            ncs = [nc, nc, nc // 2, 0]
        acc = np.stack([np.stack(f) for f in frames])   # [B, 2, n]
        acc = torch.from_numpy(acc).to(dev)
        return (acc[:, 0], acc[:, 1],
                torch.tensor(ncs, dtype=torch.int64, device=dev), K, thr,
                None, None)
    if case == "any_targets":
        # targets anywhere below their own entry: half a few entries back,
        # so chains of several dropped components run inside a round of the
        # chase, half uniform, so they reach into earlier rounds
        areas, target = _select_tables(rng, 12000, 10000, 3000)
        i = np.arange(1, 10000)
        near = np.maximum(i - rng.integers(1, 9, size=i.size), 0)
        target[1:10000] = np.where(rng.random(i.size) < 0.5, near,
                                   target[1:10000])
        return (torch.from_numpy(areas).to(dev),
                torch.from_numpy(target).to(dev),
                torch.tensor(10000, dtype=torch.int64, device=dev), 1600, 10,
                None, None)
    if case == "long_chain":
        # components 0 and 1 kept (labels 0 and 1), 2..8999 dropped, each
        # adopting the one before it: one chain of 8998 hops across three
        # rounds of the chase, 4095 of them inside one round, which only
        # the pointer jumping ends; every orphan must come out 1
        n = nc = 9000
        areas = np.full(n, 2, np.int32)
        areas[:2] = 5000
        target = np.maximum(np.arange(n, dtype=np.int32) - 1, 0)
        return (torch.from_numpy(areas).to(dev),
                torch.from_numpy(target).to(dev),
                torch.tensor(nc, dtype=torch.int64, device=dev), 1600, 10,
                None, False)
    if case == "raw_720p":
        areas, target, ncomp, K, thr = _raw_720p_orphan_tables(dev)
        return areas, target, ncomp, K, thr, None, None
    raise KeyError(case)


SELECT_CASES = ["boundary_ties", "kept_below_k", "kept_equal_k",
                "kept_above_k", "nc_1", "nc_n", "threshold_0",
                "threshold_above_all", "sharded", "sharded_ties",
                "stacked_4", "any_targets", "long_chain", "raw_720p",
                "raw_720p_stacked"]


@pytest.mark.parametrize("case", SELECT_CASES)
def test_cca_select_kernel_matches_plain(cuda, rng, case):
    """The substitute table (every bin, the empty ones too) and the tie
    flags of the kernel equal the plain version's bit for bit."""
    areas, target, ncomp, K, thr, n_pixels, tie = _select_case(rng, case,
                                                               cuda)
    got_sub, got_tie = cca.cca_select(areas, target, ncomp, K, thr, n_pixels)
    want_sub, want_tie = cca.cca_select_plain(areas.cpu(), target.cpu(),
                                              ncomp.cpu(), K, thr, n_pixels)
    _eq(got_sub, want_sub)
    _eq(got_tie, want_tie)
    assert got_sub.shape == areas.shape and got_tie.shape == ncomp.shape
    assert not bool((got_sub == UNASSIGNED).any())
    if tie is not None:
        assert bool(want_tie.all()) == tie
    if case == "stacked_4":
        assert want_tie.tolist() == [True, False, True, False]
    if case == "long_chain":
        assert got_sub[:2].tolist() == [0, 1]
        assert bool((got_sub[2:] == 1).all())


@pytest.mark.parametrize("B", [1, 4])
def test_cca_select_is_one_launch_without_host_sync(cuda, B):
    """One call launches the kernel once, whatever the number of frames,
    and never waits on the device."""
    areas, target, ncomp, K, thr = _raw_720p_orphan_tables(cuda)
    if B > 1:
        areas, target = (t.expand(B, -1).contiguous() for t in (areas,
                                                                 target))
        ncomp = ncomp.expand(B).contiguous()
    torch.cuda.synchronize()
    before = launch_counts()["cca_select"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        sub, tie = cca.cca_select(areas, target, ncomp, K, thr)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert launch_counts()["cca_select"] == before + 1
    want_sub, want_tie = cca.cca_select_plain(areas.cpu(), target.cpu(),
                                              ncomp.cpu(), K, thr)
    _eq(sub, want_sub)
    _eq(tie, want_tie)


def test_slice_on_gpu_matches_cpu(cuda, rng):
    H, W, K = 200, 300, 150
    frames = [rng.integers(0, 256, size=(H // 10, W // 10, 3)).repeat(
        10, 0).repeat(10, 1).astype(np.uint8) for _ in range(2)]
    gpu = SlicAvx2(num_components=K, device=cuda)
    cpu = SlicAvx2(num_components=K, device="cpu")
    for f in frames:
        np.testing.assert_array_equal(gpu.iterate(f), cpu.iterate(f))
        np.testing.assert_array_equal(gpu.slic_model.to_yxmrgb(),
                                      cpu.slic_model.to_yxmrgb())


@pytest.mark.parametrize("name,flags,over", [
    ("std_k256_euclid", {"manhattan_spatial_dist": False}, {}),
    ("std_k256_stride1", {}, {"subsample_stride": 1}),
])
def test_golden_on_gpu(cuda, name, flags, over):
    g = np.load(DATA)
    image = g["image"]
    H, W = image.shape[:2]
    params = RuntimeParams(compactness=10.0, min_size_factor=0.1,
                           subsample_stride=3, max_iter=10)
    for k, v in over.items():
        setattr(params, k, v)
    res = runner.run_iterate(StaticConfig(H=H, W=W, K=256, **flags), image,
                             tcl.initialize_clusters(image, 256), params,
                             cuda)
    np.testing.assert_array_equal(res.labels, g[name])


@pytest.mark.parametrize("variant,manhattan", [
    ("real", True), ("real", False), ("real_l2", True), ("real_noq", True),
    ("real_noq", False), ("lsc", True)])
@pytest.mark.parametrize("stride,rem", [(3, 0), (3, 2), (1, 0)])
def test_assign_float_kernel_matches_plain(cuda, rng, variant, manhattan,
                                           stride, rem):
    H, W, K = 123, 217, 57
    _, st, planes = _state(rng, cuda, H, W, K)
    # fractional centres and colours (real_noq's float means)
    st = st.replace(r=st.r + 0.37, g=st.g + 0.61)
    cfg = StaticConfig(H=H, W=W, K=K, variant=variant,
                       manhattan_spatial_dist=manhattan)
    coef = pipeline.derive_scalars(cfg, 10.0, 0.25).coef
    cand, _ = pipeline.build_candidates(st.y, st.x, st.is_active, cfg)
    table = pipeline.center_table(st)
    feats = torch.from_numpy(rng.random((10, H, W), np.float32)).to(cuda)
    cent = torch.from_numpy(rng.random((K, 10), np.float32)).to(cuda)
    old = torch.from_numpy(rng.integers(0, K, size=(H, W)).astype(
        np.int32)).to(cuda)
    outs = []
    for fn in (assign_float.assign_float, assign_float.plain):
        a = old.clone()
        md = torch.full((H, W), -1.0, device=cuda)
        fn(planes, table, cand, a, coef, cfg.S, stride, rem, variant,
           manhattan, md, feats, cent)
        outs.append((a, md))
    _eq(outs[0][0], outs[1][0])
    _eq(outs[0][1], outs[1][1])


def test_lsc_feat_kernel_matches_plain(cuda, rng):
    planes = torch.from_numpy(rng.integers(-3, 259, size=(3, 301, 517)).astype(
        np.int32)).to(cuda)
    tabs = [torch.from_numpy(rng.normal(size=256).astype(np.float32)).to(cuda)
            for _ in range(4)]
    _eq(lsc_feat.lsc_color_feats(planes, *tabs), lsc_feat.plain(planes, *tabs))


@pytest.mark.parametrize("K", [300, 6000])
@pytest.mark.parametrize("wrow", [None, 10])
def test_fsegsum_kernel_matches_plain(cuda, rng, K, wrow):
    N, V = 100003, 11
    ids = torch.from_numpy(rng.integers(0, K + 1, size=N).astype(
        np.int32)).to(cuda)
    mask = torch.from_numpy((rng.random(N) < 0.9).astype(np.int32)).to(cuda)
    vals = torch.from_numpy(rng.normal(size=(V, N)).astype(np.float32)).to(
        cuda)
    got = fsegsum.float_segsum(ids, mask, vals, K, wrow)
    _eq(got, fsegsum.plain(ids.cpu(), mask.cpu(), vals.cpu(), K, wrow))
    _eq(got, fsegsum.float_segsum(ids, mask, vals, K, wrow))


def _fsegsum_case(rng, case):
    """(ids int32 [N], mask int32 [N], K) of one segment-sum case."""
    if case == "preemptive_720p":
        # LSC's call at stride 3: rows 0::3 of a 720p map of 24x24 cells
        # (K = 1600 clusters), 17 % of the pixels masked in whole 48x48 cells
        K = 1600
        yy, xx = np.indices((720, 1280))
        ids = np.minimum((yy // 24) * 54 + xx // 24, K - 1)
        ids[rng.random(ids.shape) < 0.02] = K      # unassigned: masked too
        dead = rng.random((15, 27)) < 0.17
        mask = ~dead[yy // 48, xx // 48] & (ids != K)
        return ids[0::3].ravel(), mask[0::3].ravel(), K
    N = 100003
    if case == "one_bin":
        return np.zeros(N, np.int64), rng.random(N) < 0.9, 40
    if case == "empty_bins":
        K = 3000
        return rng.choice([5, 17, 2999], N), rng.random(N) < 0.9, K
    if case == "unmasked_bin_k":
        K = 300
        ids = rng.integers(0, K + 1, N)
        ids[rng.random(N) < 0.3] = K
        return ids, rng.random(N) < 0.95, K
    raise KeyError(case)


@pytest.mark.parametrize("wrow", [None, 10])
@pytest.mark.parametrize("case", ["preemptive_720p", "one_bin", "empty_bins",
                                  "unmasked_bin_k"])
def test_fsegsum_kernel_cases(cuda, rng, case, wrow):
    ids, mask, K = _fsegsum_case(rng, case)
    ids = torch.from_numpy(ids.astype(np.int32)).to(cuda)
    mask = torch.from_numpy(mask.astype(np.int32)).to(cuda)
    vals = torch.from_numpy(rng.normal(size=(11, ids.numel())).astype(
        np.float32)).to(cuda)
    got = fsegsum.float_segsum(ids, mask, vals, K, wrow)
    _eq(got, fsegsum.plain(ids.cpu(), mask.cpu(), vals.cpu(), K, wrow))
    _eq(got, fsegsum.float_segsum(ids, mask, vals, K, wrow))


@pytest.mark.parametrize("cls", [SlicRealDist, SlicRealDistL2,
                                 SlicRealDistNoQ])
def test_real_variants_on_gpu_match_cpu(cuda, rng, cls):
    H, W, K = 200, 300, 150
    frame = rng.integers(0, 256, size=(H // 10, W // 10, 3)).repeat(
        10, 0).repeat(10, 1).astype(np.uint8)
    gpu = cls(num_components=K, device=cuda)
    cpu = cls(num_components=K, device="cpu")
    np.testing.assert_array_equal(gpu.iterate(frame), cpu.iterate(frame))
    np.testing.assert_array_equal(gpu.slic_model.to_yxmrgb(),
                                  cpu.slic_model.to_yxmrgb())


def test_lsc_on_gpu_matches_cpu(cuda, rng):
    H, W, K = 200, 300, 150
    frame = rng.integers(0, 256, size=(H // 10, W // 10, 3)).repeat(
        10, 0).repeat(10, 1).astype(np.uint8)
    gpu = LSCAvx2(num_components=K, device=cuda)
    cpu = LSCAvx2(num_components=K, device="cpu")
    agree = float((gpu.iterate(frame) == cpu.iterate(frame)).mean())
    assert agree >= 0.999, agree


@pytest.mark.parametrize("name,variant", [("real_k256", "real"),
                                          ("l2_k256", "real_l2"),
                                          ("noq_k256", "real_noq"),
                                          ("lsc_k256", "lsc")])
def test_float_golden_on_gpu(cuda, name, variant):
    g = np.load(DATA)
    image = g["image"]
    H, W = image.shape[:2]
    params = RuntimeParams(compactness=10.0, min_size_factor=0.1,
                           subsample_stride=3, max_iter=10)
    res = runner.run_iterate(StaticConfig(H=H, W=W, K=256, variant=variant),
                             image, tcl.initialize_clusters(image, 256),
                             params, cuda)
    agree = float((res.labels == g[name]).mean())
    assert agree >= (0.999 if variant == "lsc" else 1.0), agree


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("stride,rem", [(3, 0), (3, 2), (1, 0)])
def test_slic_update_masked_kernel_matches_plain(cuda, rng, B, stride, rem):
    H, W, K = 131, 250, 77
    a = rng.integers(0, K, size=(B, H, W)).astype(np.int32)
    a[rng.random((B, H, W)) < 0.05] = UNASSIGNED
    a = torch.from_numpy(a).to(cuda)
    planes = torch.from_numpy(rng.integers(0, 256, size=(3, B, H, W)).astype(
        np.int32)).to(cuda)
    mask = torch.from_numpy(rng.random((B, H, W)) < 0.6).to(cuda)
    if B == 1:
        a, planes, mask = a[0], planes[:, 0].contiguous(), mask[0]
    _eq(segsum.slic_update_masked(a, planes, mask, K, stride, rem),
        segsum.slic_update_masked_plain(a, planes, mask, K, stride, rem))


def _superpixels(rng, B, H, W, S=24):
    """Superpixel-like assignments [B, H, W] and their K: S x S cells whose
    borders move by up to S/4 pixels a row and a column, ~5 % 0xFFFF."""
    GH, GW = -(-H // S), -(-W // S)
    a = np.empty((B, H, W), np.int32)
    for f in range(B):
        di = rng.integers(-(S // 4), S // 4 + 1, size=W)
        dj = rng.integers(-(S // 4), S // 4 + 1, size=H)
        ci = np.clip((np.arange(H)[:, None] + di) // S, 0, GH - 1)
        cj = np.clip((np.arange(W) + dj[:, None]) // S, 0, GW - 1)
        a[f] = ci * GW + cj
    a[rng.random(a.shape) < 0.05] = UNASSIGNED
    return a, GH * GW


def _offset(t):
    """A contiguous copy of t one element past a 16-byte boundary."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = flat[1:].view(t.shape)
    view.copy_(t)
    return view


# each branch of the update kernels: superpixel tiles (the shared table),
# one cluster (every lane one group; planes near 2^24, so the int32 sums
# wrap), random ids over K=4000 (the table overflows to device atomics),
# W % 4 != 0 and views off the 16-byte boundary (the scalar loads), and an
# all-zero and an all-one mask
UPDATE_CASES = ([(c, m) for c in ("superpixels_b1", "superpixels_b3",
                                  "one_cluster", "random_k4000", "ragged_w",
                                  "offset") for m in (False, True)]
                + [("mask_zero", True), ("mask_one", True)])


@pytest.mark.parametrize("stride,rem", [(3, 1), (1, 0)])
@pytest.mark.parametrize("case,masked", UPDATE_CASES)
def test_slic_update_kernel_cases(cuda, rng, case, masked, stride, rem):
    B, H, W = {"superpixels_b3": (3, 240, 384), "one_cluster": (1, 300, 512),
               "random_k4000": (1, 257, 515),
               "ragged_w": (1, 131, 1277)}.get(case, (1, 240, 640))
    planes = rng.integers(0, 256, size=(3, B, H, W))
    if case == "one_cluster":
        K = 5
        a = np.full((B, H, W), 3, np.int32)
        planes += (1 << 24) - 256
    elif case == "random_k4000":
        K = 4000
        a = rng.integers(0, K, size=(B, H, W)).astype(np.int32)
        a[rng.random(a.shape) < 0.05] = UNASSIGNED
    else:
        a, K = _superpixels(rng, B, H, W)
    mask = rng.random((B, H, W)) < 0.6
    if case in ("mask_zero", "mask_one"):
        mask[:] = case == "mask_one"
    a, planes, mask = (torch.from_numpy(x).to(cuda) for x in (
        a, planes.astype(np.int32), mask))
    if B == 1:
        a, planes, mask = a[0], planes[:, 0].contiguous(), mask[0]
    if case == "offset":
        a, planes, mask = _offset(a), _offset(planes), _offset(mask)
        assert a.data_ptr() % 16 == 4 and mask.data_ptr() % 4 == 1
    if masked:
        _eq(segsum.slic_update_masked(a, planes, mask, K, stride, rem),
            segsum.slic_update_masked_plain(a, planes, mask, K, stride, rem))
    else:
        _eq(segsum.slic_update(a, planes, K, stride, rem),
            segsum.slic_update_plain(a, planes, K, stride, rem))


def _assign_case(rng, dev, case, manhattan, variant="standard"):
    """(planes, table, cand, old assignment, coef, S) of one assign case;
    a leading frame dim for frames_3.  A float variant's centres get
    fractional colours (real_noq's float means)."""
    B = 3 if case == "frames_3" else 1
    H, W, K = {"k6000": (720, 1280, 6000), "w1277": (131, 1277, 290),
               "s21": (240, 384, 200), "s67": (240, 384, 20),
               "s151": (240, 384, 4)}.get(case, (240, 384, 160))
    cfg = StaticConfig(H=H, W=W, K=K, variant=variant,
                       manhattan_spatial_dist=manhattan,
                       cand_slots={"slots_4": 4, "slots_48": 48}.get(case, 16))
    sts = []
    for _ in range(B):
        st = tcl.initialize_clusters(
            rng.integers(0, 256, size=(H, W, 3)).astype(np.uint8), K)
        st.y = np.clip(st.y + rng.uniform(-6, 6, K), 0, H - 1).astype(
            np.float32)
        st.x = np.clip(st.x + rng.uniform(-6, 6, K), 0, W - 1).astype(
            np.float32)
        if case == "duplicates":
            # every odd cluster a copy of the even one before it: the
            # lower slot must win each tie
            for f in ("y", "x", "r", "g", "b"):
                v = getattr(st, f)
                v[1::2] = v[0:K - 1:2]
        if case == "inactive_patch":
            # a 5x7-cell patch of inactive clusters: its inner cells have
            # no candidate
            st.is_active[(st.y >= 48) & (st.y < 168) & (st.x >= 96)
                         & (st.x < 264)] = 0
        if case == "noq_edges":
            # centres a hair either side of a whole pixel, so that real_noq's
            # window edges trunc(c - S) and trunc((c + S) + 1) fall on both
            # sides of a row and a column
            for f, hi in (("y", H - 1), ("x", W - 1)):
                v = np.round(getattr(st, f)) + rng.choice([-1e-3, 1e-3], K)
                setattr(st, f, np.clip(v, 0, hi).astype(np.float32))
        if variant != "standard":
            st.r = (st.r + 0.37).astype(np.float32)
            st.g = (st.g + 0.61).astype(np.float32)
        sts.append(st)
    st = tcl.clusters_from_numpy(*(np.stack(xs) for xs in zip(
        *(s.fields() for s in sts)))).to_torch(dev)
    cand, _ = pipeline.build_candidates(st.y, st.x, st.is_active, cfg)
    table = pipeline.center_table(st)
    planes = torch.from_numpy(rng.integers(0, 256, size=(3, B, H, W)).astype(
        np.int32)).to(dev)
    old = torch.from_numpy(rng.integers(0, K, size=(B, H, W)).astype(
        np.int32)).to(dev)
    if B == 1:
        planes, table, cand, old = (planes[:, 0].contiguous(), table[0],
                                    cand[0], old[0])
    if case == "offset":
        planes = _offset(planes)
        assert planes.data_ptr() % 16 == 4
    coef = pipeline.derive_scalars(cfg, 10.0, 0.25).coef
    return planes, table, cand, old, coef, cfg.S


# the kernel stages each cell's candidates in shared memory and walks a
# thread's rows per slot: cells with no candidate, 4 and 48 slots, K=6000
# (S=12, 8 cells a block), W=1277 and a view off the 16-byte boundary
# (unaligned rows), S=21 (6 cells a block), S=67 (one cell a block; the
# Euclidean spatial term computed in the loop, its table too large), S=151
# (a cell wider than a block: threads take two columns), duplicate centres
# (ties), and three stacked frames
ASSIGN_CASES = ["inactive_patch", "slots_4", "slots_48", "k6000", "w1277",
                "offset", "s21", "s67", "s151", "duplicates", "frames_3"]


@pytest.mark.parametrize("manhattan", [True, False])
@pytest.mark.parametrize("stride,rem", [(3, 0), (3, 1), (3, 2), (1, 0)])
@pytest.mark.parametrize("case", ASSIGN_CASES)
def test_assign_kernel_cases(cuda, rng, case, stride, rem, manhattan):
    planes, table, cand, old, coef, S = _assign_case(rng, cuda, case,
                                                     manhattan)
    outs = []
    for fn in (assign.assign, assign.plain):
        a = old.clone()
        md = torch.full_like(a, -7)
        fn(planes, table, cand, a, coef, S, stride, rem, manhattan,
           min_dists=md)
        outs.append((a, md))
    _eq(outs[0][0], outs[1][0])
    _eq(outs[0][1], outs[1][1])
    if case == "inactive_patch":
        # nothing won there: the old value stays, min_dists reads 0xFFFF
        none = outs[0][1] == UNASSIGNED
        assert bool(none.any())
        _eq(outs[0][0][none], old[none])


FLOAT_VARIANTS = [("real", True), ("real", False), ("real_l2", True),
                  ("real_noq", True), ("real_noq", False), ("lsc", True)]


# the float assign stages each cell's candidate records in shared memory
# and walks a thread's rows per slot: the quantized assign's cases, and
# real_noq's window edges
@pytest.mark.parametrize("variant,manhattan", FLOAT_VARIANTS)
@pytest.mark.parametrize("stride,rem", [(3, 0), (3, 1), (3, 2), (1, 0)])
@pytest.mark.parametrize("case", ASSIGN_CASES + ["noq_edges"])
def test_assign_float_kernel_cases(cuda, rng, case, stride, rem, variant,
                                   manhattan):
    planes, table, cand, old, coef, S = _assign_case(rng, cuda, case,
                                                     manhattan, variant)
    feats = torch.from_numpy(rng.random((10,) + tuple(old.shape),
                                        np.float32)).to(cuda)
    cent = torch.from_numpy(rng.random(tuple(table.shape[:-1]) + (10,),
                                       np.float32)).to(cuda)
    if case == "offset":
        feats = _offset(feats)
    outs = []
    for fn in (assign_float.assign_float, assign_float.plain):
        a = old.clone()
        md = torch.full(a.shape, -1.0, device=cuda)
        fn(planes, table, cand, a, coef, S, stride, rem, variant, manhattan,
           md, feats, cent)
        outs.append((a, md))
    _eq(outs[0][0], outs[1][0])
    _eq(outs[0][1], outs[1][1])
    if case == "inactive_patch":
        # nothing won there: the old value stays, min_dists reads FLT_MAX
        none = outs[0][1] == assign_float.F32_MAX
        assert bool(none.any())
        _eq(outs[0][0][none], old[none])


def test_segment_sum_kernel_cca_720p(cuda, rng):
    # the CCA's own call: component ids of a 720p superpixel map, a plane of
    # ones and one of leader targets
    raw = torch.from_numpy(_superpixels(rng, 1, 720, 1280)[0][0]).to(cuda)
    L = cca.connected_components(raw).reshape(-1)
    is_leader, rank, _ = leader_ranks(L)
    comp2 = cca.lookup(L, rank).reshape(raw.shape)
    vals = segsum_values(comp2, is_leader).contiguous()
    ids = comp2.reshape(-1)
    _eq(segsum.segment_sum(ids, vals, ids.numel()),
        segsum.segment_sum_plain(ids, vals, ids.numel()))


def _runs(rng, N):
    """Ids in runs of 1-47 equal ids, rising, as component ids lie."""
    return np.repeat(np.arange(N), rng.integers(1, 48, N))[:N]


# the kernel sums a lane's runs of equal ids, then a block's in a shared
# table: runs, one id over all pixels, random ids over more bins than the
# table holds (device atomics), ids outside [0, bins) (dropped), sums that
# wrap int32, a length that is not a multiple of 4 and views off the
# 16-byte boundary (the scalar loads)
SEGSUM_CASES = ["runs", "one_id", "random", "outside", "wrap", "ragged",
                "offset"]


@pytest.mark.parametrize("V", [1, 2, 3, 5])
@pytest.mark.parametrize("case", SEGSUM_CASES)
def test_segment_sum_kernel_cases(cuda, rng, case, V):
    N, S = (100003 if case == "ragged" else 100000), 30000
    if case == "one_id":
        ids = np.full(N, 7)
    elif case == "random":
        ids = rng.integers(0, S + 1, N)
    elif case == "outside":
        ids = rng.integers(-50, S + 50, N)
    else:
        ids = _runs(rng, N)
    vals = rng.integers(0, 1 << 20, size=(V, N))
    if case == "wrap":
        vals = rng.integers(-(1 << 31), 1 << 31, size=(V, N))
    ids = torch.from_numpy(ids.astype(np.int32)).to(cuda)
    vals = torch.from_numpy(vals.astype(np.int32)).to(cuda)
    if case == "offset":
        ids, vals = _offset(ids), _offset(vals)
        assert ids.data_ptr() % 16 == 4 and vals.data_ptr() % 16 == 4
    # the plain version takes ids in [0, S]; the kernel drops the others
    keep = (ids >= 0) & (ids <= S)
    _eq(segsum.segment_sum(ids, vals, S),
        segsum.segment_sum_plain(ids[keep].contiguous(),
                                 vals[:, keep].contiguous(), S))


def _stacked_720p_cca(dev):
    """The stacked batch's CCA call on the four frames of chip_smoke.py's
    first batch: ids [4, n] frame-local component ids of SlicAvx2's raw
    assignments at 720p, K=1600, and vals [2, 4, n] (area ones, leader
    targets), as ops.cca.framed_cca_parts makes them."""
    sys.path.insert(0, ROOT)
    from chip_smoke import BATCH, H720, K720, W720, make_frames
    from fast_slic_tpu_torch.ops.cca import framed_components
    cfg = StaticConfig(H=H720, W=W720, K=K720)
    scal = pipeline.derive_scalars(cfg, 10.0, 0.25)
    raw = torch.stack([pipeline.iterate_graph(
        torch.from_numpy(f).to(dev),
        tcl.initialize_clusters(f, K720).to_torch(dev), cfg, scal, 10,
        3).raw_assignment for f in make_frames(2 * BATCH, H720, W720,
                                               seed=1)[:BATCH]])
    comp, is_leader = framed_components(raw, K720)
    vals = segsum_values(comp, is_leader).contiguous()
    return comp.reshape(BATCH, -1), vals


# the frame axis of the segment sum's kernel: each SEGSUM_CASES layout in
# every frame, one and three frames; "sorted" rising ids over four frames,
# some past the bins; the CCA call of a stacked batch of four 720p frames
FRAMED_CASES = ([("sorted", 2, 4)]
                + [(c, V, B) for c in SEGSUM_CASES for V in (1, 2, 3)
                   for B in (1, 3)]
                + [("cca_720p", 2, 4)])


@pytest.mark.parametrize("case,V,B", FRAMED_CASES)
def test_framed_segment_sum_kernel_matches_plain(cuda, rng, case, V, B):
    if case == "cca_720p":
        ids, vals = _stacked_720p_cca(cuda)
        MF = ids.shape[1]
    else:
        Nf, MF = (100003 if case == "ragged" else 100000), 30000
        if case == "sorted":
            Nf, MF = 30011, 5000
            ids = np.sort(rng.integers(0, MF + 3, size=(B, Nf)), 1)
        elif case == "one_id":
            ids = np.full((B, Nf), 7)
        elif case == "random":
            ids = rng.integers(0, MF, (B, Nf))
        elif case == "outside":
            ids = rng.integers(-50, MF + 50, (B, Nf))
        else:
            ids = np.stack([_runs(rng, Nf) for _ in range(B)])
        vals = rng.integers(0, 1 << 20, size=(V, B, Nf))
        if case == "wrap":
            vals = rng.integers(-(1 << 31), 1 << 31, size=(V, B, Nf))
        ids = torch.from_numpy(ids.astype(np.int32)).to(cuda)
        vals = torch.from_numpy(vals.astype(np.int32)).to(cuda)
        if case == "offset":
            ids, vals = _offset(ids), _offset(vals)
            assert ids.data_ptr() % 16 == 4 and vals.data_ptr() % 16 == 4
    # the plain version drops ids outside [0, MF) itself, as the kernel does
    _eq(segsum.framed_segment_sum(ids, vals, MF),
        segsum.framed_segment_sum_plain(ids, vals, MF))


@pytest.mark.parametrize("variant", ["standard", "real", "real_l2",
                                     "real_noq"])
@pytest.mark.parametrize("stride,rem", [(3, 1), (1, 0)])
def test_frame_axis_kernels_match_plain(cuda, rng, variant, stride, rem):
    B, H, W, K = 3, 123, 217, 57
    cfg = StaticConfig(H=H, W=W, K=K, variant=variant)
    scal = pipeline.derive_scalars(cfg, 10.0, 0.25)
    frames = rng.integers(0, 256, size=(B, H, W, 3)).astype(np.uint8)
    sts = [tcl.initialize_clusters(f, K) for f in frames]
    st = tcl.clusters_from_numpy(*(np.stack(xs) for xs in zip(
        *(s.fields() for s in sts)))).to_torch(cuda)
    st = st.replace(y=st.y + 0.37, x=st.x + 0.61)
    planes, st, _ = pipeline.stage_setup(torch.from_numpy(frames).to(cuda),
                                         st, cfg, scal)
    cand, _ = pipeline.build_candidates_batched(st.y, st.x, st.is_active, cfg)
    table = pipeline.center_table(st)
    old = torch.from_numpy(rng.integers(0, K, size=(B, H, W)).astype(
        np.int32)).to(cuda)
    outs = []
    for kern in (True, False):
        a = old.clone()
        if variant == "standard":
            md = torch.zeros((B, H, W), dtype=torch.int32, device=cuda)
            (assign.assign if kern else assign.plain)(
                planes, table, cand, a, scal.coef, cfg.S, stride, rem, True,
                md)
        else:
            md = torch.zeros((B, H, W), device=cuda)
            (assign_float.assign_float if kern else assign_float.plain)(
                planes, table, cand, a, scal.coef, cfg.S, stride, rem,
                variant, True, md)
        outs.append((a, md))
    _eq(outs[0][0], outs[1][0])
    _eq(outs[0][1], outs[1][1])
    a = outs[0][0]
    _eq(segsum.slic_update(a, planes, K, stride, rem),
        segsum.slic_update_plain(a, planes, K, stride, rem))


def _frames(rng, n, H=200, W=300):
    return np.stack([rng.integers(0, 256, size=(H // 10, W // 10, 3)).repeat(
        10, 0).repeat(10, 1).astype(np.uint8) for _ in range(n)])


@pytest.mark.parametrize("cls", [SlicAvx2, SlicRealDist])
def test_preemptive_on_gpu_matches_cpu(cuda, rng, cls):
    frames = _frames(rng, 2)
    kw = dict(num_components=150, preemptive=True, preemptive_thres=0.2)
    gpu, cpu = cls(device=cuda, **kw), cls(device="cpu", **kw)
    for f in frames:
        np.testing.assert_array_equal(gpu.iterate(f), cpu.iterate(f))
        np.testing.assert_array_equal(gpu.slic_model.to_yxmrgb(),
                                      cpu.slic_model.to_yxmrgb())


def test_lsc_preemptive_on_gpu_matches_cpu(cuda, rng):
    frame = _frames(rng, 1)[0]
    kw = dict(num_components=150, preemptive=True, preemptive_thres=0.2)
    gpu, cpu = LSCAvx2(device=cuda, **kw), LSCAvx2(device="cpu", **kw)
    agree = float((gpu.iterate(frame) == cpu.iterate(frame)).mean())
    assert agree >= 0.999, agree


@pytest.mark.parametrize("mode,variant,preemptive", [
    ("stack", "standard", False), ("stack", "standard", True),
    ("stack", "real_noq", False), ("map", "standard", False)])
def test_batched_on_gpu_matches_cpu(cuda, rng, mode, variant, preemptive):
    batches = [_frames(rng, 3) for _ in range(2)]
    kw = dict(num_components=150, variant=variant, preemptive=preemptive,
              batch_mode=mode)
    gpu, cpu = BatchedSlic(device=cuda, **kw), BatchedSlic(device="cpu", **kw)
    for frames in batches:
        _eq(gpu.iterate(frames), cpu.iterate(frames))
    for f in ("y", "x", "r", "g", "b", "num_members", "is_updatable"):
        np.testing.assert_array_equal(getattr(gpu.state, f),
                                      getattr(cpu.state, f), err_msg=f)


def test_preempt_golden_on_gpu(cuda):
    g = np.load(DATA)
    image = g["image"]
    H, W = image.shape[:2]
    params = RuntimeParams(compactness=10.0, min_size_factor=0.1,
                           subsample_stride=3, max_iter=10,
                           preemptive_thres=0.05)
    res = runner.run_iterate(StaticConfig(H=H, W=W, K=256, preemptive=True),
                             image, tcl.initialize_clusters(image, 256),
                             params, cuda)
    np.testing.assert_array_equal(res.labels, g["std_k256_preempt"])


def _centres(rng, K, H, W, edge):
    """Random float32 centres; ``edge`` puts a fifth of them on the image's
    edges (and one past them, whose cell the bucketing clamps), and pairs
    of identical centres (distance-0 ties, ordered by cluster number)."""
    y = rng.uniform(0, H, K).astype(np.float32)
    x = rng.uniform(0, W, K).astype(np.float32)
    if edge:
        n = K // 20
        y[:n], x[n:2 * n] = H - 1, W - 1
        y[2 * n:3 * n], x[3 * n:4 * n] = 0, 0
        y[4 * n], x[4 * n] = H + 2.5, W + 1.75
        y[4 * n + 1::7], x[4 * n + 1::7] = y[4 * n], x[4 * n]
        y[10:20], x[10:20] = y[20:30], x[20:30]
    return torch.from_numpy(y), torch.from_numpy(x)


@pytest.mark.parametrize("m", [1, 4, 8, 60])
@pytest.mark.parametrize("K,H,W,edge", [(300, 240, 320, False),
                                        (300, 240, 320, True),
                                        (1600, 720, 1280, True),
                                        (7, 33, 17, True), (1, 10, 10, False)])
def test_knn_kernel_matches_plain(cuda, rng, K, H, W, edge, m):
    """m = 60 is more than a 6x6-cell window holds, so every list is its
    window's population less the early skip's drops."""
    from fast_slic_tpu_torch.kernels import knn
    ys, xs = _centres(rng, K, H, W, edge)
    want = knn.knn_plain(ys, xs, H, W, m)
    got = knn.knn(ys.to(cuda), xs.to(cuda), H, W, m)
    _eq(got[0], want[0])
    _eq(got[1], want[1])


def test_knn_kernel_720p_fixture(cuda):
    from fast_slic_tpu_torch.kernels import knn
    ref = np.load(os.path.join(ROOT, "tests", "data", "port_crf_ref.npz"))
    clusters = np.load(os.path.join(ROOT, "tests", "data",
                                    "port_720p_ref.npz"))["slice_clusters"]
    for t, yxm in enumerate(clusters):
        ys = torch.from_numpy(np.ascontiguousarray(yxm[:, 0])).to(cuda)
        xs = torch.from_numpy(np.ascontiguousarray(yxm[:, 1])).to(cuda)
        nbr, counts = knn.knn(ys, xs, 720, 1280, 4)
        np.testing.assert_array_equal(nbr.cpu().numpy(), ref["knn_nbr"][t])
        np.testing.assert_array_equal(counts.cpu().numpy(),
                                      ref["knn_lens"][t])


def _fixture_centres(dev, t=0):
    yxm = np.load(os.path.join(ROOT, "tests", "data",
                               "port_720p_ref.npz"))["slice_clusters"][t]
    return (torch.from_numpy(np.ascontiguousarray(yxm[:, 0])).to(dev),
            torch.from_numpy(np.ascontiguousarray(yxm[:, 1])).to(dev))


@pytest.mark.parametrize("case", ["random", "edges", "identical", "720p",
                                  "ranges", "tiny"])
def test_knn_buckets_kernel_matches_plain(cuda, rng, monkeypatch, case):
    """The bucketing kernel against its plain version on the CPU and on
    the card; "ranges" takes the count table in ranges of 37 cells and the
    clusters 64 at a time (the path of a grid past the table's size)."""
    from fast_slic_tpu_torch.kernels import knn
    H, W = 240, 320
    if case == "720p":
        H, W = 720, 1280
        ys, xs = _fixture_centres("cpu")
    elif case == "tiny":
        H, W = 10, 10
        ys, xs = _centres(rng, 1, H, W, False)
    else:
        ys, xs = _centres(rng, 2000, H, W, case != "random")
    if case == "identical":
        groups = torch.from_numpy(rng.integers(0, 5, ys.shape[0]))
        ys, xs = ys[groups].contiguous(), xs[groups].contiguous()
    if case == "ranges":
        monkeypatch.setattr(knn, "BUCKET_RANGE", 37)
        monkeypatch.setattr(knn, "BUCKET_TILE", 64)
    want = knn.knn_buckets_plain(ys, xs, H, W)
    before = launch_counts()["knn_buckets"]
    got = knn.knn_buckets(ys.to(cuda), xs.to(cuda), H, W)
    assert launch_counts()["knn_buckets"] == before + 1
    for g, w, p in zip(got, want, knn.knn_buckets_plain(ys.to(cuda),
                                                        xs.to(cuda), H, W)):
        _eq(g, w)
        _eq(p, w)


def test_knn_kernel_heap_in_device_memory(cuda, rng):
    """m past what one warp's heap can hold in shared memory (cap > 29,056
    pairs), with 300 identical centres: the heaps live in the device
    scratch.  No list reaches 1000, so no heap ever popped and the plain
    version at m=1000 gives the same lists."""
    from fast_slic_tpu_torch.kernels import knn
    K, H, W, m = 30000, 1080, 1920, 30000
    assert 8 * (min(m, K - 1) + 1) > knn.SMEM_MAX
    ys, xs = _centres(rng, K, H, W, False)
    ys[100:400], xs[100:400] = ys[50], xs[50]
    want_nbr, want_counts = knn.knn_plain(ys, xs, H, W, 1000)
    assert int(want_counts.max()) < 1000
    nbr, counts = knn.knn(ys.to(cuda), xs.to(cuda), H, W, m)
    _eq(counts, want_counts)
    _eq(nbr[:, :1000], want_nbr)
    assert bool((nbr[:, 1000:] == -1).all())


def test_knn_kernel_large_k_1080p(cuda, rng):
    """K=60,000 at 1920x1080: 82,944 cells, past the bucketing's shared
    table, so it counts and places in two ranges of cells."""
    from fast_slic_tpu_torch.kernels import knn
    K, H, W = 60000, 1080, 1920
    S, nh, nw = knn.grid(H, W, K)
    assert nh * nw > knn.BUCKET_RANGE
    ys, xs = _centres(rng, K, H, W, False)
    # some on the edges, some past them (clamped cells)
    ys[:50], xs[50:100], ys[100:150], xs[150:200] = H - 1, W - 1, 0, 0
    ys[200:210], xs[200:210] = H + 2.5, W + 1.75
    for g, w in zip(knn.knn_buckets(ys.to(cuda), xs.to(cuda), H, W),
                    knn.knn_buckets_plain(ys, xs, H, W)):
        _eq(g, w)
    got = knn.knn(ys.to(cuda), xs.to(cuda), H, W, 4)
    want = knn.knn_plain(ys, xs, H, W, 4)
    _eq(got[0], want[0])
    _eq(got[1], want[1])


def test_knn_call_makes_two_launches(cuda):
    """One knn call on the card is two device launches, the bucketing and
    the walk (no sort, scan or fill beside them)."""
    from torch.profiler import ProfilerActivity, profile
    from fast_slic_tpu_torch.kernels import knn
    ys, xs = _fixture_centres(cuda)
    knn.knn(ys, xs, 720, 1280, 4)
    torch.cuda.synchronize()
    before = (launch_counts()["knn"], launch_counts()["knn_buckets"])
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        knn.knn(ys, xs, 720, 1280, 4)
        torch.cuda.synchronize()
    device = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    assert sum(e.count for e in device) == 2, [e.key for e in device]
    assert any("knn_buckets_kernel" in e.key for e in device)
    assert any("knn_kernel" in e.key for e in device)
    assert (launch_counts()["knn"], launch_counts()["knn_buckets"]) == (
        before[0] + 1, before[1] + 1)


def _label_maps(rng):
    base = rng.integers(0, 200, size=(13, 13))
    blocks = np.kron(base, np.ones((5, 5), np.int64))[:64, :61]
    hot = np.full((12, 12), 17, np.int64)
    ring = [(r, c) for r in range(2, 10) for c in range(2, 10)
            if r in (2, 9) or c in (2, 9)]
    for i, (r, c) in enumerate(ring):
        hot[r, c] = 1 + i * 16 // len(ring)
    hot[3:9, 3:9] = 0
    noisy = rng.integers(-1, 41, size=(50, 33))
    labels = np.load(os.path.join(ROOT, "tests", "data",
                                  "port_720p_ref.npz"))["slice_labels"][1]
    return [(blocks, 200), (hot, 18), (noisy, 40), (labels, 1600)]


def test_graph_on_gpu_matches_cpu(cuda, rng):
    """Adjacency (random blocks, a hot node past the 12-neighbour cap,
    labels outside [0, K), a 720p frame) and densities on the card equal
    the CPU's."""
    from fast_slic_tpu_torch.ops import graph
    for lab, K in _label_maps(rng):
        for want, got in zip(graph.adjacency_matrix(lab, K, "cpu"),
                             graph.adjacency_matrix(lab, K, cuda)):
            np.testing.assert_array_equal(got, want)
        st = tcl.zeros(K)
        st.num_members[:] = rng.integers(0, 50, K)
        mask = rng.integers(0, 256, size=lab.shape, dtype=np.uint8)
        dens = graph.mask_density(mask, lab, st, "cpu")
        np.testing.assert_array_equal(
            graph.mask_density(torch.from_numpy(mask).to(cuda), lab, st,
                               cuda), dens)
        np.testing.assert_array_equal(
            graph.density_to_mask(dens, lab, K, cuda),
            graph.density_to_mask(dens, lab, K, "cpu"))


def test_graph_ops_default_to_the_card(cuda, rng):
    """With no device named, numpy input goes to the card (the KNN launches
    its kernel), and tensors on the card stay there."""
    from fast_slic_tpu_torch.kernels import knn
    from fast_slic_tpu_torch.ops import graph
    lab, K = _label_maps(rng)[0]
    st = tcl.zeros(K)
    st.y[:] = rng.uniform(0, lab.shape[0], K)
    st.x[:] = rng.uniform(0, lab.shape[1], K)
    st.num_members[:] = rng.integers(0, 50, K)
    before = launch_counts()["knn"]
    for got, want in ((graph.knn(st, 4, lab.shape),
                       graph.knn(st, 4, lab.shape, "cpu")),
                      (graph.knn(st.to_torch(cuda), 4, lab.shape),
                       graph.knn(st, 4, lab.shape, "cpu")),
                      (graph.adjacency_matrix(lab, K),
                       graph.adjacency_matrix(lab, K, "cpu"))):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert launch_counts()["knn"] == before + 2
    mask = rng.integers(0, 256, size=lab.shape, dtype=np.uint8)
    np.testing.assert_array_equal(
        graph.mask_density(torch.from_numpy(mask).to(cuda),
                           torch.from_numpy(lab).to(cuda), st),
        graph.mask_density(mask, lab, st, "cpu"))
    with pytest.raises(ValueError, match="requested"):
        graph.adjacency_matrix(torch.from_numpy(lab).to(cuda), K, "cpu")


@pytest.mark.parametrize("graph_kind", ["adjacency", "knn"])
def test_crf_on_gpu_matches_cpu(cuda, graph_kind):
    """SimpleCRF on the card against the CPU and the JAX package's
    posteriors at 720p (four frames, N=1600, C=21, inference(5)): within
    rtol 2e-4, atol 1e-6, argmax >= 0.999."""
    from fast_slic_tpu_torch import SimpleCRF, SlicModel
    data = os.path.join(ROOT, "tests", "data")
    ref = np.load(os.path.join(data, "port_720p_ref.npz"))
    want = np.load(os.path.join(data, "port_crf_ref.npz"))[
        "q_adj" if graph_kind == "adjacency" else "q_knn"]
    outs = []
    for dev in (cuda, "cpu"):
        crf = SimpleCRF(21, 1600, device=dev)
        for t, (labels, yxm) in enumerate(zip(ref["slice_labels"],
                                              ref["slice_clusters"])):
            st = tcl.zeros(1600)
            st.y[:], st.x[:] = yxm[:, 0], yxm[:, 1]
            st.num_members[:] = yxm[:, 2].astype(np.uint32)
            st.r[:], st.g[:], st.b[:] = yxm[:, 3], yxm[:, 4], yxm[:, 5]
            model = SlicModel(1600, device=dev)
            model._clusters, model.initialized = st, True
            slic = type("SlicResult", (), {"slic_model": model,
                                           "last_assignment": labels})
            frame = crf.push_slic_frame(
                slic, knn=4 if graph_kind == "knn" else None)
            frame.set_proba(np.random.default_rng(t).dirichlet(
                np.ones(21), 1600).T.astype(np.float32))
        crf.initialize()
        crf.inference(5)
        stack = crf.inferred_stack()
        assert stack.device.type == torch.device(dev).type
        outs.append(stack.cpu().numpy())
    for got in outs:
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-6)
        assert (got.argmax(1) == want.argmax(1)).mean() >= 0.999
    np.testing.assert_allclose(outs[0], outs[1], rtol=2e-4, atol=1e-6)


def test_crf_window_report_counts_its_transfers(cuda):
    """A sliding-window call on the card (``SlicAvx2``, the KNN push, a pop
    past four frames, ``inference(5)``, the newest posteriors, their
    classes broadcast): the counters see the cycle's transfers, the
    centres and the window up, the lists and the posteriors down, and the
    CRF's report those inside the inference (the window's staging)."""
    import json

    from fast_slic_tpu_torch import SimpleCRF
    from fast_slic_tpu_torch.utils.timing import COUNTS, REPORTED
    K, C, m = 64, 21, 4
    img = np.random.default_rng(5).integers(0, 256, (96, 128, 3),
                                            dtype=np.uint8)
    slic = SlicAvx2(num_components=K, device=cuda)
    crf = SimpleCRF(C, K, device=cuda)
    for t in range(6):
        labels = slic.iterate(np.roll(img, 4 * t, axis=1))
        before = {k: COUNTS[k] for k in REPORTED}
        fr = crf.push_slic_frame(slic, knn=m)
        fr.set_proba(np.random.default_rng(t).dirichlet(
            np.ones(C), K).T.astype(np.float32))
        if crf.num_frames > 4:
            crf.pop_frame()
        crf.initialize()
        crf.inference(5)
        cls = fr.get_inferred().argmax(0).astype(np.uint8)
        moved = {k: COUNTS[k] - before[k] for k in REPORTED}
        slic.slic_model.broadcast_density_to_mask(cls, labels)
        rep = json.loads(crf.last_timing_report)
        T = crf.num_frames
        D = max(crf.get_frame(i)._nbr.shape[1]
                for i in range(crf.first_time, crf.last_time + 1))
        staged = 4 * T * K * (D + 6 + C) + 28 + (4 * C if t == 0 else 0)
        assert [c["name"] for c in rep["children"]] == [
            "crf_stage", "crf_energies", "crf_meanfield"]
        assert rep["counters"] == {"host_syncs": 4 + (t == 0),
                                   "h2d_bytes": staged, "d2h_bytes": 0}, t
        assert moved == {
            "host_syncs": 8 + (t == 0), "h2d_bytes": 8 * K + staged,
            "d2h_bytes": 4 * (K * m + K) + 4 * T * C * K}, t
        assert rep["duration"] >= sum(c["duration"] for c in rep["children"])


@pytest.mark.parametrize("shape", [(4, 21, 1600), (1, 3, 7), (3, 64, 33)])
def test_crf_class_sum_on_gpu_adds_in_class_order(cuda, rng, shape):
    """The CRF's class sum (one cumsum on the card) equals adding the
    classes one by one, bit for bit, as the CPU does."""
    from fast_slic_tpu_torch.models.crf import _class_sum
    a = torch.from_numpy((rng.random(shape) * rng.choice([1e-6, 1.0, 37.3],
                                                         shape))
                         .astype(np.float32))
    want = a[:, :1].clone()
    for c in range(1, shape[1]):
        want = want + a[:, c:c + 1]
    _eq(_class_sum(a.to(cuda)), want)
    _eq(_class_sum(a), want)


# short images: the rows i % stride == rem lie past the image when
# rem >= H; (H, stride, rem)
SHORT_ROWS = [(1, 3, 1), (1, 3, 2), (4, 7, 4), (4, 7, 6), (2, 3, 1),
              (1, 3, 0)]


@pytest.mark.parametrize("kernel", ["assign", "real", "lsc", "slic_update",
                                    "slic_update_masked"])
@pytest.mark.parametrize("H,stride,rem", SHORT_ROWS)
def test_short_rows_kernels_match_plain(cuda, rng, kernel, H, stride, rem):
    """At rem >= H the launcher skips: the assignment and min_dists stay as
    they were and the update's sums are all zero, as in the plain
    version; at H < stride with rem < H one row is processed."""
    W, K = 61, 5
    _, st, planes = _state(rng, cuda, H, W, K)
    old = torch.from_numpy(rng.integers(0, K, size=(H, W)).astype(
        np.int32)).to(cuda)
    if kernel.startswith("slic_update"):
        mask = torch.from_numpy(rng.random((H, W)) < 0.7).to(cuda)
        if kernel == "slic_update":
            got = segsum.slic_update(old, planes, K, stride, rem)
            want = segsum.slic_update_plain(old, planes, K, stride, rem)
        else:
            got = segsum.slic_update_masked(old, planes, mask, K, stride, rem)
            want = segsum.slic_update_masked_plain(old, planes, mask, K,
                                                   stride, rem)
        _eq(got, want)
        assert bool((got == 0).all()) == (rem >= H)
        return
    variant = "standard" if kernel == "assign" else kernel
    cfg = StaticConfig(H=H, W=W, K=K, variant=variant)
    coef = pipeline.derive_scalars(cfg, 10.0, 0.25).coef
    cand, _ = pipeline.build_candidates(st.y, st.x, st.is_active, cfg)
    table = pipeline.center_table(st)
    feats = torch.from_numpy(rng.random((10, H, W), np.float32)).to(cuda)
    cent = torch.from_numpy(rng.random((K, 10), np.float32)).to(cuda)
    outs = []
    for on_card in (True, False):
        a = old.clone()
        if kernel == "assign":
            md = torch.full_like(a, UNASSIGNED)
            fn = assign.assign if on_card else assign.plain
            fn(planes, table, cand, a, coef, cfg.S, stride, rem,
               min_dists=md)
        else:
            md = torch.full((H, W), -1.0, device=cuda)
            fn = assign_float.assign_float if on_card else assign_float.plain
            fn(planes, table, cand, a, coef, cfg.S, stride, rem, variant,
               True, md, feats, cent)
        outs.append((a, md))
    _eq(outs[0][0], outs[1][0])
    _eq(outs[0][1], outs[1][1])
    if rem >= H:
        _eq(outs[0][0], old)
        assert bool((outs[0][1] == outs[0][1].flatten()[0]).all())


@pytest.mark.parametrize("shape,stride", [((1, 50), 3), ((4, 60), 7)])
@pytest.mark.parametrize("cls", [SlicAvx2, SlicRealDist, LSCAvx2])
def test_short_images_on_gpu_match_cpu(cuda, rng, cls, shape, stride):
    image = rng.integers(0, 256, size=shape + (3,)).astype(np.uint8)
    kw = dict(num_components=4, subsample_stride=stride)
    gpu, cpu = cls(device=cuda, **kw), cls(device="cpu", **kw)
    np.testing.assert_array_equal(gpu.iterate(image, max_iter=7),
                                  cpu.iterate(image, max_iter=7))


@pytest.mark.parametrize("cls,kw", [(SlicAvx2, {}), (SlicRealDist, {}),
                                    (LSCAvx2, {}),
                                    (SlicAvx2, {"preemptive": True})])
def test_debug_snapshots_on_gpu_match_cpu(cuda, rng, cls, kw):
    """debug_mode on the card: every snapshot's assignment, min_dists and
    clusters equal the plain path's (LSC: assignments >= 0.999, the rest
    within rtol 1e-5), and the labels equal the default run's."""
    frame = _frames(rng, 1)[0]
    kw = dict(num_components=150, **kw)
    runs = {}
    for dev in (cuda, "cpu"):
        slic = cls(device=dev, debug_mode=True, **kw)
        runs[str(dev)] = (slic.iterate(frame, max_iter=4),
                          slic.slic_model.last_recorder_snapshots)
    ref = cls(device=cuda, **kw).iterate(frame, max_iter=4)
    (lg, sg), (lc, sc) = runs[str(cuda)], runs["cpu"]
    np.testing.assert_array_equal(lg, ref)
    assert sg.iterations == sc.iterations == [-1, 0, 1, 2, 3]
    lsc = cls is LSCAvx2
    if lsc:
        agree = (sg.assignments == sc.assignments).mean(axis=(1, 2))
        assert (agree >= 0.999).all(), agree
        np.testing.assert_allclose(sg.min_dists, sc.min_dists, rtol=1e-5,
                                   atol=1e-6)
    else:
        np.testing.assert_array_equal(lg, lc)
        np.testing.assert_array_equal(sg.assignments, sc.assignments)
        np.testing.assert_array_equal(sg.min_dists, sc.min_dists)
    for a, b in zip(sg.clusters, sc.clusters):
        for f, x, y in zip(("y", "x", "r", "g", "b", "num_members",
                            "is_active", "is_updatable"),
                           a.fields(), b.fields()):
            if lsc:
                np.testing.assert_allclose(x.astype(np.float64),
                                           y.astype(np.float64), rtol=1e-5,
                                           err_msg=f)
            else:
                np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.mark.parametrize("cls", [SlicAvx2, LSCAvx2])
def test_profile_on_gpu(cuda, rng, cls):
    import json
    frame = _frames(rng, 1)[0]
    ref = cls(num_components=150, device=cuda).iterate(frame, max_iter=4)
    slic = cls(num_components=150, device=cuda)
    slic.slic_model.profile = True
    np.testing.assert_array_equal(slic.iterate(frame, max_iter=4), ref)
    rep = json.loads(slic.slic_model.last_timing_report)
    exe = [c for c in rep["children"] if c["name"] == "execute"][0]
    names = [c["name"] for c in exe["children"]]
    assert names.count("assign") == names.count("update") == 4
    assert names.count("after_update") == (4 if cls is LSCAvx2 else 0)
    assert all(isinstance(c["duration"], int) for c in exe["children"])


def _tied_map():
    blocks = np.random.default_rng(1).integers(0, 4, size=(6, 8))
    return np.kron(blocks, np.ones((4, 4))).astype(np.uint16), 0


@pytest.mark.parametrize("case", ["random", "unassigned", "tied",
                                  "superpixels_720p"])
def test_enforce_connectivity_on_gpu_matches_cpu(cuda, rng, case):
    from fast_slic_tpu_torch import enforce_connectivity
    from fast_slic_tpu_torch.ops.cca import enforce_connectivity_flagged
    if case == "tied":
        labels, thres = _tied_map()
        _, tie = enforce_connectivity_flagged(
            torch.from_numpy(labels.astype(np.int32)).to(cuda), 4, thres)
        assert bool(tie)
    elif case == "superpixels_720p":
        a, _ = _superpixels(rng, 1, 720, 1280)
        labels, thres = a[0].astype(np.int16), 144   # 0xFFFF reads -1
    else:
        labels = rng.integers(0, 6, size=(97, 131)).astype(np.int16)
        if case == "unassigned":
            labels[labels == 5] = -1
        thres = 3
    got = enforce_connectivity(labels.copy(), thres)
    want = enforce_connectivity(labels.copy(), thres, device="cpu")
    assert got.dtype == labels.dtype
    np.testing.assert_array_equal(got, want)


# the region minimum of any seed: the sharded CCA's seeds (pixel ids, leader
# ranks, a seed that is _BIG except at leaders) on real-like maps, over the
# kernel's roots against the plain version's
REGION_MIN_CASES = ["random_ids", "serpentine_ranks", "superpixels_sparse",
                    "row_1x1000", "col_1000x1", "unassigned_big"]


def _region_min_case(rng, case):
    """(labels int32 [H, W], seed int32 [H * W])."""
    big = 0x7FFFFFFF
    if case == "random_ids":
        labels = rng.integers(0, 5, size=(301, 517))
    elif case == "serpentine_ranks":
        labels = _spiral(720, 1280)
    elif case in ("superpixels_sparse", "unassigned_big"):
        labels = _superpixels(rng, 1, 720, 1280)[0][0]
    else:
        shape = {"row_1x1000": (1, 1000), "col_1000x1": (1000, 1)}[case]
        labels = rng.integers(0, 2, size=shape)
    labels = np.ascontiguousarray(labels, np.int32)
    n = labels.size
    if case == "serpentine_ranks":
        m0 = rng.permutation(n).astype(np.int32)
    elif case in ("superpixels_sparse", "unassigned_big"):
        m0 = np.full(n, big, np.int32)
        keep = rng.random(n) < (0.001 if case == "superpixels_sparse"
                                else 0.0)
        m0[keep] = rng.integers(0, 1 << 30, size=int(keep.sum()))
    else:
        m0 = np.arange(n, dtype=np.int32)
    return labels, m0


@pytest.mark.parametrize("case", REGION_MIN_CASES)
def test_propagate_min_kernel_matches_plain(cuda, rng, case):
    labels, m0 = _region_min_case(rng, case)
    lab_t = torch.from_numpy(labels).to(cuda)
    m0_t = torch.from_numpy(m0.reshape(labels.shape)).to(cuda)
    roots = cca.connected_components(lab_t)
    before = launch_counts()["propagate_min"]
    got = cca.propagate_min(m0_t, roots)
    assert launch_counts()["propagate_min"] == before + 1
    _eq(got, cca.propagate_min_plain(
        m0_t, cca.connected_components_plain(lab_t)))


@pytest.mark.parametrize("case", REGION_MIN_CASES)
def test_region_table_kernel_matches_plain(cuda, rng, case):
    labels, m0 = _region_min_case(rng, case)
    lab_t = torch.from_numpy(labels).to(cuda)
    m0_t = torch.from_numpy(m0.reshape(labels.shape)).to(cuda)
    roots = cca.connected_components(lab_t)
    before = launch_counts()["region_table"]
    got = cca.region_table(m0_t, roots)
    assert launch_counts()["region_table"] == before + 1
    _eq(got, cca.region_table_plain(
        m0_t, cca.connected_components_plain(lab_t)))


@pytest.mark.parametrize("case", REGION_MIN_CASES)
def test_seam_min_kernel_matches_plain(cuda, rng, case):
    """One seam: the map's top half is the slab (its region table), the row
    below it the neighbour's edge row with values drawn around the table's
    own; the flag as well as the table equal the plain version's.  Where
    no label meets across the seam the table and the flag stay as they
    were."""
    labels, m0 = _region_min_case(rng, case)
    H, W = labels.shape
    h = max(1, H // 2)
    slab = torch.from_numpy(labels[:h].copy()).to(cuda)
    roots = cca.connected_components(slab)
    table = cca.region_table(
        torch.from_numpy(m0.reshape(H, W)[:h].copy()).to(cuda), roots)
    lab_nb = labels[h] if H > 1 else rng.permutation(labels[0])
    lab_nb = torch.from_numpy(np.ascontiguousarray(lab_nb)).to(cuda)
    base = table[roots[-1].long()].cpu().numpy().astype(np.int64)
    val_nb = torch.from_numpy(np.clip(
        base + rng.integers(-1000, 1000, size=W), 0, 0x7FFFFFFF)
        .astype(np.int32)).to(cuda)
    for stamp, nb in ((4, lab_nb), (9, slab[-1] + 1)):
        outs = []
        for fn in (cca.seam_min, cca.seam_min_plain):
            t = table.clone()
            changed = torch.zeros((), dtype=torch.int32, device=cuda)
            before = launch_counts()["seam_min"]
            fn(t, roots[-1], slab[-1], nb, val_nb, changed, stamp)
            if fn is cca.seam_min:
                assert launch_counts()["seam_min"] == before + 1
            outs.append((t, changed))
        (t, c), (t_ref, c_ref) = outs
        _eq(t, t_ref)
        _eq(c, c_ref)
        if stamp == 9:
            _eq(t, table)
            assert int(c) == 0


def test_mesh_on_one_card_matches_single_device(cuda, rng):
    """ShardedSlicExplicit over four shards of one card at 720p equals
    SlicAvx2 on two warm frames; BatchedSlic over a data axis of two equals
    no mesh."""
    from fast_slic_tpu_torch.parallel.mesh import make_mesh
    from fast_slic_tpu_torch.parallel.spatial_shardmap import (
        ShardedSlicExplicit)
    mesh = make_mesh(data=1, space=4, devices=[cuda] * 4)
    sh = ShardedSlicExplicit(num_components=1600, mesh=mesh)
    single = SlicAvx2(num_components=1600, device=cuda)
    for f in _frames(rng, 2, 720, 1280):
        np.testing.assert_array_equal(sh.iterate(f), single.iterate(f))
        yxm = single.slic_model.to_yxmrgb()
        np.testing.assert_array_equal(sh.state.y, yxm[:, 0])
        np.testing.assert_array_equal(sh.state.x, yxm[:, 1])
    assert min(sh.last_seam_rounds) >= 2 and mesh.bytes_moved > 0
    frames = _frames(rng, 4)
    for mode in ("map", "stack"):
        meshed = BatchedSlic(num_components=150, batch_mode=mode,
                             mesh=make_mesh(data=2, space=2,
                                            devices=[cuda] * 4))
        plain = BatchedSlic(num_components=150, batch_mode=mode, device=cuda)
        _eq(meshed.iterate(frames), plain.iterate(frames))


def _sync_warnings(fn):
    """fn()'s result and the synchronising operations that torch's sync
    debug mode reports while it runs."""
    import warnings
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return out, sum("synchronizing CUDA operation" in str(w.message)
                    for w in caught)


def _warm_720p(cuda):
    """A SlicAvx2(1600) at 720p after its first (seeding) call, the
    frame, and the next call's frames (panned 8 px a call)."""
    slic = SlicAvx2(num_components=1600, device=cuda)
    frame = _frame_720p()
    slic.iterate(frame)
    return slic, [np.roll(frame, 8 * t, 1) for t in range(1, 6)]


def test_host_syncs_equal_the_sync_debug_warnings(cuda):
    """One 720p call: every wait of the host on the device that torch's
    sync debug mode sees is one the counters count, and no other."""
    import json
    slic, frames = _warm_720p(cuda)
    _, warned = _sync_warnings(lambda: slic.iterate(frames[0]))
    counters = json.loads(slic.slic_model.last_timing_report)["counters"]
    assert warned == counters["host_syncs"] > 0


def test_transfer_counters_are_the_bytes_moved(cuda):
    """A 720p call without a tie: up the image, the eight state fields
    and each attempt's LAB tables; down the overflow flag of each attempt
    that reads it, the tie flag, the int32 labels and the state; one host
    sync for each."""
    import json
    from fast_slic_tpu_torch.ops.cielab import lab_tables
    slic, frames = _warm_720p(cuda)
    for f in frames:
        slic.iterate(f)
        if not slic.slic_model.last_cca_tie:
            break
    assert not slic.slic_model.last_cca_tie
    rep = json.loads(slic.slic_model.last_timing_report)
    attempts = sum(c["name"] == "iteration_loop" for c in rep["children"])
    flags = attempts + 1
    tables = [t.numel() * t.element_size() for t in lab_tables("cpu")]
    state = 1600 * (5 * 4 + 8 + 4 + 4)    # y x r g b, int64 members, flags
    assert rep["counters"] == {
        "host_syncs": 1 + 8 + len(tables) * attempts + flags + 1 + 8,
        "h2d_bytes": f.nbytes + state + sum(tables) * attempts,
        "d2h_bytes": flags + 720 * 1280 * 4 + state}


def test_spans_stay_on_the_host_timeline(cuda):
    """Under a CUDA profiler the program's spans are host operator events:
    none is a user annotation, none is device-typed, and every call has
    its one entry span."""
    from torch.profiler import ProfilerActivity, profile
    slic, frames = _warm_720p(cuda)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for f in frames[:3]:
            slic.iterate(f)
        torch.cuda.synchronize()
    on_device = torch.autograd.DeviceType.CUDA
    events = prof.events()
    spans = [e for e in events if e.name.startswith("fstt.")]
    assert sum(e.name == "fstt.entry.iterate" for e in spans) == 3
    assert not any(e.is_user_annotation for e in spans)
    device = [e for e in events if e.device_type == on_device]
    assert device and not any(e.name.startswith("fstt.") for e in device)


def test_carried_720p_stream_reruns_only_on_its_first_call(cuda):
    """SlicAvx2(1600) carried over the fixture's four 720p frames starts
    each call at the candidate slots of the run it kept last: it re-runs
    at most once, on its first call, and every frame's labels and clusters
    equal the fixture's."""
    sys.path.insert(0, ROOT)
    from chip_smoke import H720, K720, W720, make_frames
    from fast_slic_tpu_torch.utils.timing import COUNTS
    ref = np.load(os.path.join(ROOT, "tests", "data", "port_720p_ref.npz"))
    slic = SlicAvx2(num_components=K720, device=cuda)
    for t, f in enumerate(make_frames(4, H720, W720)):
        before = COUNTS["runner.reruns"]
        labels = slic.iterate(f)
        assert COUNTS["runner.reruns"] - before <= (t == 0), t
        np.testing.assert_array_equal(labels, ref["slice_labels"][t],
                                      err_msg="frame %d labels" % t)
        np.testing.assert_array_equal(
            slic.slic_model.to_yxmrgb().astype(np.float32),
            ref["slice_clusters"][t], err_msg="frame %d clusters" % t)


def _cand_fields(case, rng):
    """(H, W, K, y, x, is_active as numpy [B, K], key or None, S_fixed) of
    one candidate-build case."""
    slices = np.load(os.path.join(ROOT, "tests", "data",
                                  "port_720p_ref.npz"))["slice_clusters"]
    H, W, K = 720, 1280, 1600
    key = None
    S_fixed = 0
    if case in ("grid_720p", "4k_k14400", "k28000_1080p", "k40000_1080p",
                "gh1", "gw1", "ragged"):
        H, W, K = {"grid_720p": (720, 1280, 1600),
                   "4k_k14400": (2160, 3840, 14400),
                   "k28000_1080p": (1080, 1920, 28000),
                   "k40000_1080p": (1080, 1920, 40000),
                   "gh1": (20, 300, 10), "gw1": (300, 20, 10),
                   "ragged": (123, 217, 57)}[case]
        image = rng.integers(0, 256, size=(H, W, 3)).astype(np.uint8)
        st = tcl.initialize_clusters(image, K)
        y, x = st.y[None], st.x[None]
        if case != "grid_720p":   # jittered off the grid
            y = np.clip(y + rng.uniform(-4, 4, K), 0, H - 1)
            x = np.clip(x + rng.uniform(-4, 4, K), 0, W - 1)
        act = np.ones((1, K), np.int32)
    elif case in ("one_band_k28000", "one_band_k30000"):
        # every centre in one cell row: a band list of all K entries, in
        # shared memory (28000) and past it, in the device scratch (30000)
        H, W, K = 1080, 1920, int(case[-5:])
        S = StaticConfig(H=H, W=W, K=K).S
        y = rng.uniform(5 * S, 6 * S - 1, (1, K))
        x = rng.uniform(0, W - 1, (1, K))
        act = np.ones((1, K), np.int32)
    elif case == "stacked_4":
        y, x = slices[:, :, 0], slices[:, :, 1]
        act = (rng.random((4, K)) < 0.9).astype(np.int32)
    else:   # the JAX package's carried stream state after four frames
        y, x = slices[3:, :, 0], slices[3:, :, 1]
        act = np.ones((1, K), np.int32)
        if case == "none_active":
            act[:] = 0
        if case == "one_active":
            act[:] = 0
            act[0, 777] = 1
        if case.startswith("shard"):
            # spatial_shardmap.assign_all: shard d of 4 row shards, local
            # y (negative above its rows), the image's keys, out-of-range
            # centres inactive
            S = StaticConfig(H=H, W=W, K=K).S
            Hl, r0 = H // 4, int(case[-1]) * H // 4
            key = tpipe_visit_key(y, x, S, K)
            act = act * ((y >= r0 - S - 1) & (y < r0 + Hl + S + 1))
            y = y - r0
            H, S_fixed = Hl, S
    return (H, W, K, np.ascontiguousarray(y, np.float32),
            np.ascontiguousarray(x, np.float32), act.astype(np.int32), key,
            S_fixed)


def tpipe_visit_key(y, x, S, K):
    from fast_slic_tpu_torch.kernels.candidates import visit_order_key
    return visit_order_key(torch.from_numpy(np.ascontiguousarray(y)),
                           torch.from_numpy(np.ascontiguousarray(x)), S,
                           K).numpy()


CAND_CASES = ["grid_720p", "carried_720p", "none_active", "one_active",
              "stacked_4", "shard_2", "shard_3", "4k_k14400", "k28000_1080p",
              "k40000_1080p", "one_band_k28000", "one_band_k30000", "gh1",
              "gw1", "ragged"]


@pytest.mark.parametrize("C", [4, 16, 48])
@pytest.mark.parametrize("case", CAND_CASES)
def test_candidates_kernel_matches_plain(cuda, rng, case, C):
    """The candidate kernel's lists and flag equal the plain build's (on
    the CPU) bit for bit, with and without a running flag, through
    ``pipeline.build_candidates_batched``."""
    from fast_slic_tpu_torch.kernels import candidates
    H, W, K, y, x, act, key, S_fixed = _cand_fields(case, rng)
    cfg = StaticConfig(H=H, W=W, K=K, cand_slots=C, S_fixed=S_fixed)
    GH, GW = pipeline.cell_grid_shape(cfg)
    cpu = [torch.from_numpy(a) for a in (y, x, act)]
    kcpu = None if key is None else torch.from_numpy(key)
    ref, ref_ovf = candidates.plain(*cpu, cfg.S, GH, GW, C, kcpu)
    dev = [t.to(cuda) for t in cpu]
    kdev = None if kcpu is None else kcpu.to(cuda)
    got, ovf = pipeline.build_candidates_batched(*dev, cfg, kdev)
    _eq(got, ref)
    assert bool(ovf) == bool(ref_ovf)
    for running in (False, True):
        flag = torch.tensor(running, device=cuda)
        got2, ovf2 = pipeline.build_candidates_batched(*dev, cfg, kdev, flag)
        assert ovf2 is flag
        _eq(got2, ref)
        assert bool(flag) == (running or bool(ref_ovf))
    if case == "carried_720p" and C == 4:
        assert bool(ref_ovf)
    if case == "one_band_k30000":
        assert bool(ref_ovf) and int((ref >= 0).sum()) == GW * 3 * C


def test_candidates_build_launches(cuda):
    """A build on the card is the kernel and the flag's fill, or the kernel
    alone with a running flag; ``launch_counts()["candidates"]`` advances
    by one a build, and no build waits on the device."""
    from torch.profiler import ProfilerActivity, profile
    slices = np.load(os.path.join(ROOT, "tests", "data",
                                  "port_720p_ref.npz"))["slice_clusters"]
    y = torch.from_numpy(np.ascontiguousarray(slices[0, :, 0])).to(cuda)
    x = torch.from_numpy(np.ascontiguousarray(slices[0, :, 1])).to(cuda)
    act = torch.ones(1600, dtype=torch.int32, device=cuda)
    cfg = StaticConfig(H=720, W=1280, K=1600)
    flag = torch.zeros((), dtype=torch.bool, device=cuda)
    builds = 5
    for kw, most in (({}, 2), ({"overflow": flag}, 1)):
        pipeline.build_candidates(y, x, act, cfg, **kw)
        torch.cuda.synchronize()
        before = launch_counts()["candidates"]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(builds):
                pipeline.build_candidates(y, x, act, cfg, **kw)
            torch.cuda.synchronize()
        device = {e.key: e.count for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA}
        kernel = sum(n for k, n in device.items() if "candidates_kernel" in k)
        assert kernel == builds, (kw, device)
        assert sum(device.values()) <= most * builds, (kw, device)
        assert launch_counts()["candidates"] == before + builds
        _, syncs = _sync_warnings(
            lambda: pipeline.build_candidates(y, x, act, cfg, **kw))
        assert syncs == 0
