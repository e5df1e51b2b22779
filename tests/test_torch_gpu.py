"""PyTorch port: each CUDA kernel against its plain PyTorch version.

Needs a CUDA device; every test here skips without one.  The file imports
neither jax nor tests/conftest.py's helpers, so on a GPU machine without
JAX it runs on its own:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

Exact: integer outputs (the orphan chase too, on random orphan DAGs, a
3000-hop chain, three stacked frames and a real 720p frame's tables) and
the float assign's distances must be equal;
the LSC colour features too, and so must the masked update, the per-frame
segment sum and the frame-axis launches of assign, float assign and
update.  The f32 segment sum must equal its plain version on the CPU,
whose order of addition it keeps, and give the same sums on every run
(on the card, index_add_ adds with float atomics in a changing order),
also with a preemptive-like mask at 720p, a single bin, empty bins and
unmasked pixels in the last bin.  On the card, the float variants' slices equal the CPU plain
path, and LSC's labels agree >= 0.999 (its image-wide f32 sums differ by
order between the two devices); so do the preemptive grid and the batched
frames (``BatchedSlic`` in stack and map mode).
"""

import os

import numpy as np
import pytest
import torch

from fast_slic_tpu_torch import (LSCAvx2, SlicAvx2, SlicRealDist,
                                 SlicRealDistL2, SlicRealDistNoQ, pipeline,
                                 runner)
from fast_slic_tpu_torch import cluster as tcl
from fast_slic_tpu_torch.config import UNASSIGNED, RuntimeParams, StaticConfig
from fast_slic_tpu_torch.kernels import (assign, assign_float, cca, fsegsum,
                                         lab, lsc_feat, segsum)
from fast_slic_tpu_torch.ops.cca import cca_parts, orphan_tables
from fast_slic_tpu_torch.ops.cielab import rgb_to_lab_quantized_np
from fast_slic_tpu_torch.parallel.batch import BatchedSlic

pytestmark = pytest.mark.gpu

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "golden_ref.npz")


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


def _spiral(n):
    lab_ = np.ones([n, n], np.int32)
    lab_[::2, :] = 0
    for i, r in enumerate(range(1, n, 2)):
        lab_[r, (n - 1) if i % 2 == 0 else 0] = 0   # a serpentine
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


def _orphan_dag(rng, n):
    """Tables as ops.cca.orphan_tables builds them for one frame."""
    sub = rng.integers(0, n, size=n).astype(np.int32)
    sub[rng.random(n) < 0.6] = UNASSIGNED
    sub[0] = 0
    target = np.zeros(n, np.int32)
    target[1:] = rng.integers(0, np.arange(1, n))
    return sub, target


def _frame_720p():
    image = np.load(DATA)["image"]
    ys = np.arange(720) * image.shape[0] // 720
    xs = np.arange(1280) * image.shape[1] // 1280
    return np.ascontiguousarray(image[ys][:, xs])


def _raw_720p_orphan_tables(dev):
    """The orphan-chase tables of a real raw assignment: SlicAvx2's loop at
    720p, K=1600, then the CCA's selection."""
    frame = _frame_720p()
    H, W, K = 720, 1280, 1600
    cfg = StaticConfig(H=H, W=W, K=K)
    scal = pipeline.derive_scalars(cfg, 10.0, 0.25)
    out = pipeline.iterate_graph(torch.from_numpy(frame).to(dev),
                                 tcl.initialize_clusters(frame, K).to_torch(
                                     dev), cfg, scal, 10, 3)
    _, areas, target, ncomp = cca_parts(out.raw_assignment)
    sub, ptrs, _ = orphan_tables(areas, target, ncomp, K, int(scal.thres))
    return sub, ptrs


@pytest.mark.parametrize("case", ["random", "chain_3000", "stacked_3",
                                  "unlabelled_loops", "raw_720p"])
def test_resolve_orphans_kernel_matches_plain(cuda, rng, case):
    if case == "random":
        sub, target = _orphan_dag(rng, 70001)
    elif case == "unlabelled_loops":
        # dropped entries in loops that reach no label: the walk stops at
        # its n-hop bound and writes 0, as the plain version does
        sub, target = _orphan_dag(rng, 3000)
        loops = rng.choice(np.arange(1, 3000), 200, replace=False)
        sub[loops] = UNASSIGNED
        target[loops] = np.roll(loops, 1)
    elif case == "chain_3000":
        sub = np.full(3001, UNASSIGNED, np.int32)
        sub[0] = 7
        target = np.maximum(np.arange(3001, dtype=np.int32) - 1, 0)
    elif case == "stacked_3":
        frames = [_orphan_dag(rng, 4000) for _ in range(3)]
        sub = np.concatenate([f[0] for f in frames])
        target = np.concatenate([f[1] + 4000 * i
                                 for i, f in enumerate(frames)])
    if case == "raw_720p":
        sub, target = _raw_720p_orphan_tables(cuda)
        assert bool((sub == UNASSIGNED).any())
    else:
        sub = torch.from_numpy(sub).to(cuda)
        target = torch.from_numpy(target.astype(np.int32)).to(cuda)
    got = cca.resolve_orphans(sub, target)
    _eq(got, cca.resolve_orphans_plain(sub, target))
    assert not bool((got == UNASSIGNED).any())


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


def test_framed_segment_sum_kernel_matches_plain(cuda, rng):
    B, Nf, V, MF = 4, 30011, 2, 5000
    ids = torch.from_numpy(np.sort(rng.integers(0, MF + 3, size=(B, Nf)),
                                   1).astype(np.int32)).to(cuda)
    vals = torch.from_numpy(rng.integers(0, 1 << 20, size=(V, B, Nf)).astype(
        np.int32)).to(cuda)
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
