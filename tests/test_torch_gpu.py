"""PyTorch port: each CUDA kernel against its plain PyTorch version.

Needs a CUDA device; every test here skips without one.  The file imports
neither jax nor tests/conftest.py's helpers, so on a GPU machine without
JAX it runs on its own:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

Exact: integer outputs must be equal.
"""

import os

import numpy as np
import pytest
import torch

from fast_slic_tpu_torch import SlicAvx2, pipeline, runner
from fast_slic_tpu_torch import cluster as tcl
from fast_slic_tpu_torch.config import UNASSIGNED, RuntimeParams, StaticConfig
from fast_slic_tpu_torch.kernels import assign, cca, lab, segsum
from fast_slic_tpu_torch.ops.cielab import rgb_to_lab_quantized_np

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


def test_lookup_kernel_matches_plain(cuda, rng):
    table = torch.from_numpy(rng.integers(0, 1 << 30, size=7777).astype(
        np.int32)).to(cuda)
    ids = torch.from_numpy(rng.integers(0, 7777, size=(311, 97)).astype(
        np.int32)).to(cuda)
    _eq(cca.lookup(ids, table), cca.lookup_plain(ids, table))


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
