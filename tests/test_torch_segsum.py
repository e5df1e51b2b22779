"""PyTorch port: the update sums and the segment sum against the JAX package.

The port's wrappers run their plain versions on the CPU; they must equal
``fast_slic_tpu.pipeline.update_accumulate`` (arch xla) and the Pallas
kernels ``slic_update_padded_pallas``, ``segment_sum_pallas`` and
``framed_segment_sum_pallas`` in interpret mode.  Exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fast_slic_tpu import pipeline as jpipe
from fast_slic_tpu.config import StaticConfig as JaxConfig
from fast_slic_tpu.pallas.segsum_tpu import (framed_segment_sum_pallas,
                                             segment_sum_pallas,
                                             slic_update_padded_pallas)
from fast_slic_tpu_torch.config import UNASSIGNED
from fast_slic_tpu_torch.kernels.segsum import (framed_segment_sum,
                                                segment_sum, slic_update)
from torch_threads import one_torch_thread  # noqa: F401

H, W, K = 70, 100, 24


def _assignment(rng):
    a = rng.integers(0, K, size=(H, W)).astype(np.int32)
    a[rng.random((H, W)) < 0.07] = UNASSIGNED
    planes = rng.integers(0, 256, size=(3, H, W)).astype(np.int32)
    return a, planes


def _superpixels(rng, S=20):
    """A superpixel-like assignment, the layout the update kernels' tiles
    gather on chip: S x S cells (20 ids) whose borders move by up to S/4
    pixels a row and a column, ~7 % 0xFFFF."""
    GH, GW = -(-H // S), -(-W // S)
    di = rng.integers(-(S // 4), S // 4 + 1, size=W)
    dj = rng.integers(-(S // 4), S // 4 + 1, size=H)
    ci = np.clip((np.arange(H)[:, None] + di) // S, 0, GH - 1)
    cj = np.clip((np.arange(W) + dj[:, None]) // S, 0, GW - 1)
    a = (ci * GW + cj).astype(np.int32)
    a[rng.random((H, W)) < 0.07] = UNASSIGNED
    planes = rng.integers(0, 256, size=(3, H, W)).astype(np.int32)
    return a, planes


@pytest.mark.parametrize("stride,rem,layout", [
    pytest.param(s, r, layout, id="%d-%d%s" % (s, r, suffix))
    for layout, suffix in (("random", ""), ("superpixels", "-superpixels"))
    for s, r in ((3, 0), (3, 1), (3, 2), (1, 0))])
def test_update_matches_update_accumulate(rng, stride, rem, layout):
    a, planes = (_assignment if layout == "random" else _superpixels)(rng)
    cfg = JaxConfig(H=H, W=W, K=K, arch="xla")
    ref = np.asarray(jpipe.update_accumulate(
        jnp.asarray(planes), jnp.asarray(a), cfg, rem, stride))   # [K, 6]
    got = slic_update(torch.from_numpy(a), torch.from_numpy(planes), K,
                      stride, rem)
    assert got.dtype == torch.int32 and tuple(got.shape) == (6, K)
    np.testing.assert_array_equal(got.numpy(), ref.T)


@pytest.mark.parametrize("rem", [0, 2])
def test_update_matches_padded_pallas_interpret(rng, rem):
    stride = 3
    a, planes = _assignment(rng)
    # the TPU layout: rows rem::stride, padded to 64 rows and 128 lanes with
    # junk that the kernel must ignore
    Hs = -(-(H - rem) // stride)
    Hsp, Wp = 64, 128
    a_pad = rng.integers(0, K, size=(Hsp, Wp)).astype(np.int32)
    a_pad[:Hs, :W] = a[rem::stride]
    p_pad = rng.integers(0, 256, size=(3, Hsp, Wp)).astype(np.int32)
    p_pad[:, :Hs, :W] = planes[:, rem::stride]
    ref = np.asarray(slic_update_padded_pallas(
        jnp.asarray(a_pad), jnp.asarray(p_pad), jnp.int32(rem), jnp.int32(0),
        K, Wp, W, Hs, stride, True))
    got = slic_update(torch.from_numpy(a), torch.from_numpy(planes), K,
                      stride, rem)
    np.testing.assert_array_equal(got.numpy(), ref[:, :K])


@pytest.mark.parametrize("coherent", [True, False])
def test_segment_sum_matches_pallas_interpret(rng, coherent):
    N, V, S = 5000, 3, 300
    ids = rng.integers(0, S + 1, size=N).astype(np.int32)
    if coherent:  # CCA component ids grow with pixel position
        ids = np.sort(ids)
    vals = rng.integers(0, 1 << 16, size=(V, N)).astype(np.int32)
    ref = np.asarray(segment_sum_pallas(jnp.asarray(ids), jnp.asarray(vals),
                                        S, interpret=True))
    got = segment_sum(torch.from_numpy(ids), torch.from_numpy(vals), S)
    assert tuple(got.shape) == (V, S + 1)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("V", [1, 2, 5])
def test_segment_sum_runs_and_last_bin_match_pallas_interpret(rng, V):
    # runs of equal ids (as component ids lie along rows, the layout the
    # card's kernel sums on chip) and a tenth of the pixels in bin S, the
    # bin past the S real ones where callers put what they drop (the JAX
    # function's contract is ids in [0, S]; the card's kernel also drops ids
    # outside [0, S], held against this plain version in
    # tests/test_torch_gpu.py)
    N, S = 5000, 400
    ids = np.minimum(np.repeat(np.arange(N), rng.integers(1, 48, N))[:N], S)
    ids[rng.random(N) < 0.1] = S
    ids = ids.astype(np.int32)
    vals = rng.integers(0, 1 << 16, size=(V, N)).astype(np.int32)
    ref = np.asarray(segment_sum_pallas(jnp.asarray(ids), jnp.asarray(vals),
                                        S, interpret=True))
    got = segment_sum(torch.from_numpy(ids), torch.from_numpy(vals), S)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_segment_sum_values_beyond_16_bits(rng):
    # the port has no 2^16 value limit (int32 atomics, no byte split)
    N, S = 4000, 50
    ids = rng.integers(0, S + 1, size=N).astype(np.int32)
    vals = rng.integers(0, 1 << 20, size=(2, N)).astype(np.int32)
    ref = np.zeros((2, S + 1), np.int64)
    for v in range(2):
        np.add.at(ref[v], ids, vals[v])
    got = segment_sum(torch.from_numpy(ids), torch.from_numpy(vals), S)
    np.testing.assert_array_equal(got.numpy(), ref)


# The per-frame segment sum (the stacked batch's CCA call) on the layout
# its card kernel sums on chip: each frame's ids in runs of 1-47 equal ids,
# and a tenth of them on the frame's last bin (MF - 1); one and three
# frames.  Values stay below 2^16, the Pallas kernel's own limit.
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("layout", ["runs", "last_bin"])
def test_framed_segment_sum_runs_match_pallas_interpret(rng, layout, B):
    Nf, V, MF = 5000, 2, 400
    ids = np.stack([np.minimum(np.repeat(np.arange(Nf),
                                         rng.integers(1, 48, Nf))[:Nf],
                               MF - 1) for _ in range(B)])
    if layout == "last_bin":
        ids[rng.random((B, Nf)) < 0.1] = MF - 1
    ids = ids.astype(np.int32)
    vals = rng.integers(0, 1 << 16, size=(V, B, Nf)).astype(np.int32)
    ref = np.asarray(framed_segment_sum_pallas(
        jnp.asarray(ids), jnp.asarray(vals), MF, interpret=True))
    got = framed_segment_sum(torch.from_numpy(ids), torch.from_numpy(vals),
                             MF)
    assert got.dtype == torch.int32 and tuple(got.shape) == (B, V, MF)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("B", [1, 3])
def test_framed_segment_sum_values_beyond_16_bits(rng, B):
    # no 2^16 value limit in the port; ids outside [0, MF) drop
    Nf, MF = 4000, 50
    ids = rng.integers(-3, MF + 3, size=(B, Nf)).astype(np.int32)
    vals = rng.integers(0, 1 << 20, size=(2, B, Nf)).astype(np.int32)
    ref = np.zeros((B, 2, MF), np.int64)
    for f in range(B):
        keep = (ids[f] >= 0) & (ids[f] < MF)
        for v in range(2):
            np.add.at(ref[f, v], ids[f][keep], vals[v, f][keep])
    got = framed_segment_sum(torch.from_numpy(ids), torch.from_numpy(vals),
                             MF)
    np.testing.assert_array_equal(got.numpy(), ref)
