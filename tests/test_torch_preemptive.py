"""PyTorch port: the preemptive grid against the JAX package.

The same inputs, made with numpy from a seed, go through the JAX package
and the port (plain versions on the CPU):

* ``derive_scalars().l1_thres`` equals the JAX one: exact;
* ``pipeline._preemptive_step`` equals ``fast_slic_tpu.pipeline
  ._preemptive_step`` (one frame) and ``parallel.stack
  ._preemptive_step_stacked`` (B frames): is_active, is_updatable and the
  pixel mask, exactly;
* ``slic_update_masked_plain`` equals the Pallas kernel
  ``slic_update_pallas`` in interpret mode on the same pixels (one frame
  with hmod=0; three frames with hmod=Hs and ids offset by b*K): exact;
* the whole pipeline with ``preemptive=True`` equals
  ``compiled_iterate`` (arch xla): labels, raw assignment and every
  cluster field exactly for standard and real; for LSC, label agreement
  >= 0.999 and clusters within rtol 1e-5, because the port sums the image
  mean and the seed windows in float64 and the JAX package in float32
  (tests/test_torch_lsc.py);
* golden ``std_k256_preempt`` through ``Slic(preemptive=True)``: labels
  agree 1.0, y/x/num_members equal.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from conftest import make_image
from fast_slic_tpu import cluster as jcl
from fast_slic_tpu import pipeline as jpipe
from fast_slic_tpu.config import StaticConfig as JaxConfig
from fast_slic_tpu.pallas.segsum_tpu import slic_update_pallas
from fast_slic_tpu.parallel.stack import _preemptive_step_stacked
from fast_slic_tpu_torch import Slic
from fast_slic_tpu_torch import cluster as tcl
from fast_slic_tpu_torch import pipeline as tpipe
from fast_slic_tpu_torch.config import UNASSIGNED, StaticConfig
from fast_slic_tpu_torch.kernels.segsum import (slic_update_masked,
                                                slic_update_masked_plain)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "golden_ref.npz")
FIELDS = ("y", "x", "r", "g", "b", "num_members", "is_active",
          "is_updatable")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one thread: beside the suite's workers and JAX's threads a
    full torch pool oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _to_torch(st):
    return tcl.clusters_from_numpy(*(np.asarray(getattr(st, f))
                                     for f in FIELDS)).to_torch("cpu")


@pytest.mark.parametrize("thres", [0.0, 0.01, 0.05, 0.1, 0.37])
@pytest.mark.parametrize("H,W,K", [(96, 128, 64), (386, 620, 256),
                                   (720, 1280, 1600)])
def test_l1_thres_matches_jax(thres, H, W, K):
    got = tpipe.derive_scalars(StaticConfig(H=H, W=W, K=K), 10.0, 0.25,
                               thres)
    ref = jpipe.derive_scalars(JaxConfig(H=H, W=W, K=K), 10.0, 0.25, thres)
    assert got.l1_thres.dtype == np.float32
    assert got.l1_thres == ref.l1_thres


def _random_state(rng, B, H, W, K):
    """Cluster fields [B, K] (or [K] for B = None) with fractional centres,
    mixed cooldowns and old centres some of which moved less than l1."""
    shape = (K,) if B is None else (B, K)
    y = rng.uniform(0, H - 1, shape).astype(np.float32)
    x = rng.uniform(0, W - 1, shape).astype(np.float32)
    step = rng.choice([0.0, 0.4, 3.0, 9.0], shape, p=[0.7, 0.1, 0.1, 0.1])
    old_y = np.clip(y + step * rng.choice([-1, 1], shape), 0,
                    H - 1).astype(np.float32)
    old_x = np.clip(x - step * rng.choice([-1, 1], shape), 0,
                    W - 1).astype(np.float32)
    z = np.zeros(shape, np.float32)
    st = jcl.Clusters(
        y=y, x=x, r=z, g=z, b=z, num_members=np.zeros(shape, np.uint32),
        is_active=rng.integers(0, 2, shape).astype(np.int32),
        # mostly frozen, so that some cells have no updatable neighbour
        is_updatable=rng.choice([0, 1, 2], shape,
                                p=[0.85, 0.1, 0.05]).astype(np.int32))
    return st, old_y, old_x


@pytest.mark.parametrize("B", [None, 3])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_preemptive_step_matches_jax(B, seed):
    rng = np.random.default_rng(seed)
    H, W, K = 70 + 13 * seed, 101, 40
    st, old_y, old_x = _random_state(rng, B, H, W, K)
    cfg_j = JaxConfig(H=H, W=W, K=K, arch="xla", preemptive=True)
    l1 = jpipe.derive_scalars(cfg_j, 10.0, 0.25, 0.2).l1_thres
    step = jpipe._preemptive_step if B is None else _preemptive_step_stacked
    st_j, px_j = step(jax.tree.map(jnp.asarray, st), jnp.asarray(old_y),
                      jnp.asarray(old_x), cfg_j,
                      jnp.asarray(l1, jnp.float32))

    cfg_t = StaticConfig(H=H, W=W, K=K, preemptive=True)
    st_t, px_t = tpipe._preemptive_step(
        _to_torch(st), torch.from_numpy(old_y), torch.from_numpy(old_x),
        cfg_t, tpipe.derive_scalars(cfg_t, 10.0, 0.25, 0.2).l1_thres)
    np.testing.assert_array_equal(st_t.is_active.numpy(),
                                  np.asarray(st_j.is_active))
    np.testing.assert_array_equal(st_t.is_updatable.numpy(),
                                  np.asarray(st_j.is_updatable))
    assert px_t.dtype == torch.bool
    np.testing.assert_array_equal(px_t.numpy(), np.asarray(px_j))
    # the random state exercises both outcomes of every test
    assert 0 < int(st_t.is_active.sum()) < st_t.is_active.numel()
    assert 0 < int(px_t.sum()) < px_t.numel()


@pytest.mark.parametrize("B,stride,rem", [(1, 3, 0), (1, 3, 2), (1, 1, 0),
                                          (3, 3, 1), (3, 1, 0)])
def test_slic_update_masked_matches_pallas_interpret(rng, B, stride, rem):
    H, W, K = 70, 100, 24
    a = rng.integers(0, K, size=(B, H, W)).astype(np.int32)
    a[rng.random((B, H, W)) < 0.07] = UNASSIGNED
    planes = rng.integers(0, 256, size=(3, B, H, W)).astype(np.int32)
    mask = rng.random((B, H, W)) < 0.6

    # the JAX kernel reads the row-subsampled stack: frame b's rows
    # rem::stride, hmod rows a frame, ids offset by b*K
    a_s, p_s, m_s = a[:, rem::stride], planes[:, :, rem::stride], \
        mask[:, rem::stride]
    Hs = a_s.shape[1]
    offs = (np.arange(B, dtype=np.int32) * K)[:, None, None]
    ok = (a_s != UNASSIGNED) & m_s
    ids = np.where(a_s != UNASSIGNED, a_s + offs, offs)
    ref = np.asarray(slic_update_pallas(
        jnp.asarray(ids.ravel()), jnp.asarray(ok.astype(np.int32).ravel()),
        jnp.asarray(p_s[0].ravel()), jnp.asarray(p_s[1].ravel()),
        jnp.asarray(p_s[2].ravel()), jnp.int32(rem), B * K, W, stride, True,
        hmod=Hs if B > 1 else 0))

    args = (torch.from_numpy(a), torch.from_numpy(planes),
            torch.from_numpy(mask))
    if B == 1:
        args = (args[0][0], args[1][:, 0], args[2][0])
    got = slic_update_masked_plain(*args, K, stride, rem)
    assert got.dtype == torch.int32 and tuple(got.shape) == (6, B * K)
    np.testing.assert_array_equal(got.numpy(), ref[:, :B * K])
    # the wrapper takes the plain version for a CPU tensor
    np.testing.assert_array_equal(
        slic_update_masked(*args, K, stride, rem).numpy(), got.numpy())


@pytest.mark.parametrize("variant,thres", [("standard", 0.05),
                                           ("standard", 0.3),
                                           ("real", 0.3), ("lsc", 0.3)])
def test_iterate_matches_jax_pipeline(rng, variant, thres):
    H, W, K, stride = 96, 128, 64, 3
    image = make_image(rng, H, W)
    st = jcl.initialize_clusters(image, K)
    cfg_j = JaxConfig(H=H, W=W, K=K, arch="xla", variant=variant,
                      preemptive=True)
    scal_j = jpipe.derive_scalars(cfg_j, 10.0, 0.25, thres)
    out_j = jpipe.compiled_iterate(cfg_j, 10, stride)(
        image, jax.tree.map(jnp.asarray, st), scal_j)

    cfg_t = StaticConfig(H=H, W=W, K=K, variant=variant, preemptive=True)
    scal_t = tpipe.derive_scalars(cfg_t, 10.0, 0.25, thres)
    out_t = tpipe.iterate_graph(torch.from_numpy(image), _to_torch(st),
                                cfg_t, scal_t, 10, stride)
    got = out_t.clusters.as_numpy()
    # the grid froze some clusters, so the masked update was exercised
    assert (np.asarray(out_j.clusters.is_updatable) == 0).any()
    if variant == "lsc":
        agree = float((out_t.labels.numpy() == np.asarray(out_j.labels)
                       ).mean())
        assert agree >= 0.999, agree
        for f in FIELDS:
            np.testing.assert_allclose(getattr(got, f),
                                       np.asarray(getattr(out_j.clusters, f)),
                                       rtol=1e-5, err_msg=f)
        return
    np.testing.assert_array_equal(out_t.raw_assignment.numpy(),
                                  np.asarray(out_j.raw_assignment))
    np.testing.assert_array_equal(out_t.labels.numpy(),
                                  np.asarray(out_j.labels))
    assert bool(out_t.cca_tie) == bool(np.asarray(out_j.cca_tie))
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f),
                                      np.asarray(getattr(out_j.clusters, f)),
                                      err_msg=f)


def test_golden_std_k256_preempt():
    g = np.load(DATA)
    image = g["image"]
    slic = Slic(num_components=256, min_size_factor=0.1, preemptive=True,
                preemptive_thres=0.05, device="cpu")
    labels = slic.iterate(image)
    agreement = float((labels.astype(np.int64) == g["std_k256_preempt"]
                       ).mean())
    assert agreement == 1.0, agreement
    ref = g["std_k256_preempt_clusters"]
    yxm = slic.slic_model.to_yxmrgb()
    np.testing.assert_array_equal(yxm[:, 0], ref[:, 0])
    np.testing.assert_array_equal(yxm[:, 1], ref[:, 1])
    np.testing.assert_array_equal(yxm[:, 2], ref[:, 5])


def test_preemptive_on_cuda_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works")
    with pytest.raises(RuntimeError, match="cuda"):
        Slic(num_components=16, preemptive=True)
