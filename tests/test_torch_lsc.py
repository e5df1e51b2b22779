"""PyTorch port: the LSC ops and their two kernels' plain versions against
the JAX package.

The same inputs, made with numpy from a seed, go through
``fast_slic_tpu.ops.lsc`` (and its Pallas kernels in interpret mode) and
through ``fast_slic_tpu_torch.ops.lsc`` and the kernel wrappers (their plain
versions on the CPU).  Tolerances:

* ``trig_tables`` and the colour-feature gather: exact;
* ``features``, ``seed_centroids`` and ``after_update``: rtol 1e-5, atol
  1e-6.  The port sums the image mean and the seed windows in float64
  and rounds once, the JAX package sums them in float32, so the two
  differ by a few ulp;
* the f32 segment sum against ``float_segsum_pallas``: rtol 2e-6, atol
  1e-4, as ``tests/test_pallas.py`` holds that kernel against a serial
  sum (f32 accumulation order differs).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from conftest import make_image
from fast_slic_tpu import cluster as jcl
from fast_slic_tpu.config import StaticConfig as JaxConfig
from fast_slic_tpu.ops import lsc as jlsc
from fast_slic_tpu.pallas.lut_tpu import lsc_color_feats_pallas
from fast_slic_tpu.pallas.segsum_tpu import float_segsum_pallas
from fast_slic_tpu_torch import cluster as tcl
from fast_slic_tpu_torch.config import UNASSIGNED, StaticConfig
from fast_slic_tpu_torch.kernels import fsegsum, lsc_feat
from fast_slic_tpu_torch.ops import lsc as tlsc
from fast_slic_tpu_torch.ops.cielab import rgb_to_lab_quantized_np

H, W, K = 94, 130, 48
CLOSE = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one thread: beside the suite's workers and JAX's threads a
    full torch pool oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(**kw):
    return (JaxConfig(H=H, W=W, K=K, arch="xla", variant="lsc", **kw),
            StaticConfig(H=H, W=W, K=K, variant="lsc", **kw))


def _planes(rng):
    image = make_image(rng, H, W)
    return image, np.moveaxis(rgb_to_lab_quantized_np(image), -1,
                              0).astype(np.int32)


def _port_state(st):
    return tcl.clusters_from_numpy(st.y, st.x, st.r, st.g, st.b,
                                   st.num_members, st.is_active,
                                   st.is_updatable).to_torch("cpu")


@pytest.mark.parametrize("shape,comp", [((94, 130, 48), 10.0),
                                        ((720, 1280, 1600), 10.0),
                                        ((386, 620, 256), 23.5)])
def test_trig_tables_match_jax(shape, comp):
    h, w, k = shape
    tj = jlsc.trig_tables(JaxConfig(H=h, W=w, K=k, variant="lsc"), comp)
    tt = tlsc.trig_tables(StaticConfig(H=h, W=w, K=k, variant="lsc"), comp)
    assert sorted(tj) == sorted(tt)
    for name in tj:
        assert tt[name].dtype == np.float32
        np.testing.assert_array_equal(tt[name], tj[name], err_msg=name)


def test_lsc_feat_plain_matches_pallas_interpret(rng):
    planes = rng.integers(0, 256, (3, H, W)).astype(np.int32)
    t = tlsc.trig_tables(_configs()[1], 10.0)
    tabs = [t[k] for k in ("L_cos", "L_sin", "color_cos", "color_sin")]
    ref = np.asarray(lsc_color_feats_pallas(jnp.asarray(planes), *tabs,
                                            interpret=True))
    got = lsc_feat.lsc_color_feats(torch.from_numpy(planes),
                                   *map(torch.from_numpy, tabs))
    assert got.dtype == torch.float32 and got.shape == (6, H, W)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_features_and_seed_centroids_match_jax(rng):
    image, planes = _planes(rng)
    cfg_j, cfg_t = _configs()
    tables = tlsc.trig_tables(cfg_t, 10.0)
    fj, wj = jlsc.features(jnp.asarray(planes), cfg_j, tables)
    ft, wt = tlsc.features(torch.from_numpy(planes), cfg_t, tables)
    assert ft.shape == (10, H, W) and wt.shape == (H, W)
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), **CLOSE)
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), **CLOSE)

    st = jcl.initialize_clusters(image, K)
    # fractional centres: the window is taken at the int-cast centre
    st.y = np.clip(st.y + 0.37, 0, H - 1).astype(np.float32)
    st.x = np.clip(st.x + 0.61, 0, W - 1).astype(np.float32)
    cj = jlsc.seed_centroids(fj, jax.tree.map(jnp.asarray, st), cfg_j)
    ct = tlsc.seed_centroids(ft, _port_state(st), cfg_t)
    assert ct.shape == (K, 10) and ct.dtype == torch.float32
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), **CLOSE)


@pytest.mark.parametrize("wrow", [None, 10])
def test_fsegsum_plain_matches_pallas_interpret(rng, wrow):
    N, V, nseg = 5000, 11, 300
    ids = np.sort(rng.integers(0, nseg + 1, size=N)).astype(np.int32)
    mask = (rng.random(N) < 0.9).astype(np.int32)
    vals = rng.random((V, N)).astype(np.float32)
    ref = np.asarray(float_segsum_pallas(
        jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(vals), nseg, True,
        wrow=wrow))
    got = fsegsum.float_segsum(torch.from_numpy(ids), torch.from_numpy(mask),
                               torch.from_numpy(vals), nseg, wrow)
    assert got.shape == (V, nseg + 1) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-6, atol=1e-4)


@pytest.mark.parametrize("stride,rem", [(3, 1), (1, 0)])
def test_after_update_matches_jax(rng, stride, rem):
    image, planes = _planes(rng)
    cfg_j, cfg_t = _configs()
    tables = tlsc.trig_tables(cfg_t, 10.0)
    feats, weights = jlsc.features(jnp.asarray(planes), cfg_j, tables)
    st = jcl.initialize_clusters(image, K)
    st.is_updatable[rng.choice(K, 5, replace=False)] = 0
    cent = rng.random((K, 10)).astype(np.float32)
    asg = rng.integers(0, K, size=(H, W)).astype(np.int32)
    asg[rng.random((H, W)) < 0.1] = UNASSIGNED
    ref = jlsc.after_update(feats, weights, jax.tree.map(jnp.asarray, st),
                            jnp.asarray(cent), cfg_j, rem, stride,
                            jnp.asarray(asg))
    got = tlsc.after_update(torch.from_numpy(np.array(feats)),
                            torch.from_numpy(np.array(weights)),
                            _port_state(st), torch.from_numpy(cent), cfg_t,
                            rem, stride, torch.from_numpy(asg))
    assert got.shape == (K, 10)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **CLOSE)
    # clusters that may not update keep their centroid
    keep = st.is_updatable == 0
    np.testing.assert_array_equal(got.numpy()[keep], cent[keep])
