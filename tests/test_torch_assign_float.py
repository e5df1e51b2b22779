"""PyTorch port: one float-distance assign pass against the JAX package.

The same inputs, made with numpy from a seed (fractional centres and
colours, as ``tests/test_pallas.py`` uses to reach the float window and
truncation paths), go through ``fast_slic_tpu.pipeline.assign_xla`` or the
Pallas float kernel in interpret mode, and through the port's float assign
wrapper (its plain version on the CPU).  Tolerances:

* real, real_l2, real_noq against ``assign_xla``: exact, assignment and
  min_dists;
* lsc against ``assign_pallas_float`` in interpret mode, on the same
  features and centroids: exact (both sum the ten squares left to right);
* lsc against ``assign_xla``: label agreement >= 0.999 (its ``jnp.sum``
  may add the ten squares in another order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from conftest import make_image
from fast_slic_tpu import cluster as jcl
from fast_slic_tpu import pipeline as jpipe
from fast_slic_tpu.config import StaticConfig as JaxConfig
from fast_slic_tpu_torch import pipeline as tpipe
from fast_slic_tpu_torch.cluster import clusters_from_numpy
from fast_slic_tpu_torch.config import UNASSIGNED, StaticConfig
from fast_slic_tpu_torch.kernels.assign_float import F32_MAX, assign_float
from fast_slic_tpu_torch.ops.cielab import rgb_to_lab_quantized_np

H, W, K = 94, 130, 48


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one thread: beside the suite's workers and JAX's threads a
    full torch pool oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(rng, variant, manhattan=True):
    """LAB planes, a cluster state with fractional centres and colours and
    an old assignment (numpy, shared by both packages), and the configs."""
    image = make_image(rng, H, W)
    planes = np.moveaxis(rgb_to_lab_quantized_np(image), -1, 0).astype(
        np.int32)
    st = jcl.initialize_clusters(image, K)
    st.y = np.clip(st.y + 0.37, 0, H - 1).astype(np.float32)
    st.x = np.clip(st.x + 0.61, 0, W - 1).astype(np.float32)
    st.r = (st.r + rng.uniform(-2, 2, K)).astype(np.float32)
    st.g = (st.g + 0.25).astype(np.float32)
    old = rng.integers(0, K, size=(H, W)).astype(np.int32)
    old[rng.random((H, W)) < 0.1] = UNASSIGNED
    flags = dict(variant=variant, manhattan_spatial_dist=manhattan)
    return (image, planes, st, old, JaxConfig(H=H, W=W, K=K, **flags),
            StaticConfig(H=H, W=W, K=K, **flags))


def _jax_state(st):
    return jcl.Clusters(*(jnp.asarray(getattr(st, f)) for f in (
        "y", "x", "r", "g", "b", "num_members", "is_active",
        "is_updatable")))


def _port_state(st):
    return clusters_from_numpy(st.y, st.x, st.r, st.g, st.b, st.num_members,
                               st.is_active, st.is_updatable).to_torch("cpu")


def _port_pass(planes, st, old, cfg_t, stride, rem, feats=None, cent=None):
    t = _port_state(st)
    cand, _ = tpipe.build_candidates(t.y, t.x, t.is_active, cfg_t)
    a = torch.from_numpy(old.copy())
    md = torch.full((H, W), F32_MAX)
    coef = tpipe.derive_scalars(cfg_t, 10.0, 0.25).coef
    assign_float(torch.from_numpy(planes), tpipe.center_table(t), cand, a,
                 coef, cfg_t.S, stride, rem, cfg_t.variant,
                 cfg_t.manhattan_spatial_dist, md, feats, cent)
    return a.numpy(), md.numpy()


@pytest.mark.parametrize("variant", ["real", "real_l2", "real_noq"])
@pytest.mark.parametrize("manhattan", [True, False])
@pytest.mark.parametrize("stride,rem", [(1, 0), (3, 2)])
def test_float_assign_matches_assign_xla(rng, variant, manhattan, stride,
                                         rem):
    _, planes, st, old, cfg_j, cfg_t = _inputs(rng, variant, manhattan)
    scal = jpipe.derive_scalars(cfg_j, 10.0, 0.25, 0.05)
    stj = _jax_state(st)
    cand_j, _ = jpipe.build_candidates(stj.y, stj.x, stj.is_active, cfg_j)
    ref = jpipe.assign_xla(jnp.asarray(planes), stj, cand_j, cfg_j,
                           scal.coef, jnp.asarray(old), rem, stride)
    a, md = _port_pass(planes, st, old, cfg_t, stride, rem)
    assert md.dtype == np.float32
    np.testing.assert_array_equal(a, np.asarray(ref.assignment))
    np.testing.assert_array_equal(md, np.asarray(ref.min_dists))
    skip = (np.arange(H) % stride) != rem
    np.testing.assert_array_equal(a[skip], old[skip])


def _lsc_inputs(rng):
    """Features and seed centroids from the JAX package's stage_setup, fed
    to both packages."""
    image, planes, st, old, cfg_j, cfg_t = _inputs(rng, "lsc")
    scal = jpipe.derive_scalars(cfg_j, 10.0, 0.1, 0.05)
    _, _, (feats, _, cent) = jpipe.stage_setup(
        jnp.asarray(image), jax.tree.map(jnp.asarray, st), cfg_j, scal)
    return planes, st, old, cfg_t, scal, np.array(feats), np.array(cent)


@pytest.mark.parametrize("stride,rem", [(1, 0), (3, 2)])
def test_lsc_assign_matches_pallas_interpret(rng, stride, rem):
    planes, st, old, cfg_t, scal, feats, cent = _lsc_inputs(rng)
    cfg_p = JaxConfig(H=H, W=W, K=K, arch="pallas", variant="lsc",
                      debug_mode=True)
    stj = _jax_state(st)
    cand_j, _ = jpipe.build_candidates(stj.y, stj.x, stj.is_active, cfg_p)
    p_j = jnp.asarray(planes)
    ref = jpipe.assign_dispatch(
        p_j, jpipe._pad_planes_for_pallas(p_j, cfg_p), stj, cand_j, cfg_p,
        scal.coef, jnp.asarray(old), rem, stride, jnp.asarray(feats),
        jnp.asarray(cent),
        jpipe._pad_planes_for_pallas(jnp.asarray(feats), cfg_p, jnp.float32))
    a, md = _port_pass(planes, st, old, cfg_t, stride, rem,
                       torch.from_numpy(feats), torch.from_numpy(cent))
    np.testing.assert_array_equal(a, np.asarray(ref.assignment))
    wrote = np.broadcast_to(((np.arange(H) % stride) == rem)[:, None],
                            (H, W))
    np.testing.assert_array_equal(md[wrote], np.asarray(ref.min_dists)[wrote])


def test_lsc_assign_agrees_with_assign_xla(rng):
    planes, st, old, cfg_t, scal, feats, cent = _lsc_inputs(rng)
    cfg_j = JaxConfig(H=H, W=W, K=K, variant="lsc")
    stj = _jax_state(st)
    cand_j, _ = jpipe.build_candidates(stj.y, stj.x, stj.is_active, cfg_j)
    ref = jpipe.assign_xla(jnp.asarray(planes), stj, cand_j, cfg_j,
                           scal.coef, jnp.asarray(old), 0, 1,
                           jnp.asarray(feats), jnp.asarray(cent))
    a, md = _port_pass(planes, st, old, cfg_t, 1, 0,
                       torch.from_numpy(feats), torch.from_numpy(cent))
    assert float((a == np.asarray(ref.assignment)).mean()) >= 0.999
    np.testing.assert_allclose(md, np.asarray(ref.min_dists), rtol=1e-5)


def test_float_assign_wrapper_validates(rng):
    _, planes, st, old, _, cfg_t = _inputs(rng, "lsc")
    t = _port_state(st)
    cand, _ = tpipe.build_candidates(t.y, t.x, t.is_active, cfg_t)
    args = (torch.from_numpy(planes), tpipe.center_table(t), cand,
            torch.from_numpy(old), 1.0, cfg_t.S, 1, 0)
    with pytest.raises(ValueError, match="feats"):
        assign_float(*args, "lsc")                 # LSC needs its features
    with pytest.raises(ValueError, match="variant"):
        assign_float(*args, "standard")            # the quantized kernel's
