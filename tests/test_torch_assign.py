"""PyTorch port: candidate lists and one assign pass against the JAX package.

The same inputs, made with numpy from a seed, go through
``fast_slic_tpu.pipeline.build_candidates`` + ``assign_xla`` (and the Pallas
assign kernel in interpret mode) and through the port's
``build_candidates`` + assign wrapper (its plain version on the CPU).
Exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from conftest import make_image
from fast_slic_tpu import cluster as jcl
from fast_slic_tpu import pipeline as jpipe
from fast_slic_tpu.config import StaticConfig as JaxConfig
from fast_slic_tpu_torch import pipeline as tpipe
from fast_slic_tpu_torch.cluster import clusters_from_numpy
from fast_slic_tpu_torch.config import UNASSIGNED, StaticConfig
from fast_slic_tpu_torch.kernels.assign import assign
from fast_slic_tpu_torch.ops.cielab import rgb_to_lab_quantized_np
from torch_threads import one_torch_thread  # noqa: F401

H, W, K = 64, 96, 24


def _inputs(rng, manhattan=True, cand_slots=16, inactive_patch=False):
    """Image planes, a jittered cluster state with a few inactive clusters
    (with ``inactive_patch``, also every cluster of the top-left 40x40
    pixels, so cell (0, 0) has no candidate), and an old assignment, as
    numpy arrays shared by both packages."""
    image = make_image(rng, H, W)
    planes = np.moveaxis(rgb_to_lab_quantized_np(image), -1, 0).astype(
        np.int32)
    st = jcl.initialize_clusters(image, K)
    st.y = np.clip(st.y + rng.uniform(-5, 5, K), 0, H - 1).astype(np.float32)
    st.x = np.clip(st.x + rng.uniform(-5, 5, K), 0, W - 1).astype(np.float32)
    # colours stay integer-valued, as the update's round_int means are
    # (the Pallas kernel's bf16 colour expansion relies on it)
    st.r = np.clip(st.r + rng.integers(-3, 4, K), 0, 255).astype(np.float32)
    st.is_active[rng.choice(K, 3, replace=False)] = 0
    if inactive_patch:
        st.is_active[(st.y < 40) & (st.x < 40)] = 0
    old = rng.integers(0, K, size=(H, W)).astype(np.int32)
    old[rng.random((H, W)) < 0.1] = UNASSIGNED
    flags = dict(manhattan_spatial_dist=manhattan, cand_slots=cand_slots)
    return (planes, st, old, JaxConfig(H=H, W=W, K=K, arch="xla", **flags),
            StaticConfig(H=H, W=W, K=K, **flags))


def _port_state(st):
    return clusters_from_numpy(st.y, st.x, st.r, st.g, st.b, st.num_members,
                               st.is_active, st.is_updatable).to_torch("cpu")


@pytest.mark.parametrize("cand_slots", [16, 4])
def test_build_candidates_matches_jax(rng, cand_slots):
    _, st, _, cfg_j, cfg_t = _inputs(rng, cand_slots=cand_slots)
    cand_j, ovf_j = jpipe.build_candidates(
        jnp.asarray(st.y), jnp.asarray(st.x), jnp.asarray(st.is_active),
        cfg_j)
    t = _port_state(st)
    cand_t, ovf_t = tpipe.build_candidates(t.y, t.x, t.is_active, cfg_t)
    assert cand_t.dtype == torch.int32
    np.testing.assert_array_equal(cand_t.numpy(), np.asarray(cand_j))
    assert bool(ovf_t) == bool(np.asarray(ovf_j))
    if cand_slots == 4:
        assert bool(ovf_t)  # a 3x3 neighbourhood holds more than 4


def test_derive_scalars_match_jax():
    for lab in (True, False):
        for comp, msf in ((10.0, 0.25), (20.0, 0.1), (7.3, 0.0)):
            cj = JaxConfig(H=386, W=620, K=256, convert_to_lab=lab)
            ct = StaticConfig(H=386, W=620, K=256, convert_to_lab=lab)
            sj = jpipe.derive_scalars(cj, comp, msf, 0.05)
            st = tpipe.derive_scalars(ct, comp, msf)
            assert st.coef.dtype == np.float32
            assert st.coef == sj.coef and st.thres == sj.thres


@pytest.mark.parametrize("manhattan", [True, False])
@pytest.mark.parametrize("stride,rem", [(3, 0), (3, 1), (3, 2), (1, 0)])
def test_assign_pass_matches_assign_xla(rng, manhattan, stride, rem):
    planes, st, old, cfg_j, cfg_t = _inputs(rng, manhattan)
    scal = jpipe.derive_scalars(cfg_j, 10.0, 0.25, 0.05)
    stj = jcl.Clusters(*(jnp.asarray(getattr(st, f)) for f in (
        "y", "x", "r", "g", "b", "num_members", "is_active",
        "is_updatable")))
    cand_j, _ = jpipe.build_candidates(stj.y, stj.x, stj.is_active, cfg_j)
    ref = jpipe.assign_xla(jnp.asarray(planes), stj, cand_j, cfg_j,
                           scal.coef, jnp.asarray(old), rem, stride)

    t = _port_state(st)
    cand_t, _ = tpipe.build_candidates(t.y, t.x, t.is_active, cfg_t)
    a = torch.from_numpy(old.copy())
    md = torch.full((H, W), UNASSIGNED, dtype=torch.int32)
    assign(torch.from_numpy(planes), tpipe.center_table(t), cand_t, a,
           tpipe.derive_scalars(cfg_t, 10.0, 0.25).coef, cfg_t.S,
           stride, rem, manhattan, min_dists=md)
    np.testing.assert_array_equal(a.numpy(), np.asarray(ref.assignment))
    np.testing.assert_array_equal(md.numpy(), np.asarray(ref.min_dists))
    # the rows this pass skips keep their old value
    skip = (np.arange(H) % stride) != rem
    np.testing.assert_array_equal(a.numpy()[skip], old[skip])


@pytest.mark.parametrize("manhattan", [True, False])
@pytest.mark.parametrize("stride,rem", [(3, 1), (1, 0)])
@pytest.mark.parametrize("case", ["slots_48", "inactive_patch"])
def test_assign_pass_edge_cases_match_assign_xla(rng, case, manhattan, stride,
                                                 rem):
    # 48 slots (the overflow re-run's width), and cells with no candidate,
    # where the old assignment stays and min_dists reads UNASSIGNED
    planes, st, old, cfg_j, cfg_t = _inputs(
        rng, manhattan, cand_slots=48 if case == "slots_48" else 16,
        inactive_patch=case == "inactive_patch")
    scal = jpipe.derive_scalars(cfg_j, 10.0, 0.25, 0.05)
    stj = jcl.Clusters(*(jnp.asarray(getattr(st, f)) for f in (
        "y", "x", "r", "g", "b", "num_members", "is_active",
        "is_updatable")))
    cand_j, _ = jpipe.build_candidates(stj.y, stj.x, stj.is_active, cfg_j)
    ref = jpipe.assign_xla(jnp.asarray(planes), stj, cand_j, cfg_j,
                           scal.coef, jnp.asarray(old), rem, stride)

    t = _port_state(st)
    cand_t, _ = tpipe.build_candidates(t.y, t.x, t.is_active, cfg_t)
    assert cand_t.shape[-1] == cfg_t.cand_slots
    a = torch.from_numpy(old.copy())
    md = torch.full((H, W), UNASSIGNED, dtype=torch.int32)
    assign(torch.from_numpy(planes), tpipe.center_table(t), cand_t, a,
           tpipe.derive_scalars(cfg_t, 10.0, 0.25).coef, cfg_t.S,
           stride, rem, manhattan, min_dists=md)
    np.testing.assert_array_equal(a.numpy(), np.asarray(ref.assignment))
    np.testing.assert_array_equal(md.numpy(), np.asarray(ref.min_dists))
    if case == "inactive_patch":
        assert bool((cand_t[0, 0] < 0).all())
        rows = np.arange(rem, cfg_t.S, stride)
        assert (md.numpy()[rows, :cfg_t.S] == UNASSIGNED).all()
        np.testing.assert_array_equal(a.numpy()[rows, :cfg_t.S],
                                      old[rows, :cfg_t.S])


@pytest.mark.parametrize("stride,rem", [(3, 1), (1, 0)])
def test_assign_pass_matches_pallas_interpret(rng, stride, rem):
    planes, st, old, _, cfg_t = _inputs(rng)
    cfg_p = JaxConfig(H=H, W=W, K=K, arch="pallas", debug_mode=True)
    scal = jpipe.derive_scalars(cfg_p, 10.0, 0.25, 0.05)
    stj = jcl.Clusters(*(jnp.asarray(getattr(st, f)) for f in (
        "y", "x", "r", "g", "b", "num_members", "is_active",
        "is_updatable")))
    cand_j, _ = jpipe.build_candidates(stj.y, stj.x, stj.is_active, cfg_p)
    p_j = jnp.asarray(planes)
    p3 = jpipe._pad_planes_for_pallas(p_j, cfg_p)
    ref = jpipe.assign_dispatch(p_j, p3, stj, cand_j, cfg_p, scal.coef,
                                jnp.asarray(old), rem, stride)

    t = _port_state(st)
    cand_t, _ = tpipe.build_candidates(t.y, t.x, t.is_active, cfg_t)
    a = torch.from_numpy(old.copy())
    md = torch.full((H, W), UNASSIGNED, dtype=torch.int32)
    assign(torch.from_numpy(planes), tpipe.center_table(t), cand_t, a,
           scal.coef, cfg_t.S, stride, rem, True, min_dists=md)
    np.testing.assert_array_equal(a.numpy(), np.asarray(ref.assignment))
    wrote = np.broadcast_to(((np.arange(H) % stride) == rem)[:, None],
                            (H, W))
    np.testing.assert_array_equal(md.numpy()[wrote],
                                  np.asarray(ref.min_dists)[wrote])


def test_assign_wrapper_validates(rng):
    planes, st, old, _, cfg_t = _inputs(rng)
    t = _port_state(st)
    cand_t, _ = tpipe.build_candidates(t.y, t.x, t.is_active, cfg_t)
    a = torch.from_numpy(old)
    with pytest.raises(ValueError):
        assign(torch.from_numpy(planes), tpipe.center_table(t), cand_t, a,
               1.0, cfg_t.S, 3, 3)           # rem must be < stride
    with pytest.raises(ValueError):
        assign(torch.from_numpy(planes[:, :-1]), tpipe.center_table(t),
               cand_t, a, 1.0, cfg_t.S, 1, 0)  # planes shape
