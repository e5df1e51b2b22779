"""PyTorch port: the device mesh against the JAX package and against the
port's single-device path, on the CPU.

* ``propagate_min_plain`` (and its dispatch) over the regions' roots
  equals the JAX ``propagate_min_pallas`` in interpret mode on
  seeded 24x40 maps: random labels, a serpentine region, a seed that is
  _BIG except at a few pixels;
* the sharded CCA's halo propagation (``_halo_propagate`` over region
  tables) on D = 2, 4 and 8 row shards equals ``propagate_min_pallas`` over
  the joined image, with the pixel-id and the leader-rank seed, on random
  labels and on a column serpentine that crosses every seam many times;
  its rounds touch only edge rows, and a propagation makes one pass over
  each slab (the final gather), also inside ``ShardedSlicExplicit``;
* ``make_mesh``: shapes, the JAX package's ValueError, and no GPU -> error;
* ``ShardedSlicExplicit`` (every variant, preemptive, a warm start carried
  and one set through ``state``), ``ShardedSlic`` and ``BatchedSlic(mesh=
  data 4, space 2)`` on 8 CPU shards equal the JAX classes' labels and
  cluster states in tests/data/port_mesh_ref.npz (written by
  scripts/make_port_fixture_mesh.py; LSC agrees >= 0.99 and its figure is
  printed); one standard case runs the JAX class live;
* the sharded classes equal the port's single-device classes at shapes
  where a slab holds neither whole cells nor whole stride periods, and
  through the tie escalation;
* ``H % D`` and the LSC window raise;
* no tensor of Hl*W elements or more crosses shards except one-row halos
  and the escalation's gather (the analog of the JAX package's
  test_explicit_spatial_uses_ppermute_not_allgather).
"""

import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fast_slic_tpu.pallas.cca_tpu import propagate_min_pallas
from fast_slic_tpu_torch import (Slic, SlicRealDist, SlicRealDistL2,
                                 SlicRealDistNoQ)
from fast_slic_tpu_torch.kernels import cca
from fast_slic_tpu_torch.kernels.cca import (connected_components_plain,
                                             propagate_min,
                                             propagate_min_plain,
                                             region_table_plain)
from fast_slic_tpu_torch.parallel import spatial_shardmap as ssm
from fast_slic_tpu_torch.parallel.batch import BatchedSlic
from fast_slic_tpu_torch.parallel.mesh import Mesh, make_mesh
from fast_slic_tpu_torch.parallel.spatial import ShardedSlic
from fast_slic_tpu_torch.parallel.spatial_shardmap import ShardedSlicExplicit
from fast_slic_tpu_torch.utils.timing import COUNTS
from torch_threads import one_torch_thread  # noqa: F401

REF = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                   "port_mesh_ref.npz")
FIELDS = ("y", "x", "r", "g", "b", "num_members", "is_active",
          "is_updatable")
K, MSF = 9, 0.1
CPU = torch.device("cpu")
_BIG = 0x7FFFFFFF


@pytest.fixture(scope="module")
def ref():
    return np.load(REF)


def _cpu_mesh(data=1, space=8):
    return make_mesh(devices=[CPU] * (data * space), data=data, space=space)


def _assert_state(st, ref, name):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(st, f), ref[name + "_" + f],
                                      err_msg="%s.%s" % (name, f))


# -- propagate_min ---------------------------------------------------------

def _serpentine(H, W):
    """One region of label 1 winding down the rows, in label 0."""
    lab = np.zeros((H, W), np.int32)
    lab[::4] = 1
    for i, r in enumerate(range(1, H - 1, 4)):
        lab[r:r + 3, W - 1 if i % 2 == 0 else 0] = 1
    return lab


@pytest.mark.parametrize("case", ["random", "serpentine", "sparse_seed"])
def test_propagate_min_matches_jax(case):
    rng = np.random.default_rng({"random": 0, "serpentine": 1,
                                 "sparse_seed": 2}[case])
    H, W = 24, 40
    if case == "serpentine":
        lab = _serpentine(H, W)
    else:
        lab = rng.integers(0, 3, size=(H, W)).astype(np.int32)
    if case == "sparse_seed":
        m0 = np.full((H, W), _BIG, np.int32)
        idx = rng.choice(H * W, size=6, replace=False)
        m0.reshape(-1)[idx] = rng.integers(0, 1000, size=6)
    else:
        m0 = rng.integers(0, 100000, size=(H, W)).astype(np.int32)
    want = np.asarray(propagate_min_pallas(jnp.asarray(lab),
                                           jnp.asarray(m0), interpret=True))
    m0_t = torch.from_numpy(m0)
    roots = connected_components_plain(torch.from_numpy(lab))
    np.testing.assert_array_equal(propagate_min_plain(m0_t, roots).numpy(),
                                  want)
    np.testing.assert_array_equal(propagate_min(m0_t, roots).numpy(), want)
    if case == "serpentine":
        assert len(np.unique(want[lab == 1])) == 1


# -- the sharded CCA's halo propagation -------------------------------------

def _columns(H, W):
    """Label 1 in every fourth column, neighbouring columns joined at the
    bottom and top rows in turn: one region that crosses every row seam
    W/4 times, in label 0."""
    lab = np.zeros((H, W), np.int32)
    lab[:, ::4] = 1
    for i, c in enumerate(range(0, W - 4, 4)):
        lab[H - 1 if i % 2 == 0 else 0, c:c + 5] = 1
    return lab


@functools.lru_cache(maxsize=None)
def _jax_region_minima(case):
    """(labels [48, 40], the JAX package's region minimum of the pixel ids,
    of the leader ranks (the CCA's second seed)) over the whole image."""
    H, W = 48, 40
    lab = (_columns(H, W) if case == "columns" else
           np.random.default_rng(5).integers(0, 3, size=(H, W))
           .astype(np.int32))
    ids = np.arange(H * W, dtype=np.int32).reshape(H, W)
    first = np.asarray(propagate_min_pallas(jnp.asarray(lab),
                                            jnp.asarray(ids), interpret=True))
    leaders = first == ids
    ranks = np.where(leaders, np.cumsum(leaders).reshape(H, W) - 1,
                     _BIG).astype(np.int32)
    second = np.asarray(propagate_min_pallas(
        jnp.asarray(lab), jnp.asarray(ranks), interpret=True))
    return lab, {"pixel_ids": (ids, first), "ranks": (ranks, second)}


@pytest.mark.parametrize("seed", ["pixel_ids", "ranks"])
@pytest.mark.parametrize("D", [2, 4, 8])
@pytest.mark.parametrize("case", ["columns", "random"])
def test_halo_propagate_matches_jax(monkeypatch, case, D, seed):
    lab, seeds = _jax_region_minima(case)
    m0, want = seeds[seed]
    H, W = lab.shape
    Hl = H // D
    labs = [torch.from_numpy(lab[d * Hl:(d + 1) * Hl].copy())
            for d in range(D)]
    roots = [connected_components_plain(x) for x in labs]
    # the sharded CCA passes both seeds as their own region tables: they
    # agree with the built tables at every root
    tables = []
    for d, r in enumerate(roots):
        slab = torch.from_numpy(m0[d * Hl:(d + 1) * Hl].copy())
        at = r.reshape(-1).long()
        np.testing.assert_array_equal(region_table_plain(slab, r)[at],
                                      slab.reshape(-1)[at])
        tables.append(slab.reshape(-1))
    gathered, seams = [], []

    def lookup(ids, table):
        gathered.append(ids.numel())
        return cca.lookup(ids, table)

    def seam_min(table, roots_row, *rest):
        seams.append(roots_row.numel())
        return cca.seam_min(table, roots_row, *rest)

    monkeypatch.setattr(ssm, "lookup", lookup)
    monkeypatch.setattr(ssm, "seam_min", seam_min)
    rounds = []
    got = ssm._halo_propagate(_cpu_mesh(space=D), labs, tables, roots,
                              rounds)
    np.testing.assert_array_equal(np.concatenate([g.numpy() for g in got]),
                                  want)
    # each round gathers two rows a shard and lowers across each seam from
    # both sides; the one pass over a slab is the final gather
    (n,) = rounds
    assert gathered == [2 * W] * (D * n) + [Hl * W] * D
    assert seams == [W] * (2 * (D - 1) * n)
    if case == "columns":   # the region walks the seams column by column
        assert n > W // 4


@pytest.mark.parametrize("preemptive", [False, True])
def test_one_slab_pass_a_propagation(monkeypatch, image_factory, preemptive):
    """Inside ShardedSlicExplicit the CCA gathers a whole slab three times
    a shard (each propagation's result and the relabel) and calls no
    per-pixel region minimum."""
    H, W, D = 64, 64, 8
    sizes = []

    def lookup(ids, table):
        sizes.append(ids.numel())
        return cca.lookup(ids, table)

    monkeypatch.setattr(ssm, "lookup", lookup)
    assert not hasattr(ssm, "propagate_min")
    sh = ShardedSlicExplicit(num_components=K, min_size_factor=MSF,
                             preemptive=preemptive, mesh=_cpu_mesh(space=D))
    sh.iterate(image_factory(H, W), max_iter=3)
    slab = (H // D) * W
    assert len(sh.last_seam_rounds) == 2
    assert sorted(set(sizes)) == [2 * W, slab]
    assert sizes.count(slab) == 3 * D
    assert sizes.count(2 * W) == D * sum(sh.last_seam_rounds)


# -- make_mesh -------------------------------------------------------------

def test_make_mesh_shapes_and_errors(monkeypatch):
    devs = [CPU] * 8
    for kw, shape in (({}, (8, 1)), ({"space": 8}, (1, 8)),
                      ({"data": 4}, (4, 2)), ({"data": 2, "space": 4},
                                              (2, 4))):
        m = make_mesh(devices=devs, **kw)
        assert (m.shape["data"], m.shape["space"]) == shape
        assert m.devices.shape == shape
    m = make_mesh(4, devices=devs, data=1)
    assert m.shape == {"data": 1, "space": 4}
    assert m.axis_devices("space") == [CPU] * 4
    with pytest.raises(ValueError):
        make_mesh(devices=devs, data=3, space=2)
    with pytest.raises(ValueError):
        make_mesh(16, devices=devs)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="GPU"):
        make_mesh()
    with pytest.raises(RuntimeError):
        ShardedSlicExplicit(num_components=K)


def test_mesh_collectives():
    m = _cpu_mesh(space=3)
    parts = [torch.full((2,), d + 1) for d in range(3)]
    up = m.ppermute(parts, up=True)
    down = m.ppermute(parts, up=False)
    assert [t.tolist() for t in up] == [[0, 0], [1, 1], [2, 2]]
    assert [t.tolist() for t in down] == [[2, 2], [3, 3], [0, 0]]
    assert m.psum(parts).tolist() == [6, 6]
    assert m.all_gather([t[0] for t in parts]).tolist() == [1, 2, 3]
    assert m.gather(parts).tolist() == [1, 1, 2, 2, 3, 3]
    assert [t.tolist() for t in m.broadcast(parts[0])] == [[1, 1]] * 3
    # bytes that crossed shards: 2 halos of 2, 2 sums, 2 gathered scalars,
    # 2 gathered and 2 broadcast pairs of int64
    assert m.bytes_moved == 8 * (2 * 2 * 2 + 2 * 2 + 2 + 2 * 2 + 2 * 2)


# -- against the JAX classes (fixture) --------------------------------------

@pytest.mark.parametrize("variant", ["standard", "real", "real_l2",
                                     "real_noq"])
def test_explicit_variants_match_jax(ref, variant):
    sh = ShardedSlicExplicit(num_components=K, min_size_factor=MSF,
                             variant=variant, mesh=_cpu_mesh())
    labels = sh.iterate(ref["image"], max_iter=3)
    assert labels.dtype == np.int16
    np.testing.assert_array_equal(labels, ref["x_%s_labels" % variant])
    _assert_state(sh.state, ref, "x_" + variant)


def test_explicit_lsc_agrees_with_jax(ref):
    sh = ShardedSlicExplicit(num_components=K, min_size_factor=MSF,
                             variant="lsc", mesh=_cpu_mesh())
    labels = sh.iterate(ref["image"], max_iter=3)
    agree = float((labels == ref["x_lsc_labels"]).mean())
    print("sharded LSC label agreement with the JAX package: %r" % agree)
    assert agree >= 0.99


def test_explicit_preemptive_matches_jax(ref):
    sh = ShardedSlicExplicit(num_components=K, min_size_factor=MSF,
                             preemptive=True, mesh=_cpu_mesh())
    np.testing.assert_array_equal(sh.iterate(ref["image"], max_iter=4),
                                  ref["x_preemptive_labels"])
    _assert_state(sh.state, ref, "x_preemptive")


@pytest.mark.parametrize("start", ["carried", "state_setter"])
def test_explicit_warm_start_matches_jax(ref, start):
    sh = ShardedSlicExplicit(num_components=K, min_size_factor=MSF,
                             mesh=_cpu_mesh())
    if start == "carried":
        np.testing.assert_array_equal(sh.iterate(ref["image"], max_iter=2),
                                      ref["warm1_labels"])
    else:
        class St:  # the JAX object's state, as the fixture holds it
            pass
        st = St()
        for f in FIELDS:
            setattr(st, f, ref["warm1_" + f])
        sh.state = st
    np.testing.assert_array_equal(sh.iterate(ref["image"], max_iter=2),
                                  ref["warm2_labels"])
    _assert_state(sh.state, ref, "warm2")


@pytest.mark.parametrize("name,kw", [("s_standard", {}),
                                     ("s_preemptive", {"preemptive": True})])
def test_sharded_slic_matches_jax(ref, name, kw):
    sh = ShardedSlic(num_components=K, min_size_factor=MSF,
                     mesh=_cpu_mesh(), **kw)
    labels = sh.iterate(ref["image"], max_iter=3)
    assert labels.dtype == np.int16
    np.testing.assert_array_equal(labels, ref[name + "_labels"])
    _assert_state(sh.state, ref, name)


@pytest.mark.parametrize("mode", ["map", "stack"])
def test_batched_mesh_matches_jax(ref, mode):
    bs = BatchedSlic(num_components=K, min_size_factor=MSF,
                     mesh=_cpu_mesh(data=4, space=2), batch_mode=mode)
    labels = bs.iterate(ref["frames"], max_iter=3)
    assert labels.dtype == torch.int32 and labels.device == CPU
    np.testing.assert_array_equal(labels.numpy(), ref["b_%s_labels" % mode])
    _assert_state(bs.state, ref, "b_" + mode)
    assert tuple(bs.last_flags.shape) == (4,)
    with pytest.raises(ValueError, match="data axis"):
        bs.iterate(ref["frames"][:3], max_iter=3)


def test_explicit_matches_jax_live(image_factory):
    from fast_slic_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from fast_slic_tpu.parallel.spatial_shardmap import (
        ShardedSlicExplicit as JaxExplicit)
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 JAX devices")
    img = image_factory(48, 64)
    want = JaxExplicit(num_components=12, min_size_factor=0.2,
                       mesh=jax_make_mesh(8, data=1, space=8)).iterate(
                           img, max_iter=4)
    got = ShardedSlicExplicit(num_components=12, min_size_factor=0.2,
                              mesh=_cpu_mesh()).iterate(img, max_iter=4)
    np.testing.assert_array_equal(got, np.asarray(want))


# -- against the port's single-device path ----------------------------------

@pytest.mark.parametrize("cls,kw", [
    (Slic, {}), (SlicRealDist, {}), (SlicRealDistL2, {}),
    (SlicRealDistNoQ, {}), (Slic, {"preemptive": True})])
def test_sharded_matches_single_device(image_factory, cls, kw):
    """100x80 at K=16 (S=22) over 4 shards: 25 rows a slab, so a slab holds
    neither whole cells nor whole stride periods; two warm frames."""
    variant = {Slic: "standard", SlicRealDist: "real",
               SlicRealDistL2: "real_l2", SlicRealDistNoQ: "real_noq"}[cls]
    sh = ShardedSlicExplicit(num_components=16, variant=variant,
                             mesh=_cpu_mesh(space=4), **kw)
    single = cls(num_components=16, device="cpu", **kw)
    for _ in range(2):
        img = image_factory(100, 80)
        np.testing.assert_array_equal(sh.iterate(img, max_iter=5),
                                      single.iterate(img, max_iter=5))
    yxm = single.slic_model.to_yxmrgb()
    st = sh.state
    np.testing.assert_array_equal(st.y, yxm[:, 0])
    np.testing.assert_array_equal(st.x, yxm[:, 1])
    np.testing.assert_array_equal(st.num_members, yxm[:, 2])


@pytest.mark.parametrize("cls", [ShardedSlicExplicit, ShardedSlic])
def test_tie_escalation_gathers_once(monkeypatch, image_factory, cls):
    """A flagged tie takes the exact CCA on the gathered raw assignment:
    the labels stay the single-device ones."""
    real = ssm._substitutes

    def tied(*a, **kw):
        sub, _ = real(*a, **kw)
        return sub, torch.tensor(True)

    monkeypatch.setattr(ssm, "_substitutes", tied)
    img = image_factory(64, 48)
    sh = cls(num_components=12, mesh=_cpu_mesh(space=4))
    got = sh.iterate(img, max_iter=3)
    assert sh.last_tie
    np.testing.assert_array_equal(got, Slic(num_components=12,
                                            device="cpu").iterate(img, 3))


@pytest.mark.parametrize("cls", [ShardedSlicExplicit, ShardedSlic])
def test_candidate_overflow_escalation(monkeypatch, image_factory, cls):
    """A shard's overflow flag (forced here below 48 slots) re-runs
    ShardedSlicExplicit from its state with 48 slots; ShardedSlic re-runs
    the image on one device through the runner.  Both give the single
    device's labels and state, and carry the kept run's 48 slots: the next
    image runs once, its shards at 48."""
    real = ssm.pipeline.build_candidates
    slots = []

    def full(y, x, act, cfg, key=None, overflow=None):
        cand, ovf = real(y, x, act, cfg, key, overflow)
        slots.append(cfg.cand_slots)
        return cand, ovf | (cfg.cand_slots < 48)

    monkeypatch.setattr(ssm.pipeline, "build_candidates", full)
    img = image_factory(64, 48)
    sh = cls(num_components=12, mesh=_cpu_mesh(space=4))
    got = sh.iterate(img, 3)
    if cls is ShardedSlicExplicit:   # the shards' lists: 2x the slots
        assert sh.last_reruns == 1 and sorted(set(slots)) == [32, 48]
    single = Slic(num_components=12, device="cpu")
    np.testing.assert_array_equal(got, single.iterate(img, 3))
    np.testing.assert_array_equal(sh.state.y,
                                  single.slic_model.to_yxmrgb()[:, 0])
    slots.clear()
    got = sh.iterate(img, 3)
    assert set(slots) == {48} and sh.last_reruns == 0
    np.testing.assert_array_equal(got, single.iterate(img, 3))
    np.testing.assert_array_equal(sh.state.y,
                                  single.slic_model.to_yxmrgb()[:, 0])


def test_handoff_carries_the_shards_rerun(monkeypatch, image_factory):
    """Lists that overflow in the shards only (32 slots, forced here) hand
    the image to the runner, whose 16-slot run equals the single device's;
    the hand-off is one re-run, and the next image's shards start at 48
    and run once, with no hand-off."""
    real = ssm.pipeline.build_candidates
    slots = []

    def shards_full(y, x, act, cfg, key=None, overflow=None):
        cand, ovf = real(y, x, act, cfg, key, overflow)
        slots.append(cfg.cand_slots)
        return cand, ovf | (cfg.cand_slots == 32)

    monkeypatch.setattr(ssm.pipeline, "build_candidates", shards_full)
    img = image_factory(64, 48)
    sh = ShardedSlic(num_components=12, mesh=_cpu_mesh(space=4))
    single = Slic(num_components=12, device="cpu")
    for t, runs in enumerate(([16, 32], [48])):
        slots.clear()
        before = COUNTS["runner.reruns"]
        got = sh.iterate(img, 3)
        assert sorted(set(slots)) == runs, t
        assert COUNTS["runner.reruns"] - before == (t == 0), t
        np.testing.assert_array_equal(got, single.iterate(img, 3))
        np.testing.assert_array_equal(sh.state.y,
                                      single.slic_model.to_yxmrgb()[:, 0])


def test_rows_and_lsc_window_raise(image_factory):
    sh = ShardedSlicExplicit(num_components=K, mesh=_cpu_mesh())
    with pytest.raises(ValueError, match="divide"):
        sh.iterate(image_factory(60, 64), max_iter=2)
    lsc = ShardedSlicExplicit(num_components=4, variant="lsc",
                              mesh=_cpu_mesh())
    with pytest.raises(ValueError, match="S/4"):
        lsc.iterate(image_factory(64, 64), max_iter=2)


# -- what crosses shards ----------------------------------------------------

@pytest.mark.parametrize("preemptive", [False, True])
def test_only_halos_and_small_tables_cross_shards(monkeypatch, image_factory,
                                                  preemptive):
    H, W, D = 64, 64, 8
    seen = []

    def wrap(name):
        real = getattr(Mesh, name)

        def spy(self, parts, *a, **kw):
            ts = [parts] if name == "broadcast" else list(parts)
            seen.append((name, [tuple(t.shape) for t in ts]))
            return real(self, parts, *a, **kw)
        return spy

    for name in ("ppermute", "psum", "all_gather", "broadcast", "gather"):
        monkeypatch.setattr(Mesh, name, wrap(name))
    sh = ShardedSlicExplicit(num_components=K, min_size_factor=MSF,
                             preemptive=preemptive, mesh=_cpu_mesh())
    sh.iterate(image_factory(H, W), max_iter=3)
    assert {n for n, _ in seen} >= {"ppermute", "psum", "all_gather",
                                    "broadcast"}
    pixel = (H // D) * W
    for name, shapes in seen:
        assert name != "gather", "a gather without an escalation"
        for s in shapes:
            if name == "ppermute":
                assert s[-2:] == (1, W), (name, s)   # one-row halos
            else:
                assert int(np.prod(s)) < pixel, (name, s)
    assert sh.last_seam_rounds and min(sh.last_seam_rounds) >= 2
