"""PyTorch port: batched frames against the JAX package and against the
port's single-frame path.

The same inputs, made with numpy from a seed, go through both packages
(plain versions on the CPU).  Exact throughout:

* ``build_candidates_batched`` equals the JAX one and the per-frame build;
* ``framed_segment_sum_plain`` equals ``framed_segment_sum_pallas`` in
  interpret mode;
* the frame-mode plain ``assign``, ``assign_float`` and ``slic_update``
  equal per-frame single calls;
* the framed CCA equals per-frame ``enforce_connectivity_flagged``, with
  UNASSIGNED regions touching across a frame boundary and a top-K tie;
* ``iterate_graph_stacked`` equals the JAX ``iterate_graph_stacked`` frame
  by frame at the size of tests/test_stack.py;
* ``BatchedSlic``: stack == map == per-frame ``Slic`` over two batches
  (warm start), ``iterate_async``/``resolve`` == ``iterate``,
  ``check_exactness=False``, the state from the JAX ``BatchedSlic``,
  canvas runs stack, LSC stacks by map, ``mesh=`` raises.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fast_slic_tpu import cluster as jcl
from fast_slic_tpu import pipeline as jpipe
from fast_slic_tpu.config import StaticConfig as JaxConfig
from fast_slic_tpu.pallas.segsum_tpu import framed_segment_sum_pallas
from fast_slic_tpu.parallel import stack as jstack
from fast_slic_tpu.parallel.batch import BatchedSlic as JaxBatchedSlic
from fast_slic_tpu_torch import Slic, SlicRealDist, pipeline as tpipe
from fast_slic_tpu_torch import cluster as tcl
from fast_slic_tpu_torch.config import UNASSIGNED, StaticConfig
from fast_slic_tpu_torch.kernels import assign, assign_float, segsum
from fast_slic_tpu_torch.ops.cca import (enforce_connectivity_flagged,
                                         enforce_connectivity_framed_flagged)
from fast_slic_tpu_torch.parallel import batch as tbatch
from fast_slic_tpu_torch.parallel import stack as tstack

B, H, W, K = 3, 96, 128, 24
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


def _frames(image_factory, n=B):
    return np.stack([image_factory(H, W) for _ in range(n)])


def _jax_states(frames, k=K):
    sts = [jcl.initialize_clusters(f, k) for f in frames]
    return jax.tree.map(lambda *xs: jnp.stack(xs), *sts)


def _to_torch(st):
    return tcl.clusters_from_numpy(*(np.asarray(getattr(st, f))
                                     for f in FIELDS)).to_torch("cpu")


def _jittered(rng, frames, k=K):
    """[B, K] states with centres moved off the seeding grid, a few
    inactive clusters."""
    st = jax.tree.map(np.asarray, _jax_states(frames, k))
    shape = st.y.shape
    return jcl.Clusters(
        y=np.clip(st.y + rng.uniform(-9, 9, shape), 0, H - 1).astype(
            np.float32),
        x=np.clip(st.x + rng.uniform(-9, 9, shape), 0, W - 1).astype(
            np.float32),
        r=st.r, g=st.g, b=st.b, num_members=st.num_members,
        is_active=(rng.random(shape) < 0.9).astype(np.int32),
        is_updatable=st.is_updatable)


@pytest.mark.parametrize("k,slots", [(K, 16), (120, 16), (120, 4)])
def test_batched_candidates_match_jax_and_single(rng, image_factory, k,
                                                 slots):
    st = _jittered(rng, _frames(image_factory), k)
    cfg_j = JaxConfig(H=H, W=W, K=k, arch="xla", cand_slots=slots)
    cand_j, ovf_j = jstack.build_candidates_batched(
        jnp.asarray(st.y), jnp.asarray(st.x), jnp.asarray(st.is_active),
        cfg_j)
    cfg_t = StaticConfig(H=H, W=W, K=k, cand_slots=slots)
    t = _to_torch(st)
    cand_t, ovf_t = tstack.build_candidates_batched(t.y, t.x, t.is_active,
                                                    cfg_t)
    np.testing.assert_array_equal(cand_t.numpy(), np.asarray(cand_j))
    assert bool(ovf_t) == bool(ovf_j)
    ovf_any = False
    for f in range(B):
        cand_f, ovf_f = tpipe.build_candidates(t.y[f], t.x[f],
                                               t.is_active[f], cfg_t)
        np.testing.assert_array_equal(cand_t[f].numpy(), cand_f.numpy())
        ovf_any |= bool(ovf_f)
    assert ovf_any == bool(ovf_t)


@pytest.mark.parametrize("coherent", [True, False])
def test_framed_segment_sum_matches_pallas_interpret(rng, coherent):
    nb, Nf, V, MF = 3, 5000, 4, 300
    ids = rng.integers(0, MF, size=(nb, Nf)).astype(np.int32)
    if coherent:  # CCA component ids grow with pixel position
        ids = np.sort(ids, axis=1)
    vals = rng.integers(0, 1 << 16, size=(V, nb, Nf)).astype(np.int32)
    ref = np.asarray(framed_segment_sum_pallas(
        jnp.asarray(ids), jnp.asarray(vals), MF, interpret=True))
    got = segsum.framed_segment_sum(torch.from_numpy(ids),
                                    torch.from_numpy(vals), MF)
    assert got.dtype == torch.int32 and tuple(got.shape) == (nb, V, MF)
    np.testing.assert_array_equal(got.numpy(), ref)


def _frame_inputs(rng, image_factory, variant):
    frames = _frames(image_factory)
    st = _to_torch(_jittered(rng, frames))
    cfg = StaticConfig(H=H, W=W, K=K, variant=variant)
    scal = tpipe.derive_scalars(cfg, 10.0, 0.25)
    planes, st, _ = tpipe.stage_setup(torch.from_numpy(frames), st, cfg,
                                      scal)
    cand, _ = tpipe.build_candidates_batched(st.y, st.x, st.is_active, cfg)
    old = torch.from_numpy(rng.integers(0, K, size=(B, H, W)).astype(
        np.int32))
    return cfg, scal, planes, tpipe.center_table(st), cand, old


@pytest.mark.parametrize("variant", ["standard", "real", "real_l2",
                                     "real_noq"])
@pytest.mark.parametrize("stride,rem", [(3, 1), (1, 0)])
def test_frame_mode_assign_matches_single(rng, image_factory, variant,
                                          stride, rem):
    cfg, scal, planes, table, cand, old = _frame_inputs(rng, image_factory,
                                                        variant)

    def run(p, tb, c, a, md):
        if variant == "standard":
            return assign.assign(p, tb, c, a, scal.coef, cfg.S, stride, rem,
                                 True, md)
        return assign_float.assign_float(p, tb, c, a, scal.coef, cfg.S,
                                         stride, rem, variant, True, md)

    dt = torch.int32 if variant == "standard" else torch.float32
    a_b, md_b = old.clone(), torch.zeros((B, H, W), dtype=dt)
    run(planes, table, cand, a_b, md_b)
    for f in range(B):
        a_f, md_f = old[f].clone(), torch.zeros((H, W), dtype=dt)
        run(planes[:, f].contiguous(), table[f], cand[f], a_f, md_f)
        np.testing.assert_array_equal(a_b[f].numpy(), a_f.numpy())
        np.testing.assert_array_equal(md_b[f].numpy(), md_f.numpy())


@pytest.mark.parametrize("stride,rem", [(3, 0), (3, 2), (1, 0)])
def test_frame_mode_updates_match_single(rng, stride, rem):
    a = rng.integers(0, K, size=(B, H, W)).astype(np.int32)
    a[rng.random((B, H, W)) < 0.05] = UNASSIGNED
    a = torch.from_numpy(a)
    planes = torch.from_numpy(rng.integers(0, 256, size=(3, B, H, W)).astype(
        np.int32))
    mask = torch.from_numpy(rng.random((B, H, W)) < 0.5)
    got = segsum.slic_update(a, planes, K, stride, rem)
    got_m = segsum.slic_update_masked(a, planes, mask, K, stride, rem)
    assert tuple(got.shape) == tuple(got_m.shape) == (6, B * K)
    for f in range(B):
        np.testing.assert_array_equal(
            got[:, f * K:(f + 1) * K].numpy(),
            segsum.slic_update(a[f], planes[:, f], K, stride, rem).numpy())
        np.testing.assert_array_equal(
            got_m[:, f * K:(f + 1) * K].numpy(),
            segsum.slic_update_masked(a[f], planes[:, f], mask[f], K, stride,
                                      rem).numpy())


def _cca_frames(rng):
    """Four 24x32 label maps with labels in [0, 12): blocky random labels;
    UNASSIGNED along the bottom rows of frame 1 and the top rows of frame 2
    (they touch across the frame boundary); 48 equal 4x4 blocks, no two
    equal neighbours, more than K components of one area, so the areas tie
    at the top-K boundary (frame 3)."""
    h, w = 24, 32
    fr = [rng.integers(0, 12, size=(h // 4, w // 4)).repeat(4, 0).repeat(
        4, 1) for _ in range(3)]
    fr[0][rng.random((h, w)) < 0.05] = 7
    fr[1][-3:, 5:20] = UNASSIGNED
    fr[1][10:12, 3:9] = UNASSIGNED
    fr[2][:2, 0:25] = UNASSIGNED
    tie = (np.arange(48) % 12).reshape(6, 8).repeat(4, 0).repeat(4, 1)
    return np.stack(fr + [tie]).astype(np.int32)


@pytest.mark.parametrize("k,thres", [(40, 4), (12, 0), (40, 20)])
def test_framed_cca_matches_single(rng, k, thres):
    a = _cca_frames(rng)
    labels, tie = enforce_connectivity_framed_flagged(torch.from_numpy(a), k,
                                                      thres)
    assert labels.dtype == torch.int32 and tie.shape == (a.shape[0],)
    for f in range(a.shape[0]):
        ref, ref_tie = enforce_connectivity_flagged(torch.from_numpy(a[f]), k,
                                                    thres)
        np.testing.assert_array_equal(labels[f].numpy(), ref.numpy(),
                                      err_msg="frame %d" % f)
        assert bool(tie[f]) == bool(ref_tie), f
    if (k, thres) == (40, 4):
        assert bool(tie[3]) and not bool(tie[0])


@pytest.mark.parametrize("variant,preemptive", [("standard", False),
                                                ("standard", True),
                                                ("real_noq", False)])
def test_iterate_graph_stacked_matches_jax(image_factory, variant,
                                           preemptive):
    stride, max_iter = 3, 4
    frames = _frames(image_factory)
    st = _jax_states(frames)
    cfg_j = JaxConfig(H=H, W=W, K=K, arch="pallas", variant=variant,
                      preemptive=preemptive)
    scal_j = jpipe.derive_scalars(cfg_j, 10.0, 0.1, 0.3)
    out_j = jstack.iterate_graph_stacked(jnp.asarray(frames), st, cfg_j,
                                         scal_j, max_iter, stride)

    cfg_t = StaticConfig(H=H, W=W, K=K, variant=variant,
                         preemptive=preemptive)
    scal_t = tpipe.derive_scalars(cfg_t, 10.0, 0.1, 0.3)
    out_t = tstack.iterate_graph_stacked(torch.from_numpy(frames),
                                         _to_torch(st), cfg_t, scal_t,
                                         max_iter, stride)
    np.testing.assert_array_equal(out_t.raw_assignment.numpy(),
                                  np.asarray(out_j.raw_assignment))
    np.testing.assert_array_equal(out_t.labels.numpy(),
                                  np.asarray(out_j.labels))
    np.testing.assert_array_equal(out_t.cca_tie.numpy(),
                                  np.asarray(out_j.cca_tie))
    assert bool(out_t.cand_overflow) == bool(out_j.cand_overflow)
    got = out_t.clusters.as_numpy()
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f),
                                      np.asarray(getattr(out_j.clusters, f)),
                                      err_msg=f)


def _batched(**kw):
    return tbatch.BatchedSlic(num_components=K, compactness=10.0,
                              min_size_factor=0.1, device="cpu", **kw)


@pytest.mark.parametrize("variant", ["standard", "real"])
def test_batched_stack_map_and_single_agree(image_factory, variant):
    batches = [_frames(image_factory) for _ in range(2)]
    stack = _batched(variant=variant, batch_mode="stack")
    mapped = _batched(variant=variant, batch_mode="map")
    cls = {"standard": Slic, "real": SlicRealDist}[variant]
    singles = [cls(num_components=K, compactness=10.0, min_size_factor=0.1,
                   device="cpu") for _ in range(B)]
    for frames in batches:
        ls = stack.iterate(frames, max_iter=4)
        lm = mapped.iterate(frames, max_iter=4)
        assert ls.dtype == torch.int32 and tuple(ls.shape) == (B, H, W)
        np.testing.assert_array_equal(ls.numpy(), lm.numpy())
        for f in range(B):
            np.testing.assert_array_equal(
                ls[f].numpy(), singles[f].iterate(frames[f], max_iter=4))
    st_s, st_m = stack.state, mapped.state
    for f, s in enumerate(singles):
        yxm = s.slic_model.to_yxmrgb()
        np.testing.assert_array_equal(st_s.y[f], yxm[:, 0])
        np.testing.assert_array_equal(st_s.x[f], yxm[:, 1])
        np.testing.assert_array_equal(st_s.num_members[f], yxm[:, 2])
    for fld in FIELDS:
        np.testing.assert_array_equal(getattr(st_s, fld), getattr(st_m, fld))


def test_batched_matches_jax_batched_slic(image_factory):
    frames = _frames(image_factory)
    ref = JaxBatchedSlic(num_components=K, compactness=10.0,
                         min_size_factor=0.1, arch="xla", batch_mode="map",
                         preemptive=True)
    ref.initialize(frames)
    st0 = ref._state
    labels_j = np.asarray(ref.iterate(frames, max_iter=4))
    bs = _batched(batch_mode="stack", preemptive=True)
    bs.state = st0
    labels_t = bs.iterate(frames, max_iter=4)
    np.testing.assert_array_equal(labels_t.numpy(), labels_j)
    for fld in FIELDS:
        np.testing.assert_array_equal(getattr(bs.state, fld),
                                      np.asarray(getattr(ref._state, fld)),
                                      err_msg=fld)


def test_async_resolve_and_unchecked_match_iterate(image_factory):
    frames = [_frames(image_factory) for _ in range(2)]
    sync = _batched(batch_mode="stack")
    lazy = _batched(batch_mode="stack")
    unchecked = _batched(batch_mode="stack", check_exactness=False)
    ref = [sync.iterate(f, max_iter=3) for f in frames]
    pend = [lazy.iterate_async(frames[0], max_iter=3)]
    pend.append(lazy.iterate_async(frames[1], max_iter=3))
    got = [p.resolve() for p in pend]
    raw = [unchecked.iterate(f, max_iter=3) for f in frames]
    for r, g, u in zip(ref, got, raw):
        np.testing.assert_array_equal(g.numpy(), r.numpy())
        assert tuple(u.shape) == (B, H, W) and u.dtype == torch.int32
    flags = unchecked.last_flags.numpy()
    if not flags.any():  # no frame tied: nothing left to escalate
        np.testing.assert_array_equal(raw[-1].numpy(), ref[-1].numpy())


def test_batch_modes_route(monkeypatch, image_factory):
    calls = []
    real = tbatch.iterate_graph_stacked

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(tbatch, "iterate_graph_stacked", counting)
    frames = _frames(image_factory)
    canvas = _batched(batch_mode="canvas").iterate(frames, max_iter=2)
    assert len(calls) == 1
    lsc = _batched(batch_mode="stack", variant="lsc").iterate(frames,
                                                             max_iter=2)
    assert len(calls) == 1 and tuple(lsc.shape) == (B, H, W)
    mapped = _batched(batch_mode="map").iterate(frames, max_iter=2)
    np.testing.assert_array_equal(canvas.numpy(), mapped.numpy())
    assert len(calls) == 1
    with pytest.raises(NotImplementedError, match="§1.13"):
        _batched(mesh=object())
    with pytest.raises(ValueError):
        _batched(batch_mode="vmap")
    # stacked labels f*K + k must stay below 0xFFFF, else map
    wide = tbatch.BatchedSlic(num_components=21845, batch_mode="stack",
                              device="cpu")
    assert wide._use_stack(2) and not wide._use_stack(3)


def test_candidate_overflow_reruns_the_batch(monkeypatch, image_factory):
    """A flagged overflow re-runs the batch from the state before it with
    32 slots; the re-run's labels and state replace the first run's."""
    real = tbatch.iterate_graph_stacked
    slots = []

    def flag_16_slots(images, st, cfg, *a):
        out = real(images, st, cfg, *a)
        slots.append(cfg.cand_slots)
        return out._replace(cand_overflow=out.cand_overflow
                            | (cfg.cand_slots == 16))

    frames = _frames(image_factory)
    ref = _batched(batch_mode="stack")
    want = ref.iterate(frames, max_iter=3)
    monkeypatch.setattr(tbatch, "iterate_graph_stacked", flag_16_slots)
    bs = _batched(batch_mode="stack")
    got = bs.iterate(frames, max_iter=3)
    assert slots == [16, 32] and bs._capacity_boost == 1
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    for fld in FIELDS:
        np.testing.assert_array_equal(getattr(bs.state, fld),
                                      getattr(ref.state, fld), err_msg=fld)


def test_batched_cuda_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works")
    with pytest.raises(RuntimeError, match="cuda"):
        tbatch.BatchedSlic(num_components=16)
