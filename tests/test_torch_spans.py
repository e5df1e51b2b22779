"""PyTorch port: the spans and counters of ``utils/timing.py``.

Under ``torch.profiler`` (CPU activity) a public call records its
``fstt.`` spans: one entry span a call, one ``iterate`` section, a
candidate build a loop pass and one for the full assign, each loop span
inside the ``iteration_loop`` or ``full_assign`` section, none a user
annotation; the preemptive step's ``preemptive.cooldown`` and
``preemptive.mask`` inside ``loop.preemptive``, its activity count equal to
the loop's plain steps' and kept on the device (no host sync); the same
for ``BatchedSlic`` in stack and map mode, with LSC.
The timing report's top-level section carries the call's counters (0 on
the CPU, where nothing crosses to a device), and the launch counts read
the same counter store.
"""

import collections
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import fast_slic_tpu_torch as ft
from conftest import make_image
from fast_slic_tpu_torch import kernels
from fast_slic_tpu_torch.kernels import _lib
from fast_slic_tpu_torch.parallel.batch import BatchedSlic
from fast_slic_tpu_torch.utils import timing
from torch_threads import one_torch_thread  # noqa: F401

K = 12
MAX_ITER = 3
LOOP_SECTIONS = ("fstt.iteration_loop", "fstt.full_assign")


def spans_of(fn):
    """The ``fstt.`` events recorded while ``fn()`` runs."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return [e for e in prof.events() if e.name.startswith("fstt.")]


def counts(spans):
    return collections.Counter(e.name for e in spans)


def assert_loop_spans_nested(spans):
    """Every ``fstt.loop.*`` lies inside an iteration_loop or full_assign
    interval."""
    outer = [(e.time_range.start, e.time_range.end) for e in spans
             if e.name in LOOP_SECTIONS]
    loop = [e for e in spans if e.name.startswith("fstt.loop.")]
    assert loop
    for e in loop:
        assert any(s <= e.time_range.start and e.time_range.end <= t
                   for s, t in outer), e.name


@pytest.fixture
def image():
    return make_image(np.random.default_rng(7), 32, 40)


@pytest.mark.parametrize("cls", ["Slic", "LSC"])
def test_slic_iterate_records_its_spans(image, cls):
    slic = getattr(ft, cls)(num_components=K, device="cpu")
    spans = spans_of(lambda: slic.iterate(image, max_iter=MAX_ITER))
    n = counts(spans)
    attempts = n["fstt.iteration_loop"]
    assert attempts >= 1
    assert n["fstt.entry.iterate"] == 1 and n["fstt.iterate"] == 1
    assert n["fstt.entry.seed"] == 1
    assert n["fstt.loop.candidates"] == (MAX_ITER + 1) * attempts
    assert n["fstt.loop.assign"] == (MAX_ITER + 1) * attempts
    assert n["fstt.loop.update"] == MAX_ITER * attempts
    assert n["fstt.loop.after_update"] == (
        MAX_ITER * attempts if cls == "LSC" else 0)
    for name in ("write_to_buffer", "cielab_conversion", "full_assign",
                 "enforce_connectivity", "write_back", "cca.components",
                 "cca.select", "cca.relabel", "runner.overflow_check",
                 "runner.labels_to_host", "runner.state_to_host"):
        assert n["fstt." + name] >= 1, name
    assert_loop_spans_nested(spans)
    assert not any(e.is_user_annotation for e in spans)


def test_constructor_and_preemptive_spans(image):
    spans = spans_of(lambda: ft.Slic(num_components=K, preemptive=True,
                                     device="cpu").iterate(image, 2))
    n = counts(spans)
    assert n["fstt.entry.init"] == 1
    assert n["fstt.loop.preemptive"] == 2 * n["fstt.iteration_loop"]
    assert_loop_spans_nested(spans)


def test_preemptive_step_spans_nest_under_loop_preemptive(image):
    slic = ft.Slic(num_components=K, preemptive=True, device="cpu")
    spans = spans_of(lambda: slic.iterate(image, MAX_ITER))
    n = counts(spans)
    assert n["fstt.loop.preemptive"] == MAX_ITER * n["fstt.iteration_loop"]
    step = [(e.time_range.start, e.time_range.end) for e in spans
            if e.name == "fstt.loop.preemptive"]
    for name in ("fstt.preemptive.cooldown", "fstt.preemptive.mask"):
        inner = [e for e in spans if e.name == name]
        assert len(inner) == n["fstt.loop.preemptive"], name
        for e in inner:
            assert any(s <= e.time_range.start and e.time_range.end <= t
                       for s, t in step), name


def test_preemptive_activity_is_the_plain_steps_count(image):
    """``last_preemptive_activity`` of a carried call equals the counts
    recomputed by running the loop's plain steps from the same state."""
    from fast_slic_tpu_torch import pipeline
    from fast_slic_tpu_torch.config import UNASSIGNED
    from fast_slic_tpu_torch.kernels.segsum import slic_update_masked_plain
    iters, stride = 10, 3
    slic = ft.Slic(num_components=K, preemptive=True, device="cpu")
    slic.iterate(image, iters)
    model = slic.slic_model
    H, W = image.shape[:2]
    cfg = model._static_config(H, W)
    st = model._clusters.to_torch("cpu")
    slic.iterate(image, iters)
    act = model.last_preemptive_activity
    assert act.dtype == torch.int32 and tuple(act.shape) == (iters, 2)

    scalars = pipeline.derive_scalars(cfg, 10, 0.25, 0.05)
    planes, st, _ = pipeline.stage_setup(torch.from_numpy(image), st, cfg,
                                         scalars)
    assignment = torch.full((H, W), UNASSIGNED, dtype=torch.int32)
    mask = torch.ones((H, W), dtype=torch.bool)
    rows = []
    for i in range(iters):
        rem = i % stride
        st = pipeline._clamp_centers(st, cfg)
        cand, _ = pipeline.build_candidates(st.y, st.x, st.is_active, cfg)
        pipeline.assign_pass(planes, st, cand, assignment, cfg, scalars,
                             stride, rem)
        old_y, old_x = st.y, st.x
        acc = slic_update_masked_plain(assignment, planes, mask, K, stride,
                                       rem)
        st = pipeline.update_apply_means_rows(acc[0], acc[1:], st, cfg)
        st, mask = pipeline._preemptive_step(st, old_y, old_x, cfg,
                                             scalars.l1_thres)
        rows.append([int(st.is_active.sum()), int(acc[0].sum())])
    assert act.tolist() == rows
    assert ft.Slic(num_components=K, device="cpu").slic_model \
        .last_preemptive_activity is None


def test_preemptive_call_adds_no_host_sync(image, monkeypatch):
    """With every transfer counted as if it crossed to a device, a
    preemptive call's report counts the syncs and downloads of the same
    call without the grid: its activity stays on the device."""
    from fast_slic_tpu_torch import cluster, runner
    from fast_slic_tpu_torch.ops import cca
    _crossing(monkeypatch, (cluster, runner, cca))
    reports = {}
    for pre in (False, True):
        slic = ft.Slic(num_components=K, preemptive=pre, device="cpu")
        for _ in range(2):
            slic.iterate(image, max_iter=10)
        reports[pre] = json.loads(slic.slic_model.last_timing_report)
    got, base = reports[True]["counters"], reports[False]["counters"]
    assert base["host_syncs"] > 0 and base["d2h_bytes"] > 0
    assert got["host_syncs"] == base["host_syncs"]
    assert got["d2h_bytes"] == base["d2h_bytes"]


@pytest.mark.parametrize("mode,variant", [("stack", "standard"),
                                          ("map", "standard"),
                                          ("map", "lsc"),
                                          ("stack", "lsc")])
def test_batch_iterate_records_its_spans(image, mode, variant):
    frames = np.stack([image, image[::-1].copy()])
    batch = BatchedSlic(num_components=K, batch_mode=mode, variant=variant,
                        device="cpu")
    spans = spans_of(lambda: batch.iterate(frames, max_iter=MAX_ITER))
    n = counts(spans)
    attempts = n["fstt.entry.batch"]
    assert attempts >= 1 and n["fstt.batch.resolve"] == attempts
    assert n["fstt.batch.upload"] == attempts
    assert n["fstt.entry.seed"] == 1
    # LSC is not stacked: it runs the frames in turn, as map mode does
    per_call = 1 if (mode, variant) == ("stack", "standard") else 2
    assert n["fstt.iteration_loop"] == per_call * attempts
    assert n["fstt.loop.candidates"] == (MAX_ITER + 1) * per_call * attempts
    assert n["fstt.cca.components"] >= per_call * attempts
    assert_loop_spans_nested(spans)
    assert not any(e.is_user_annotation for e in spans)


def test_report_carries_the_call_counters(image):
    slic = ft.Slic(num_components=K, device="cpu")
    slic.iterate(image, max_iter=MAX_ITER)
    rep = json.loads(slic.slic_model.last_timing_report)
    assert rep["counters"] == {"host_syncs": 0, "h2d_bytes": 0,
                               "d2h_bytes": 0}


def test_timer_counts_only_inside_its_top_section():
    timer = timing.Timer(None)
    timing.COUNTS["host_syncs"] += 5
    with timer.scope("iterate"):
        with timer.scope("inner"):
            timing.COUNTS["host_syncs"] += 2
            timing.COUNTS["h2d_bytes"] += 100
        timing.COUNTS["d2h_bytes"] += 7
        timing.COUNTS["launch.fstt_assign"] += 1
    timing.COUNTS["host_syncs"] += 3
    rep = json.loads(timer.report())
    assert rep["counters"] == {"host_syncs": 2, "h2d_bytes": 100,
                               "d2h_bytes": 7}
    assert [c["name"] for c in rep["children"]] == ["inner"]


def test_transfers_on_one_device_count_nothing():
    before = dict(timing.COUNTS)
    t = timing.to_device(torch.arange(6), "cpu", torch.int64)
    assert timing.to_host(t[2], int) == 2
    assert timing.to_host(torch.ones((), dtype=torch.bool), bool) is True
    assert torch.equal(timing.to_host(t), torch.arange(6))
    assert dict(timing.COUNTS) == before


def test_launch_counts_read_the_counter_store():
    assert {k.entry for k in kernels.KERNELS} <= set(_lib._SIGNATURES)
    kernels.reset_launches()
    assert set(kernels.launch_counts().values()) == {0}
    timing.COUNTS["launch.fstt_assign"] += 3
    timing.COUNTS["launch.fstt_cc"] += 1
    counted = kernels.launch_counts()
    assert counted["assign"] == 3 and counted["connected_components"] == 1
    kernels.reset_launches()
    assert kernels.launch_counts()["assign"] == 0


def test_spanned_keeps_the_function():
    @timing.spanned("test.fn")
    def fn(a, b=2):
        """doc"""
        return a + b
    assert fn(1, b=3) == 4 and fn.__doc__ == "doc" and fn.__name__ == "fn"
    spans = spans_of(lambda: fn(1))
    assert counts(spans) == {"fstt.test.fn": 1}


# -- the CRF window (the benchmark's crf720.window call)

C, KNN = 5, 4
CRF_SPANS = ("crf.push", "crf.inference", "crf.stage", "crf.energies",
             "crf.meanfield", "crf.posteriors_to_host", "graph.knn",
             "graph.density_to_mask")


def window_call(slic, crf, image, t):
    """One call of the window: SLIC, the KNN push, the unaries, a pop past
    four frames, the mean field, the newest posteriors and their classes
    painted back to the pixels.  Returns what the CRF's cycle (the push to
    the posteriors on the host) added to ``COUNTS``."""
    labels = slic.iterate(image, max_iter=MAX_ITER)
    before = {k: timing.COUNTS[k] for k in timing.REPORTED}
    fr = crf.push_slic_frame(slic, knn=KNN)
    fr.set_proba(np.random.default_rng(t).dirichlet(
        np.ones(C), K).T.astype(np.float32))
    if crf.num_frames > 4:
        crf.pop_frame()
    crf.initialize()
    crf.inference(5)
    cls = fr.get_inferred().argmax(0).astype(np.uint8)
    moved = {k: timing.COUNTS[k] - before[k] for k in timing.REPORTED}
    slic.slic_model.broadcast_density_to_mask(cls, labels)
    return moved


def staged(crf, first):
    """(h2d, syncs) of an inference's staging: the window's graph,
    features and unaries, the parameters (and the class weights, the first
    time)."""
    T = crf.num_frames
    D = max(crf.get_frame(t)._nbr.shape[1]
            for t in range(crf.first_time, crf.last_time + 1))
    return 4 * T * K * (D + 6 + C) + 28 + (4 * C if first else 0), 4 + first


def test_crf_window_call_records_its_spans(image):
    slic = ft.SlicAvx2(num_components=K, device="cpu")
    crf = ft.SimpleCRF(C, K, device="cpu")
    assert crf.last_timing_report == ""
    for t in range(4):
        window_call(slic, crf, image, t)
    spans = spans_of(lambda: window_call(slic, crf, image, 4))
    n = counts(spans)
    for name in CRF_SPANS:
        assert n["fstt." + name] == 1, name
    # each timer section has one span, under the name above
    assert not any(name.startswith("fstt.crf_") for name in n)
    assert not any(e.is_user_annotation for e in spans)
    rep = json.loads(crf.last_timing_report)
    assert rep["name"] == "crf_inference" and rep["duration"] >= 0
    assert [c["name"] for c in rep["children"]] == [
        "crf_stage", "crf_energies", "crf_meanfield"]
    # nothing crosses to a device on the CPU
    assert rep["counters"] == {"host_syncs": 0, "h2d_bytes": 0,
                               "d2h_bytes": 0}


def _crossing(monkeypatch, modules=None):
    """The transfers of ``modules`` (by default the CRF's and the graph
    functions') counted as if each crossed to a device."""
    from fast_slic_tpu_torch.models import crf as crf_mod
    from fast_slic_tpu_torch.ops import graph

    def to_device(t, device, dtype=None):
        out = t.to(device=device, dtype=dtype)
        timing.COUNTS["h2d_bytes"] += out.numel() * out.element_size()
        timing.COUNTS["host_syncs"] += 1
        return out

    def to_host(t, read=None):
        timing.COUNTS["d2h_bytes"] += t.numel() * t.element_size()
        timing.COUNTS["host_syncs"] += 1
        return t.cpu() if read is None else read(t)

    for mod in modules or (crf_mod, graph):
        monkeypatch.setattr(mod, "to_device", to_device)
        monkeypatch.setattr(mod, "to_host", to_host)


def test_crf_report_counts_its_cycle(image, monkeypatch):
    """Every upload and download of the CRF and of the KNN goes through
    ``to_device`` / ``to_host``: a cycle moves the centres up and the KNN
    lists down, the staging up, the whole posterior stack down; the
    report's counters are the staging's, inside the inference."""
    _crossing(monkeypatch)
    slic = ft.SlicAvx2(num_components=K, device="cpu")
    crf = ft.SimpleCRF(C, K, device="cpu")
    for t in range(6):
        moved = window_call(slic, crf, image, t)
        h2d, syncs = staged(crf, t == 0)
        rep = json.loads(crf.last_timing_report)
        assert rep["counters"] == {"host_syncs": syncs, "h2d_bytes": h2d,
                                   "d2h_bytes": 0}, t
        assert moved == {
            "host_syncs": syncs + 4, "h2d_bytes": h2d + 8 * K,
            "d2h_bytes": 4 * (K * KNN + K)
            + 4 * crf.num_frames * C * K}, t
    # a read of an older frame's posteriors comes from the same download
    before = timing.COUNTS["d2h_bytes"]
    crf.get_frame(crf.first_time).get_inferred()
    assert timing.COUNTS["d2h_bytes"] == before
