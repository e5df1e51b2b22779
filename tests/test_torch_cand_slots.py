"""PyTorch port: the candidate slots a ``SlicModel`` carries between calls.

A run whose candidate lists overflow is re-run with more slots
(``runner.run_iterate``); the model starts its next call on a frame of the
same shape at the slots of the run it kept.  Here the overflow is forced by
a ``pipeline.build_candidates`` that flags it below a slot count (the lists
themselves never fill at these sizes), so every result must equal that of
a model that starts each call at the default 16 slots, the schedule without
the carry.  Exact.
"""

import numpy as np
import pytest

import fast_slic_tpu_torch as ft
from fast_slic_tpu_torch import pipeline
from fast_slic_tpu_torch.config import MAX_CAND_SLOTS
from fast_slic_tpu_torch.utils.timing import COUNTS

K = 30
MAX_ITER = 3
CLASSES = ["Slic", "SlicAvx2", "LSCAvx2"]


@pytest.fixture
def forced(monkeypatch):
    """``below``: the build flags an overflow at fewer slots than this (0:
    never); ``graphs``: the calls of ``pipeline.iterate_graph``, one a run
    the runner makes."""
    real_build, real_graph = pipeline.build_candidates, pipeline.iterate_graph
    state = {"below": MAX_CAND_SLOTS, "graphs": 0}

    def build(y, x, act, cfg, key=None, overflow=None):
        cand, ovf = real_build(y, x, act, cfg, key, overflow)
        return cand, ovf | (cfg.cand_slots < state["below"])

    def graph(*args, **kwargs):
        state["graphs"] += 1
        return real_graph(*args, **kwargs)

    monkeypatch.setattr(pipeline, "build_candidates", build)
    monkeypatch.setattr(pipeline, "iterate_graph", graph)
    return state


@pytest.fixture
def clip(image_factory):
    """Four frames of one scene, panned 2 px a frame."""
    image = image_factory(48, 64)
    return [np.roll(image, 2 * t, 1) for t in range(4)]


def _call(forced, slic, frame):
    """slic.iterate(frame): (labels, runs made, re-runs counted)."""
    forced["graphs"] = 0
    before = COUNTS["runner.reruns"]
    labels = slic.iterate(frame, max_iter=MAX_ITER)
    return labels, forced["graphs"], COUNTS["runner.reruns"] - before


@pytest.mark.parametrize("first_only", [False, True],
                         ids=["forced_every_call", "forced_first_call"])
@pytest.mark.parametrize("cls", CLASSES)
def test_carried_slots_keep_every_result(forced, clip, cls, first_only):
    """The carried model re-runs on its first call only and starts every
    later one at 48 slots; its labels and clusters equal, call by call,
    those of a model put back to 16 slots before each call.  Forced on the
    first call only, the later calls compare lists of 48 slots with
    unflagged lists of 16."""
    carried = getattr(ft, cls)(num_components=K, device="cpu")
    parent = getattr(ft, cls)(num_components=K, device="cpu")
    for t, frame in enumerate(clip):
        forced["below"] = MAX_CAND_SLOTS if t == 0 or not first_only else 0
        labels, runs, reruns = _call(forced, carried, frame)
        assert (runs, reruns) == ((2, 1) if t == 0 else (1, 0)), t
        assert carried.slic_model.last_cand_slots == (16 if t == 0 else 48)
        parent.slic_model._carried_slots = None
        expected, runs, reruns = _call(forced, parent, frame)
        assert parent.slic_model.last_cand_slots == 16
        assert (runs, reruns) == ((2, 1) if forced["below"] else (1, 0)), t
        np.testing.assert_array_equal(labels, expected, err_msg=str(t))
        np.testing.assert_array_equal(carried.slic_model.to_yxmrgb(),
                                      parent.slic_model.to_yxmrgb(),
                                      err_msg=str(t))


def test_seeding_new_state_or_shape_resets_the_slots(forced, clip):
    """``initialize``, the ``clusters`` setter and a frame of another shape
    start the next call at 16 slots; a copy of the model (``slic_model=``)
    keeps the count."""
    slic = ft.SlicAvx2(num_components=K, device="cpu")
    model = slic.slic_model

    def starts(s=slic, frame=clip[1]):
        _, runs, reruns = _call(forced, s, frame)
        assert runs == reruns + 1
        return s.slic_model.last_cand_slots

    assert model.last_cand_slots is None
    assert [starts(frame=clip[0]), starts()] == [16, 48]
    copied = ft.SlicAvx2(num_components=K, slic_model=model, device="cpu")
    assert copied.slic_model is not model and starts(copied) == 48
    model.initialize(clip[2])
    assert [starts(), starts()] == [16, 48]
    model.clusters = model.clusters
    assert [starts(), starts()] == [16, 48]
    crop = clip[3][:40]
    assert [starts(frame=crop), starts(frame=crop)] == [16, 48]
    assert starts() == 16


@pytest.mark.parametrize("cls", CLASSES)
def test_overflow_at_most_slots_runs_once(forced, clip, cls):
    """Flagged at 48 slots too: the first call runs at 16 and 48 and keeps
    the 48, a carried call runs once.  Labels and clusters equal, call by
    call, those of a model whose lists are never flagged: the 48-slot run
    that a re-run would repeat builds the lists that model builds."""
    slic = getattr(ft, cls)(num_components=K, device="cpu")
    unflagged = getattr(ft, cls)(num_components=K, device="cpu")
    for t, frame in enumerate(clip):
        forced["below"] = MAX_CAND_SLOTS + 1
        labels, runs, reruns = _call(forced, slic, frame)
        assert (runs, reruns) == ((2, 1) if t == 0 else (1, 0)), t
        assert slic.slic_model.last_cand_slots == (16 if t == 0 else 48)
        forced["below"] = 0
        expected, runs, _ = _call(forced, unflagged, frame)
        assert (runs, unflagged.slic_model.last_cand_slots) == (1, 16)
        np.testing.assert_array_equal(labels, expected, err_msg=str(t))
        np.testing.assert_array_equal(slic.slic_model.to_yxmrgb(),
                                      unflagged.slic_model.to_yxmrgb(),
                                      err_msg=str(t))
