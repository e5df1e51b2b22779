"""PyTorch port: the candidate-slot schedule and carry of every entry.

A run whose candidate lists overflow is re-run with more slots on the
runner's schedule (``runner.rerun_slots``: 16, then 48; a run at 48 is
kept); ``SlicModel``, ``BatchedSlic`` and ``ShardedSlicExplicit`` each
start their next call on a frame of the same shape at the slots of the run
they kept, and count each re-run (``runner.CarriedSlots``).  Here the
overflow is forced by a ``pipeline.build_candidates`` that flags it below a
slot count (the lists themselves never fill at these sizes), so every
result must equal that of an entry put back to 16 slots before each call,
the schedule without the carry.  Exact.
"""

import numpy as np
import pytest
import torch

import fast_slic_tpu_torch as ft
from fast_slic_tpu_torch import pipeline
from fast_slic_tpu_torch.parallel import batch, spatial_shardmap
from fast_slic_tpu_torch.parallel.mesh import make_mesh
from fast_slic_tpu_torch.runner import MAX_CAND_SLOTS
from fast_slic_tpu_torch.utils.timing import COUNTS
from torch_threads import one_torch_thread  # noqa: F401

K = 30
MAX_ITER = 3


def _yxmrgb(st) -> np.ndarray:
    return np.stack([st.y, st.x, st.num_members, st.r, st.g, st.b], -1)


class _Single:
    """A ``SlicModel`` class (``Slic``, ``SlicAvx2``, ``LSCAvx2``)."""

    def __init__(self, cls, **kwargs):
        self.obj = getattr(ft, cls)(num_components=K, device="cpu", **kwargs)

    @property
    def carry(self):
        return self.obj.slic_model._slots

    def call(self, frame):
        return self.obj.iterate(frame, max_iter=MAX_ITER)

    def state(self):
        return self.obj.slic_model.to_yxmrgb()

    def seed(self, frame):
        self.obj.slic_model.initialize(frame)

    def set_state(self):
        model = self.obj.slic_model
        model.clusters = model.clusters


class _Batch:
    """``BatchedSlic(batch_mode="stack")`` over two frames a call: the
    frame and its mirror."""

    def __init__(self):
        self.obj = batch.BatchedSlic(num_components=K, batch_mode="stack",
                                     device="cpu")

    @property
    def carry(self):
        return self.obj._slots

    @staticmethod
    def _pair(frame):
        return np.stack([frame, np.ascontiguousarray(frame[:, ::-1])])

    def call(self, frame):
        return self.obj.iterate(self._pair(frame), max_iter=MAX_ITER).numpy()

    def state(self):
        return _yxmrgb(self.obj.state)

    def seed(self, frame):
        self.obj.initialize(self._pair(frame))

    def set_state(self):
        self.obj.state = self.obj.state


class _Sharded:
    """``ShardedSlicExplicit`` with the rows over four CPU shards."""

    seed = None   # seeds itself from its first image

    def __init__(self):
        mesh = make_mesh(devices=[torch.device("cpu")] * 4, data=1, space=4)
        self.obj = spatial_shardmap.ShardedSlicExplicit(num_components=K,
                                                        mesh=mesh)

    @property
    def carry(self):
        return self.obj._slots

    def call(self, frame):
        return self.obj.iterate(frame, max_iter=MAX_ITER)

    def state(self):
        return _yxmrgb(self.obj.state)

    def set_state(self):
        self.obj.state = self.obj.state


ENTRIES = {"Slic": lambda: _Single("Slic"),
           "SlicAvx2": lambda: _Single("SlicAvx2"),
           "LSCAvx2": lambda: _Single("LSCAvx2"),
           "BatchedSlic": _Batch,
           "ShardedSlicExplicit": _Sharded}


@pytest.fixture
def forced(monkeypatch):
    """``below``: the build flags an overflow at fewer slots than this (0:
    never); ``runs``: the image's candidate slots of each run an entry
    makes (a row shard's lists hold up to twice as many)."""
    real_build = pipeline.build_candidates
    state = {"below": MAX_CAND_SLOTS, "runs": []}

    def build(y, x, act, cfg, key=None, overflow=None):
        cand, ovf = real_build(y, x, act, cfg, key, overflow)
        return cand, ovf | (cfg.cand_slots < state["below"])

    monkeypatch.setattr(pipeline, "build_candidates", build)
    for module, name, at in ((pipeline, "iterate_graph", 2),
                             (batch, "iterate_graph_stacked", 2),
                             (spatial_shardmap, "shard_step", 3)):
        def run(*args, _real=getattr(module, name), _at=at, **kwargs):
            state["runs"].append(args[_at].cand_slots)
            return _real(*args, **kwargs)
        monkeypatch.setattr(module, name, run)
    return state


@pytest.fixture
def clip(image_factory):
    """Four frames of one scene, panned 2 px a frame."""
    image = image_factory(48, 64)
    return [np.roll(image, 2 * t, 1) for t in range(4)]


def _call(forced, entry, frame):
    """entry.call(frame): (labels, the slots of each run, re-runs
    counted)."""
    forced["runs"] = []
    before = COUNTS["runner.reruns"]
    labels = entry.call(frame)
    runs = forced["runs"]
    if isinstance(entry, _Single):
        assert entry.obj.slic_model.last_cand_slots == runs[0]
    return labels, runs, COUNTS["runner.reruns"] - before


@pytest.mark.parametrize("first_only", [False, True],
                         ids=["forced_every_call", "forced_first_call"])
@pytest.mark.parametrize("cls", list(ENTRIES))
def test_carried_slots_keep_every_result(forced, clip, cls, first_only):
    """The carried entry re-runs once, at 48 slots, on its first call only
    and starts every later one at 48; its labels and state equal, call by
    call, those of an entry put back to 16 slots before each call.  Forced
    on the first call only, the later calls compare lists of 48 slots with
    unflagged lists of 16."""
    carried, parent = ENTRIES[cls](), ENTRIES[cls]()
    for t, frame in enumerate(clip):
        forced["below"] = MAX_CAND_SLOTS if t == 0 or not first_only else 0
        labels, runs, reruns = _call(forced, carried, frame)
        assert (runs, reruns) == (([16, 48], 1) if t == 0 else ([48], 0)), t
        parent.carry.reset()
        expected, runs, reruns = _call(forced, parent, frame)
        assert (runs, reruns) == (([16, 48], 1) if forced["below"]
                                  else ([16], 0)), t
        np.testing.assert_array_equal(labels, expected, err_msg=str(t))
        np.testing.assert_array_equal(carried.state(), parent.state(),
                                      err_msg=str(t))


@pytest.mark.parametrize("cls", list(ENTRIES))
def test_seeding_new_state_or_shape_resets_the_slots(forced, clip, cls):
    """``initialize`` (where the entry has one), the ``clusters`` /
    ``state`` setter and a frame of another shape start the next call at
    16 slots; a copy of a model (``slic_model=``) keeps the count."""
    entry = ENTRIES[cls]()

    def starts(e=entry, frame=clip[1]):
        _, runs, reruns = _call(forced, e, frame)
        assert len(runs) == reruns + 1
        return runs[0]

    if isinstance(entry, _Single):
        assert entry.obj.slic_model.last_cand_slots is None
    assert [starts(frame=clip[0]), starts()] == [16, 48]
    if isinstance(entry, _Single):
        assert entry.obj.slic_model.last_cand_slots == 48
        copied = _Single(cls, slic_model=entry.obj.slic_model)
        assert copied.obj.slic_model is not entry.obj.slic_model
        assert starts(copied) == 48
    if entry.seed is not None:
        entry.seed(clip[2])
        assert [starts(), starts()] == [16, 48]
    entry.set_state()
    assert [starts(), starts()] == [16, 48]
    crop = np.ascontiguousarray(clip[3][:40])
    assert [starts(frame=crop), starts(frame=crop)] == [16, 48]
    assert starts() == 16


@pytest.mark.parametrize("cls", list(ENTRIES))
def test_overflow_at_most_slots_runs_once(forced, clip, cls):
    """Flagged at 48 slots too: the first call runs at 16 and 48 and keeps
    the 48, with no third run; a carried call runs once.  Labels and state
    equal, call by call, those of an entry whose lists are never flagged:
    the 48-slot run that a re-run would repeat builds the lists that entry
    builds."""
    entry, unflagged = ENTRIES[cls](), ENTRIES[cls]()
    for t, frame in enumerate(clip):
        forced["below"] = MAX_CAND_SLOTS + 1
        labels, runs, reruns = _call(forced, entry, frame)
        assert (runs, reruns) == (([16, 48], 1) if t == 0 else ([48], 0)), t
        forced["below"] = 0
        expected, runs, _ = _call(forced, unflagged, frame)
        assert runs == [16]
        np.testing.assert_array_equal(labels, expected, err_msg=str(t))
        np.testing.assert_array_equal(entry.state(), unflagged.state(),
                                      err_msg=str(t))
