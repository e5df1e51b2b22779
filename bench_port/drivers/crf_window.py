"""``crf_window``: one video stream segmented by ``SlicAvx2`` and refined by
fast-slic's temporal CRF over a sliding window of frames (a video
segmentation pipeline that smooths a network's per-frame class
probabilities over superpixels, then paints the classes back to pixels).

A call is one frame, through the program's public objects only:

    labels = slic.iterate(frame)                    # clusters carried
    fr = crf.push_slic_frame(slic, knn=knn)
    fr.set_proba(p)                                 # the frame's unaries
    if crf.num_frames > window: crf.pop_frame()
    crf.initialize(); crf.inference(crf_iters)
    cls = fr.get_inferred().argmax(0).astype(np.uint8)
    return slic.slic_model.broadcast_density_to_mask(cls, labels)

The unaries are Dirichlet(1) class probabilities from the seed (no
segmentation network is in the repository), one array for each frame of
the clip, drawn at set-up: a frame carries the same unaries every time the
clip shows it, as a network's output would.  ``compare`` replays the SLIC
stream from the seeding with ``reference/slic_ref.py`` and each kept
call's window with ``reference/crf_ref.py``.
"""

from __future__ import annotations

import collections
import json

import numpy as np
import torch

import loops
from reference import crf_ref, slic_ref

TINY = {"config": {"height": 72, "width": 96, "num_components": 24},
        "traffic": {"clip_frames": 4, "warmup_calls": 1, "trace_calls": 2}}

FAULTS = ("oldest frame left out", "one round fewer",
          "temporal weights zeroed", "one node altered")


class Window:
    """What a kept call's window holds, frame by frame (oldest first): the
    frames' call indices, KNN lists int64 [T, N, m] (-1 past a list),
    their lengths [T, N] and the posteriors float32 [T, C, N]."""

    def __init__(self, times, nbr, lens, q):
        self.times, self.nbr, self.lens, self.q = times, nbr, lens, q


class WindowEntry:
    """The program: ``SlicAvx2`` and ``SimpleCRF(num_classes, K)``."""

    ties_free = True

    def __init__(self, cfg: dict, device):
        import fast_slic_tpu_torch as fst
        from fast_slic_tpu_torch.utils import timing
        self.cfg = cfg
        self.slic = loops.SingleEntry(cfg, device)
        self.crf = fst.SimpleCRF(cfg["num_classes"], cfg["num_components"],
                                 device=device)
        for name, value in cfg["crf_params"].items():
            setattr(self.crf, name, value)
        self.labels = None
        self.timing = timing
        self.moved = None   # the CRF cycle's counters of the last call

    def call(self, images: np.ndarray, proba: np.ndarray) -> np.ndarray:
        """images [1, H, W, 3], proba [C, N] -> uint8 class map [H, W]."""
        cfg, slic, crf = self.cfg, self.slic.obj, self.crf
        labels = slic.iterate(images[0], max_iter=cfg["max_iter"])
        counts, reported = self.timing.COUNTS, self.timing.REPORTED
        before = [counts[k] for k in reported]
        fr = crf.push_slic_frame(slic, knn=cfg["knn"])
        fr.set_proba(proba)
        if crf.num_frames > cfg["window"]:
            crf.pop_frame()
        crf.initialize()
        crf.inference(cfg["crf_iters"])
        q = fr.get_inferred()
        self.moved = {k: counts[k] - b for k, b in zip(reported, before)}
        cls = q.argmax(0).astype(np.uint8)
        self.labels = labels
        return slic.slic_model.broadcast_density_to_mask(cls, labels)

    def state(self) -> np.ndarray:
        return self.slic.state()

    def ties(self) -> int:
        return self.slic.ties()

    def report(self):
        """The call's timing report: the section ``crf_window_call`` over
        SLIC's report and ``crf_cycle``, whose ``counters`` are what the
        program counted from the push to the newest posteriors on the host
        (the KNN graph, the window's staging, the posteriors' download)
        and whose child is the CRF's report.  Without the CRF's report (a
        program that has none) there is no ``crf_cycle``: the program
        does not count the CRF's transfers then."""
        children = [json.loads(r) for r in [self.slic.report()] if r]
        crf = getattr(self.crf, "last_timing_report", None)
        if crf is not None:
            children.append({"name": "crf_cycle", "counters": self.moved,
                             "children": [json.loads(crf)] if crf else []})
        return json.dumps({"name": "crf_window_call", "children": children})

    def window(self) -> Window:
        m = self.cfg["knn"]
        frames = [self.crf.get_frame(t) for t in
                  range(self.crf.first_time, self.crf.last_time + 1)]
        nbr = np.full((len(frames), self.crf.num_nodes, m), -1, np.int64)
        for i, f in enumerate(frames):
            nbr[i, :, :f._nbr.shape[1]] = f._nbr[:, :m]
        return Window([f.time for f in frames], nbr,
                      np.stack([f._lens for f in frames]).astype(np.int64),
                      np.stack([f.get_inferred() for f in frames]))


class ReferenceEntry:
    """The plain references in the program's place (the control: the CRF
    in the configuration's ``control`` dtype)."""

    ties_free = True

    def __init__(self, cfg: dict, device, dtype):
        self.cfg, self.device, self.dtype = cfg, device, dtype
        self.slic = loops.ReferenceEntry(cfg, device, slic_ref.Options())
        self.frames = collections.deque()   # (time, feat, nbr, lens, unary)
        self.t = 0
        self.q = None
        self.labels = None

    def call(self, images: np.ndarray, proba: np.ndarray) -> np.ndarray:
        cfg = self.cfg
        labels = self.slic.call(images)[0]
        st = self.slic.st
        nbr, lens = crf_ref.knn(st.y, st.x, cfg["height"], cfg["width"],
                                cfg["knn"])
        self.frames.append((self.t, crf_ref.features(
            st.y, st.x, st.num_members, st.r, st.g, st.b)[0], nbr[0],
            lens[0], crf_ref.unaries(proba).to(self.device)))
        self.t += 1
        if len(self.frames) > cfg["window"]:
            self.frames.popleft()
        _, feat, nbr, _, unary = zip(*self.frames)
        self.q = crf_ref.meanfield(
            torch.stack(feat), torch.stack(nbr), torch.stack(unary),
            cfg["crf_iters"], params(cfg), dtype=self.dtype)
        self.labels = labels
        return crf_ref.broadcast(self.q[-1].argmax(0), torch.from_numpy(
            labels).to(self.device)).cpu().numpy()

    def state(self) -> np.ndarray:
        return self.slic.state()

    def ties(self) -> int:
        return 0

    def report(self):
        return None

    def window(self) -> Window:
        times, _, nbr, lens, _ = zip(*self.frames)
        return Window(list(times), torch.stack(nbr).cpu().numpy(),
                      torch.stack(lens).cpu().numpy(), self.q.cpu().numpy())


def params(cfg: dict) -> crf_ref.Params:
    return crf_ref.Params(**cfg["crf_params"])


def entry(cfg: dict, traffic: dict, device) -> WindowEntry:
    return WindowEntry(cfg, device)


def control_entry(cfg: dict, traffic: dict, device) -> ReferenceEntry:
    return ReferenceEntry(cfg, device, getattr(torch,
                                               cfg["control"]["crf_dtype"]))


class Loop(loops.Clips):
    """The stream's clip, and the unaries of each of its frames."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device,
                 make_entry):
        super().__init__(cfg, traffic, seed, device, make_entry)
        self.unaries = [crf_ref.dirichlet(seed, f, cfg["num_classes"],
                                          cfg["num_components"])
                        for f in range(traffic["clip_frames"])]

    def proba(self, t: int) -> np.ndarray:
        """Call t's unaries: those of the clip frame it shows."""
        return self.unaries[self.images(t)[1][0]]

    def call(self, t: int):
        images, (frame,) = self.images(t)
        entry = self.entry or self.make_entry()
        return entry, entry.call(images, self.unaries[frame])

    def keep(self, entry, out, before=None):
        """The class map, the SLIC labels and state after the call, and
        the window."""
        return out, entry.labels, entry.state()[0], entry.window()


# -- the comparison -----------------------------------------------------------

KNN_BATCH = 256     # frames whose KNN lists the reference computes at once


def compare(loop: Loop, kept: dict, device) -> dict:
    """The SLIC stream replayed from the seeding; for each kept call, its
    labels and state exactly (``loops.Judge``), each window frame's KNN
    lists exactly (``knn_differ``: nodes whose list differs), its
    posteriors (``posteriors_gap_max``: the largest absolute difference; a
    frame of the reference's window that the program's lacks counts 1) and
    the class map (``class_map_differ_px``: pixels whose class has a
    posterior of their reference cluster more than ``class_map_tie_gap``
    below its best); ``frames_differ``: kept calls with any of these over
    the configuration's limits.  The reference's
    KNN lists of every frame that a kept window holds are computed after
    the replay, ``KNN_BATCH`` frames at once."""
    cfg = loop.cfg
    limits, tie, T = cfg["limits"], cfg["class_map_tie_gap"], cfg["window"]
    judge = loops.Judge(cfg, device)
    out = judge.out
    out.update(knn_differ=0, posteriors_gap_max=0.0, class_map_differ_px=0,
               frames_differ=0)
    need = {tau for t in kept for tau in range(max(0, t - T + 1), t + 1)}
    frames, slic_bad, ref_labels = {}, {}, {}
    st = None
    for t in range(max(kept) + 1 if kept else 0):
        images, _ = loop.images(t)
        if st is None:
            st = judge.seed(images)
        lab, yxm = judge.run(images, st)
        if t in need:
            frames[t] = (st.y[0].clone(), st.x[0].clone(), crf_ref.features(
                st.y, st.x, st.num_members, st.r, st.g, st.b)[0])
        if t in kept:
            _, labels, state, _ = kept[t]
            px0 = out["labels_differ_px"]
            state_gap = float(np.abs(np.asarray(state, np.float64)
                                     - yxm[0]).max())
            judge(np.asarray(labels)[None], np.asarray(state)[None], lab, yxm)
            slic_bad[t] = (out["labels_differ_px"] > px0
                           or state_gap > limits["state_differ_max"])
            ref_labels[t] = lab[0].to(torch.int16)

    graphs = {}
    order = sorted(frames)
    for i in range(0, len(order), KNN_BATCH):
        part = order[i:i + KNN_BATCH]
        nbr, lens = crf_ref.knn(torch.stack([frames[t][0] for t in part]),
                                torch.stack([frames[t][1] for t in part]),
                                cfg["height"], cfg["width"], cfg["knn"])
        graphs.update((t, (nbr[j], lens[j])) for j, t in enumerate(part))

    p = params(cfg)
    for t in sorted(kept):
        class_map, _, _, win = kept[t]
        times = list(range(max(0, t - T + 1), t + 1))
        unary = torch.stack([crf_ref.unaries(loop.proba(tau))
                             for tau in times]).to(device)
        q = crf_ref.meanfield(torch.stack([frames[tau][2] for tau in times]),
                              torch.stack([graphs[tau][0] for tau in times]),
                              unary, cfg["crf_iters"], p)
        knn, gap = 0, 0.0
        for i, tau in enumerate(times):
            if tau not in win.times:
                gap = 1.0
                continue
            j = win.times.index(tau)
            nbr, lens = graphs[tau]
            knn += int(((torch.from_numpy(win.lens[j]).to(device) != lens)
                        | (torch.from_numpy(win.nbr[j]).to(device)
                           != nbr).any(-1)).sum())
            got = torch.from_numpy(win.q[j]).to(device)
            gap = max(gap, float((got - q[i]).abs().max()))
        newest, lab0 = q[-1], ref_labels[t].long()
        C, N = newest.shape
        valid = (lab0 >= 0) & (lab0 < N)
        cm = torch.from_numpy(np.asarray(class_map)).to(device).long()
        node = lab0.clamp(0, N - 1).reshape(-1)
        best = newest.max(0).values[node]
        wrong = (newest[cm.clamp(0, C - 1).reshape(-1), node]
                 < best - tie).reshape(cm.shape)
        px = int(torch.where(valid, wrong | (cm >= C), cm != 0).sum())
        out["knn_differ"] += knn
        out["posteriors_gap_max"] = max(out["posteriors_gap_max"], gap)
        out["class_map_differ_px"] += px
        out["frames_differ"] += int(
            slic_bad[t] or knn > limits["knn_differ"]
            or gap > limits["posteriors_gap_max"]
            or px > limits["class_map_differ_px"])
    return out


# -- faults planted in the program ------------------------------------------

def faults(cfg: dict) -> tuple:
    return FAULTS


def plant(fault: str):
    """Break the program's CRF with ``fault``; returns the undo function.

    - ``oldest frame left out``: each inference runs without the window's
      oldest frame, which keeps the posteriors of ``initialize``;
    - ``one round fewer``: ``inference(n)`` runs n - 1 rounds;
    - ``temporal weights zeroed``: no frame weighs its neighbours in time;
    - ``one node altered``: the newest frame's most confident node has its
      posterior mass moved to its least likely class.
    """
    from fast_slic_tpu_torch.models import crf as crf_mod
    if fault not in FAULTS:
        raise ValueError("no fault %r of the CRF window" % fault)
    if fault in ("oldest frame left out", "one round fewer"):
        real = crf_mod.SimpleCRF.inference

        def inference(self, max_iter):
            if fault == "one round fewer":
                return real(self, max_iter - 1)
            if self.num_frames < 2:
                return real(self, max_iter)
            t, oldest = self._frames.popitem(last=False)
            self._cache = None
            try:
                return real(self, max_iter)
            finally:
                self._frames[t] = oldest
                self._frames.move_to_end(t, last=False)
                self._cache = None

        crf_mod.SimpleCRF.inference = inference
        return lambda: setattr(crf_mod.SimpleCRF, "inference", real)
    if fault == "temporal weights zeroed":
        real = crf_mod._energies

        def _energies(*args, **kw):
            idx, w_s, w_prev, w_next = real(*args, **kw)
            if w_prev is not None:
                w_prev, w_next = torch.zeros_like(w_prev), torch.zeros_like(
                    w_next)
            return idx, w_s, w_prev, w_next

        crf_mod._energies = _energies
        return lambda: setattr(crf_mod, "_energies", real)
    real = crf_mod._meanfield

    def _meanfield(*args, **kw):
        q = real(*args, **kw)
        n = int(q[-1].max(0).values.argmax())
        low = int(q[-1, :, n].argmin())
        q[-1, :, n] = 0.0
        q[-1, low, n] = 1.0
        return q

    crf_mod._meanfield = _meanfield
    return lambda: setattr(crf_mod, "_meanfield", real)
