"""What the SLIC drivers share (``drivers/stream.py``, ``batch.py`` and
``stills.py``): the program entries they drive, the plain reference in the
program's place (the controls), the frames a call is given, and the
comparison of what the timed calls returned with the plain reference.

Each call is a closed loop: the next starts when the last one's results
are ready.
"""

from __future__ import annotations

import numpy as np
import torch

import frames as frames_lib
from reference import slic_ref


def params(cfg: dict) -> slic_ref.Params:
    return slic_ref.Params(
        H=cfg["height"], W=cfg["width"], K=cfg["num_components"],
        variant=cfg["variant"], compactness=float(cfg["compactness"]),
        min_size_factor=float(cfg["min_size_factor"]),
        subsample_stride=int(cfg["subsample_stride"]),
        max_iter=int(cfg["max_iter"]))


# -- entries: the program's public calls ------------------------------------

class SingleEntry:
    """``<class>(num_components=K, ...).iterate(frame)`` of the program."""

    ties_free = True

    def __init__(self, cfg: dict, device):
        import fast_slic_tpu_torch as fst
        cls = getattr(fst, cfg["class"])
        self.cfg = cfg
        self.obj = cls(num_components=cfg["num_components"],
                       compactness=cfg["compactness"],
                       min_size_factor=cfg["min_size_factor"],
                       subsample_stride=cfg["subsample_stride"],
                       device=device)

    def call(self, images: np.ndarray):
        """images [1, H, W, 3] -> int16 labels [1, H, W] (numpy)."""
        return self.obj.iterate(images[0], max_iter=self.cfg["max_iter"])[None]

    def state(self) -> np.ndarray:
        return self.obj.slic_model.to_yxmrgb()[None]

    def ties(self) -> int:
        return int(self.obj.slic_model.last_cca_tie)

    def report(self):
        return self.obj.slic_model.last_timing_report


class BatchEntry:
    """``BatchedSlic(num_components=K, batch_mode=..., ...).iterate(frames)``
    of the program; ready once the device has finished.  Its tie flags
    stay on the device: reading them is a sync, left to traced runs."""

    ties_free = False

    def __init__(self, cfg: dict, device, batch_mode: str):
        from fast_slic_tpu_torch.parallel.batch import BatchedSlic
        self.cfg = cfg
        self.obj = BatchedSlic(num_components=cfg["num_components"],
                               compactness=cfg["compactness"],
                               min_size_factor=cfg["min_size_factor"],
                               subsample_stride=cfg["subsample_stride"],
                               variant=cfg["variant"], batch_mode=batch_mode,
                               device=device)
        self.cuda = torch.device(device).type == "cuda"

    def call(self, images: np.ndarray):
        labels = self.obj.iterate(images, max_iter=self.cfg["max_iter"])
        if self.cuda:
            torch.cuda.synchronize()
        return labels

    def state(self) -> np.ndarray:
        s = self.obj.state
        return np.stack([s.y, s.x, s.num_members, s.r, s.g, s.b],
                        -1).astype(np.float64)

    def ties(self) -> int:
        return int(self.obj.last_flags.sum())

    def report(self):
        return None


class ReferenceEntry:
    """The plain reference in the program's place (the controls)."""

    ties_free = True

    def __init__(self, cfg: dict, device, opts: slic_ref.Options):
        self.p, self.opts, self.device = params(cfg), opts, device
        self.st = None
        self.tables = slic_ref.lab_tables()

    def call(self, images: np.ndarray):
        if self.st is None:
            self.st = slic_ref.seed_state(images, self.p.K, self.device)
        out = slic_ref.iterate(torch.from_numpy(images).to(self.device),
                               self.st, self.p, self.opts, self.tables)
        return out.to(torch.int16).cpu().numpy()

    def state(self) -> np.ndarray:
        return self.st.yxmrgb()

    def ties(self) -> int:
        return 0

    def report(self):
        return None


def control_options(cfg: dict) -> slic_ref.Options:
    """The configuration's ``"control"``: LSC in bfloat16, or equal
    distances given to the smallest cluster number instead of the
    reference's visit order."""
    c = dict(cfg["control"])
    if "lsc_dtype" in c:
        c["lsc_dtype"] = getattr(torch, c["lsc_dtype"])
    return slic_ref.Options(**c)


def control_entry(cfg: dict, traffic: dict, device) -> ReferenceEntry:
    return ReferenceEntry(cfg, device, control_options(cfg))


# -- traffic ------------------------------------------------------------------

class Loop:
    """What a call of a run is given; ``images(t)`` is the driver's."""

    streams = 1

    def __init__(self, cfg: dict, traffic: dict, make_entry):
        self.cfg, self.traffic = cfg, traffic
        self.make_entry = make_entry      # () -> a fresh entry
        self.entry = None

    @property
    def frames_per_call(self) -> int:
        return self.streams

    def start(self):
        """A fresh program for the timed calls."""
        self.entry = self.make_entry()

    def call(self, t: int):
        """One public call; returns (entry, output)."""
        images, _ = self.images(t)
        entry = self.entry or self.make_entry()
        return entry, entry.call(images)

    @property
    def follow(self) -> bool:
        """Whether the reference starts each compared call from the
        program's state before it (the traffic's ``"reference_state":
        "program"``) instead of replaying every call from the seeding."""
        return self.traffic.get("reference_state") == "program"

    def keeps(self, t: int, rng) -> bool:
        """Whether call t's output is compared: the first call, and then
        the share ``compare_share`` of the calls, drawn from the seed."""
        share = self.traffic.get("compare_share", 1.0)
        return t == 0 or share >= 1.0 or rng.random() < share

    def keep(self, entry, out, before=None):
        """What the comparison needs of a call, on the host: its labels
        (a copy of those left on the device), the state after the call
        and (``follow``) before it."""
        if isinstance(out, torch.Tensor):
            out = out.to(torch.int16).cpu()
        return out, entry.state(), before


class Clips(Loop):
    """``streams`` clips from the seed, one frame of each a call, each
    played back and forth a share of the period apart."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device,
                 make_entry):
        super().__init__(cfg, traffic, make_entry)
        t = traffic
        self.streams = t["streams"]
        self.clips = [frames_lib.clip(cfg["height"], cfg["width"],
                                      t["clip_frames"], t["pan_px"],
                                      t["noise_sigma"], seed, s, device)
                      for s in range(self.streams)]

    def images(self, t: int):
        """Call t's frames [streams, H, W, 3] and their ids."""
        n = self.traffic["clip_frames"]
        period = 2 * (n - 1)
        ids = tuple(frames_lib.ping_pong(t, n, s * period // self.streams)
                    for s in range(self.streams))
        return np.stack([c[f] for c, f in zip(self.clips, ids)]), ids


# -- the comparison -----------------------------------------------------------

def partition_disagreement(a: torch.Tensor, b: torch.Tensor) -> float:
    """Share of pixels outside the largest overlap of their label of ``a``
    with one label of ``b``: 0 when the two maps cut the frame into the same
    regions, whatever their numbers (a region more or less near the top
    renumbers every later one)."""
    a, b = a.reshape(-1).long(), b.reshape(-1).long()
    pair, counts = torch.unique((a + 1) * (1 << 20) + (b + 1),
                                return_counts=True)
    best = torch.zeros(int(a.max()) + 2, dtype=counts.dtype,
                       device=a.device)
    best.scatter_reduce_(0, pair // (1 << 20), counts, "amax")
    return 1.0 - float(best.sum()) / a.numel()


class Judge:
    """The reference's calls and the numbers compared: pixels whose label
    differs (their total, and the largest share in one frame), the largest
    partition disagreement of a frame, frames with any label differing,
    the largest difference of a cluster's y, x, member count, L, a or b,
    and the largest share of a frame's clusters whose centre differs."""

    def __init__(self, cfg: dict, device):
        self.p, self.device = params(cfg), device
        self.tables = slic_ref.lab_tables()
        self.out = dict(labels_differ_px=0, labels_differ_share_max=0.0,
                        partition_disagree_max=0.0, frames_differ=0,
                        state_differ_max=0.0, clusters_differ_share_max=0.0)

    def seed(self, images: np.ndarray) -> slic_ref.State:
        return slic_ref.seed_state(images, self.p.K, self.device)

    def run(self, images: np.ndarray, st: slic_ref.State):
        """The reference's labels and state after one call from ``st``."""
        lab = slic_ref.iterate(torch.from_numpy(images).to(self.device), st,
                               self.p, tables=self.tables)
        return lab, st.yxmrgb()

    def __call__(self, labels, state, ref_labels, ref_state):
        out = self.out
        labels = torch.as_tensor(labels).to(self.device).long()
        diff = labels != ref_labels
        per_frame = diff.reshape(diff.shape[0], -1).float().mean(1)
        out["labels_differ_px"] += int(diff.sum())
        out["frames_differ"] += int((per_frame > 0).sum())
        out["labels_differ_share_max"] = max(
            out["labels_differ_share_max"], float(per_frame.max()))
        for a, b in zip(labels, ref_labels):
            out["partition_disagree_max"] = max(
                out["partition_disagree_max"], partition_disagreement(a, b))
        state = np.asarray(state, np.float64)
        out["state_differ_max"] = max(out["state_differ_max"], float(
            np.abs(state - ref_state).max()))
        moved = (state[..., :2] != ref_state[..., :2]).any(-1).mean(-1)
        out["clusters_differ_share_max"] = max(
            out["clusters_differ_share_max"], float(moved.max()))


def compare_clips(loop: Clips, kept: dict, device) -> dict:
    """Run the reference over the frames of calls up to the last kept one
    and compare each kept call (t -> (labels, state after, state before)).
    With ``loop.follow`` each kept call starts from the program's state
    before it (call 0 from the seeding) and no other call runs.  Returns
    ``Judge``'s numbers."""
    judge = Judge(loop.cfg, device)
    if loop.follow:
        for t in sorted(kept):
            images, _ = loop.images(t)
            before = kept[t][2]
            st = (judge.seed(images) if t == 0
                  else slic_ref.state_from_yxmrgb(before, device))
            judge(*kept[t][:2], *judge.run(images, st))
    else:
        st = None
        for t in range(max(kept) + 1 if kept else 0):
            images, _ = loop.images(t)
            if st is None:
                st = judge.seed(images)
            ref = judge.run(images, st)
            if t in kept:
                judge(*kept[t][:2], *ref)
    return judge.out
