"""``stills``: a new object of the configuration's class for every image
(preprocessing a set of photographs)."""

import numpy as np

import faults as slic_faults
import frames as frames_lib
import loops

control_entry = loops.control_entry
plant = slic_faults.plant_single

TINY = {"config": {"height": 72, "width": 96, "num_components": 24},
        "traffic": {"pool": 3, "warmup_calls": 1, "trace_calls": 2}}


def entry(cfg: dict, traffic: dict, device) -> loops.SingleEntry:
    return loops.SingleEntry(cfg, device)


def faults(cfg: dict) -> tuple:
    """A still's object is used once: no state is carried."""
    return tuple(f for f in slic_faults.SINGLE if f != "state unchanged")


class Loop(loops.Loop):
    """A pool drawn from the seed, large enough that the share of stills
    that tie at the top-K boundary (and pay the exact selection) settles
    from seed to seed; the seed orders it too."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device,
                 make_entry):
        super().__init__(cfg, traffic, make_entry)
        t = traffic
        self.pool = frames_lib.stills(cfg["height"], cfg["width"], t["pool"],
                                      t["crop_scale"], t["brightness"],
                                      t["noise_sigma"], seed, device)
        self.order = np.random.default_rng([int(seed), 5]).permutation(
            t["pool"])

    def images(self, t: int):
        """Call t's still [1, H, W, 3] and its id."""
        i = int(self.order[t % len(self.pool)])
        return self.pool[i:i + 1], (i,)

    def start(self):
        """No program to keep: a new one a call."""
        self.entry = None


def compare(loop: Loop, kept: dict, device) -> dict:
    """Each distinct kept still once through the reference from its
    seeding; ``loops.Judge``'s numbers."""
    judge = loops.Judge(loop.cfg, device)
    done = {}
    for t in sorted(kept):
        i = loop.images(t)[1][0]
        if i not in done:
            img = loop.pool[i:i + 1]
            done[i] = judge.run(img, judge.seed(img))
        judge(*kept[t][:2], *done[i])
    return judge.out
