"""The copied bound arithmetic gives the bounds that PERF.md's kernel table
lists for 720p (bytes over 3.35 TB/s)."""

import math

import pytest

import roofline


@pytest.mark.parametrize("name,got,want", [
    ("lab", lambda: roofline.lab(720, 1280), 0.0041366662686567164),
    ("assign", lambda: roofline.assign(720, 1280, 1600, 24, 3, 0),
     0.0015077253731343285),
    ("slic_update", lambda: roofline.slic_update(720, 1280, 1600, 3, 0),
     0.0014786865671641792)])
def test_bounds_of_the_kernel_table(name, got, want):
    assert math.isclose(got() * 1e3, want, rel_tol=1e-12), name


def test_frame_bound_counts_every_pass():
    cfg = {"height": 720, "width": 1280, "num_components": 1600,
           "variant": "standard", "subsample_stride": 3, "max_iter": 10}
    t = roofline.frame(cfg)
    passes = sum(roofline.assign(720, 1280, 1600, 24, 3, i % 3)
                 + roofline.slic_update(720, 1280, 1600, 3, i % 3)
                 for i in range(10))
    assert t > passes + roofline.assign(720, 1280, 1600, 24, 1, 0)
    lsc = roofline.frame(dict(cfg, variant="lsc"))
    assert lsc > t
