"""PyTorch port: the plain path at the size the card runs (1280x720,
K=1600) against the JAX package's results in
``tests/data/port_720p_ref.npz`` (``scripts/make_port_fixture_720p.py``,
arch "standard" on the CPU), on the frames of chip_smoke.py:

* ``Slic(num_components=1600)`` over four frames, carrying its clusters
  from frame to frame: each frame's labels and final clusters;
* ``BatchedSlic(num_components=1600, batch_mode="stack")`` over two
  batches of four frames: each batch's labels (the stacked path, with its
  per-frame segment sum and framed CCA).

Exact.  chip_smoke.py holds the card's runs of the same frames against the
same file.
"""

import os

import numpy as np
import pytest
import torch

from chip_smoke import BATCH, H720, K720, W720, make_frames
from fast_slic_tpu_torch import Slic
from fast_slic_tpu_torch.parallel.batch import BatchedSlic
from torch_threads import one_torch_thread  # noqa: F401

REF = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                   "port_720p_ref.npz")


@pytest.fixture(scope="module")
def ref():
    return np.load(REF)


def test_slice_720p_matches_jax_fixture(ref):
    slic = Slic(num_components=K720, device="cpu")
    frames = make_frames(4, H720, W720)
    assert len(frames) == len(ref["slice_labels"])
    for i, f in enumerate(frames):
        labels = slic.iterate(f)
        assert labels.dtype == np.int16
        np.testing.assert_array_equal(labels, ref["slice_labels"][i],
                                      err_msg="frame %d labels" % i)
        np.testing.assert_array_equal(
            slic.slic_model.to_yxmrgb().astype(np.float32),
            ref["slice_clusters"][i], err_msg="frame %d clusters" % i)


def test_stacked_batches_720p_match_jax_fixture(ref):
    bs = BatchedSlic(num_components=K720, batch_mode="stack", device="cpu")
    more = make_frames(2 * BATCH, H720, W720, seed=1)
    for t in range(2):
        labels = bs.iterate(np.stack(more[t * BATCH:(t + 1) * BATCH]))
        assert isinstance(labels, torch.Tensor)
        np.testing.assert_array_equal(labels.numpy(), ref["batch_labels"][t],
                                      err_msg="batch %d labels" % t)
