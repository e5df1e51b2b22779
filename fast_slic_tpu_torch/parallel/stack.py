"""Stacked batch mode: B frames through one program with a frame axis.

The counterpart of ``fast_slic_tpu/parallel/stack.py``.  Every stage of
:mod:`fast_slic_tpu_torch.pipeline` takes a leading frame axis, so this
module only chains them and adds the frame-aware CCA:

* one LAB launch over the [B*H, W] stack (``pipeline.stage_setup`` with
  images [B, H, W, 3]);
* every [K] glue op of the loop is one [B, K] op: the clamp, the candidate
  build (:func:`build_candidates_batched`, a [B, 9K] row sort), the means
  and the preemptive step (``pipeline._preemptive_step`` on [B, K] fields);
* every pixel kernel runs once over the B frames with the frame as a grid
  axis and frame-local row and cell math: assign and float assign, the
  update sums over B*K bins (``slic_update``, or ``slic_update_masked``
  under the preemptive grid);
* one frame-aware CCA over the stack
  (``ops.cca.enforce_connectivity_framed_flagged``).

Like the single-frame loop, the loop keeps one full-resolution [B, H, W]
assignment whose rows i % stride == rem each iteration rewrites; the TPU's
per-remainder padded planes and the update's ``hmod`` row arithmetic are
not carried over.  Each frame's result equals the single-frame pipeline on
that frame (tests/test_torch_batch.py).  LSC is not stacked, as in the JAX
package.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..cluster import Clusters
from ..config import UNASSIGNED, VARIANT_LSC, StaticConfig
from ..ops.cca import enforce_connectivity_framed_flagged
from ..pipeline import (DerivedScalars, build_candidates_batched,  # noqa: F401
                        stage_full_assign, stage_loop, stage_setup)
from ..utils.timing import Timer

__all__ = ["StackOut", "build_candidates_batched", "iterate_graph_stacked"]


class StackOut(NamedTuple):
    labels: torch.Tensor          # int32 [B, H, W], -1 = unassigned
    clusters: Clusters            # [B, K] fields
    cca_tie: torch.Tensor         # bool [B]: top-K boundary tie per frame
    cand_overflow: torch.Tensor   # bool: re-run with more cand_slots
    raw_assignment: torch.Tensor  # int32 [B, H, W] pre-CCA, frame-local ids


def iterate_graph_stacked(images, st: Clusters, cfg: StaticConfig,
                          scalars: DerivedScalars, max_iter: int,
                          stride: int, timer=None) -> StackOut:
    """The full iterate() of B frames at once: images uint8 [B, H, W, 3] on
    the device of ``st``'s [B, K] fields; ``cfg`` is the single-frame
    configuration.  Needs B*K < 0xFFFF (the JAX package's limit, kept so
    both packages stack the same batches)."""
    if cfg.variant == VARIANT_LSC:
        raise NotImplementedError(
            "stacked batch mode does not cover LSC (use map mode)")
    B = images.shape[0]
    if B * cfg.K >= UNASSIGNED:
        raise ValueError("stacked batch needs B*K < 65535; got B=%d K=%d"
                         % (B, cfg.K))
    timer = timer or Timer(None)
    no_lsc = (None, None, None)
    with timer.scope("cielab_conversion"):
        planes, st, _ = stage_setup(images, st, cfg, scalars)
    with timer.scope("iteration_loop"):
        st, assignment, _, overflow = stage_loop(
            planes, st, no_lsc, cfg, scalars, max_iter, stride)
    with timer.scope("full_assign"):
        st, assignment, _, cov = stage_full_assign(
            planes, st, no_lsc, None, assignment, cfg, scalars)
    with timer.scope("enforce_connectivity"):
        labels, tie = enforce_connectivity_framed_flagged(
            assignment, cfg.K, int(scalars.thres))
        labels = torch.where(labels == UNASSIGNED, -1, labels)
    return StackOut(labels, st, tie, overflow | cov, assignment)
