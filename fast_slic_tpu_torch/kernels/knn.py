"""Wrapper of the KNN kernel (``csrc/knn.cu``), which replaces the JAX
package's host C++ ``fstpu_knn`` (``fast_slic_tpu/native/cca_native.cpp``;
there is no TPU kernel for it).

:func:`knn_plain` is the plain version: the JAX package's executable spec
(``fast_slic_tpu/ops/graph.py:knn_python``) with the native helper's clamp
of a bucketed cell to the grid.  A CPU tensor goes to it; a CUDA tensor
launches the kernel.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import _lib

__all__ = ["knn", "knn_plain", "grid"]


def grid(H: int, W: int, K: int):
    """(S, nh, nw): the bucket size and the cell grid (fast-slic.cpp:86-88)."""
    S = max(int(math.sqrt(H * W // K)), 1)
    return S, -(-H // S), -(-W // S)


def _tdiv(a: int, b: int) -> int:
    """C integer division (truncation toward zero)."""
    q = abs(a) // b
    return q if a >= 0 else -q


def _heap_push(heap, item):
    heap.append(item)
    i = len(heap) - 1
    while i > 0:
        parent = (i - 1) // 2
        if heap[parent] < heap[i]:
            heap[parent], heap[i] = heap[i], heap[parent]
            i = parent
        else:
            break


def _heap_pop(heap):
    heap[0] = heap[-1]
    heap.pop()
    n, i = len(heap), 0
    while True:
        l, r = 2 * i + 1, 2 * i + 2
        big = i
        if l < n and heap[big] < heap[l]:
            big = l
        if r < n and heap[big] < heap[r]:
            big = r
        if big == i:
            break
        heap[i], heap[big] = heap[big], heap[i]
        i = big


def knn_plain(ys: torch.Tensor, xs: torch.Tensor, H: int, W: int, m: int):
    """Nearest-neighbour lists of the K centres (ys, xs float32 [K]) as
    (nbr [K, m] int32 in heap array order, padded with -1; counts [K]
    int32), by a host loop."""
    y = ys.detach().cpu().numpy().astype(np.float32, copy=False)
    x = xs.detach().cpu().numpy().astype(np.float32, copy=False)
    K, m = y.shape[0], max(int(m), 0)
    out = np.full((K, m), -1, np.int32)
    counts = np.zeros(K, np.int32)
    if K and m:
        S, nh, nw = grid(H, W, K)
        cells = [[] for _ in range(nh * nw)]
        for k in range(K):
            cy = min(max(_tdiv(int(y[k]), S), 0), nh - 1)
            cx = min(max(_tdiv(int(x[k]), S), 0), nw - 1)
            cells[cy * nw + cx].append(k)
        for k in range(K):
            cy, cx = _tdiv(int(y[k]), S), _tdiv(int(x[k]), S)
            heap = []  # max-heap of (distance, index); heap[0] is the max
            for gy in range(max(cy - 3, 0), min(nh, cy + 3)):
                for gx in range(max(cx - 3, 0), min(nw, cx + 3)):
                    for n in cells[gy * nw + gx]:
                        if n == k:
                            continue
                        # float32 |dx| + |dy|, then C int truncation
                        d = int(abs(x[n] - x[k]) + abs(y[n] - y[k]))
                        if heap and heap[0][0] <= d:
                            continue
                        _heap_push(heap, (d, n))
                        while len(heap) > m:
                            _heap_pop(heap)
            counts[k] = len(heap)
            out[k, :len(heap)] = [n for _, n in heap]
    return torch.from_numpy(out), torch.from_numpy(counts)


def knn(ys: torch.Tensor, xs: torch.Tensor, H: int, W: int, m: int):
    """(nbr [K, m] int32, counts [K] int32) on the centres' device; see
    :func:`knn_plain`."""
    if ys.shape != xs.shape or ys.ndim != 1:
        raise ValueError("ys and xs must be [K], got %s and %s"
                         % (tuple(ys.shape), tuple(xs.shape)))
    if ys.device.type == "cpu":
        return knn_plain(ys, xs, H, W, m)
    if ys.device.type != "cuda":
        raise ValueError("unsupported device %s" % ys.device)
    dev = ys.device
    _lib.check(ys, "ys", torch.float32, dev)
    _lib.check(xs, "xs", torch.float32, dev)
    K, m = ys.shape[0], max(int(m), 0)
    if K == 0 or m == 0:
        return (torch.full((K, m), -1, dtype=torch.int32, device=dev),
                torch.zeros(K, dtype=torch.int32, device=dev))
    S, nh, nw = grid(H, W, K)
    # bucket the clusters by their cell, clamped to the grid; a stable sort
    # keeps ascending cluster numbers within a cell
    cy = torch.clamp(torch.div(ys.to(torch.int32), S, rounding_mode="trunc"),
                     0, nh - 1)
    cx = torch.clamp(torch.div(xs.to(torch.int32), S, rounding_mode="trunc"),
                     0, nw - 1)
    cell = cy.to(torch.int64) * nw + cx
    sorted_ids = torch.sort(cell, stable=True).indices.to(torch.int32)
    # each cell's start in sorted_ids (no host sync, unlike bincount)
    counts = torch.zeros(nh * nw + 1, dtype=torch.int32, device=dev)
    counts.index_add_(0, cell + 1, torch.ones_like(cy))
    cell_start = torch.cumsum(counts, 0, dtype=torch.int32)
    heap = torch.empty((2, m + 1, K), dtype=torch.int32, device=dev)
    # the kernel writes every entry of both outputs
    out = torch.empty((K, m), dtype=torch.int32, device=dev)
    counts = torch.empty(K, dtype=torch.int32, device=dev)
    _lib.launch("fstt_knn", ys.data_ptr(), xs.data_ptr(),
                sorted_ids.data_ptr(), cell_start.data_ptr(), K, S, nh, nw,
                m, heap[0].data_ptr(), heap[1].data_ptr(), out.data_ptr(),
                counts.data_ptr())
    knn.launches += 1
    return out, counts


knn.launches = 0
