"""Wrappers of the KNN kernels (``csrc/knn.cu``), which replace the JAX
package's host C++ ``fstpu_knn`` (``fast_slic_tpu/native/cca_native.cpp``;
there is no TPU kernel for it).

:func:`knn_buckets` buckets the clusters by cell (``knn_buckets_kernel``;
plain version :func:`knn_buckets_plain`, torch ops); :func:`knn` runs it,
then the walk (``knn_kernel``; plain version :func:`knn_plain`, the JAX
package's executable spec ``fast_slic_tpu/ops/graph.py:knn_python`` with
the native helper's clamp of a bucketed cell to the grid).  A CPU tensor
goes to the plain version; a CUDA tensor launches the kernel.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import _lib

__all__ = ["knn", "knn_plain", "knn_buckets", "knn_buckets_plain", "grid"]

# knn_buckets_kernel: cells of its shared count table a pass, and clusters
# staged at a time for the ordered placement (4 * (49152 + 3 * 2048) bytes
# of shared memory at most)
BUCKET_RANGE = 49152
BUCKET_TILE = 2048
# knn_kernel: a block's shared memory on sm_90; a heap of more bytes lives
# in a device scratch, one for each of HEAP_WARPS warps
SMEM_MAX = 232448
HEAP_WARPS = 512


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


def knn_buckets_plain(ys: torch.Tensor, xs: torch.Tensor, H: int, W: int):
    """(sorted_ids [K], cell_start [nh * nw + 1]) int32 on the centres'
    device: the clusters bucketed by their cell (the centre's, clamped to
    the grid), ascending cluster number within a cell (a stable sort), and
    each cell's start in sorted_ids, by torch ops."""
    K = ys.shape[0]
    S, nh, nw = grid(H, W, K)
    cy = torch.clamp(torch.div(ys.to(torch.int32), S, rounding_mode="trunc"),
                     0, nh - 1)
    cx = torch.clamp(torch.div(xs.to(torch.int32), S, rounding_mode="trunc"),
                     0, nw - 1)
    cell = cy.to(torch.int64) * nw + cx
    sorted_ids = torch.sort(cell, stable=True).indices.to(torch.int32)
    # each cell's start in sorted_ids (no host sync, unlike bincount)
    counts = torch.zeros(nh * nw + 1, dtype=torch.int32, device=ys.device)
    counts.index_add_(0, cell + 1, torch.ones_like(cy))
    return sorted_ids, torch.cumsum(counts, 0, dtype=torch.int32)


def _check_centres(ys: torch.Tensor, xs: torch.Tensor):
    if ys.shape != xs.shape or ys.ndim != 1:
        raise ValueError("ys and xs must be [K], got %s and %s"
                         % (tuple(ys.shape), tuple(xs.shape)))
    if ys.device.type not in ("cpu", "cuda"):
        raise ValueError("unsupported device %s" % ys.device)
    if ys.device.type == "cuda":
        _lib.check(ys, "ys", torch.float32, ys.device)
        _lib.check(xs, "xs", torch.float32, ys.device)


def knn_buckets(ys: torch.Tensor, xs: torch.Tensor, H: int, W: int,
                out=None):
    """(sorted_ids, cell_start) on the centres' device, as
    :func:`knn_buckets_plain`; on the card written into ``out`` (two int32
    tensors [K] and [nh * nw + 1]) when given."""
    _check_centres(ys, xs)
    if ys.device.type == "cpu":
        return knn_buckets_plain(ys, xs, H, W)
    K = ys.shape[0]
    S, nh, nw = grid(H, W, K)
    if out is None:
        out = (torch.empty(K, dtype=torch.int32, device=ys.device),
               torch.empty(nh * nw + 1, dtype=torch.int32, device=ys.device))
    sorted_ids, cell_start = out
    _lib.check(sorted_ids, "sorted_ids", torch.int32, ys.device, (K,))
    _lib.check(cell_start, "cell_start", torch.int32, ys.device,
               (nh * nw + 1,))
    tile = min(BUCKET_TILE, -(-K // 32) * 32)
    _lib.launch("fstt_knn_buckets", ys.device, ys.data_ptr(), xs.data_ptr(),
                K, S, nh, nw, BUCKET_RANGE, tile, sorted_ids.data_ptr(),
                cell_start.data_ptr())
    return sorted_ids, cell_start


def knn(ys: torch.Tensor, xs: torch.Tensor, H: int, W: int, m: int,
        packed: bool = False):
    """(nbr [K, m] int32, counts [K] int32) on the centres' device; see
    :func:`knn_plain`.  ``packed``: one int32 tensor [K * m + K] instead,
    nbr's rows then counts, for a single download."""
    _check_centres(ys, xs)
    dev = ys.device
    K, m = ys.shape[0], max(int(m), 0)
    if dev.type == "cpu":
        nbr, counts = knn_plain(ys, xs, H, W, m)
        return torch.cat([nbr.reshape(-1), counts]) if packed else (nbr,
                                                                    counts)
    if K == 0 or m == 0:
        buf = torch.full((K * m + K,), -1, dtype=torch.int32, device=dev)
        buf[K * m:] = 0
    else:
        S, nh, nw = grid(H, W, K)
        cap = min(m, K - 1) + 1
        # a heap of more than a block's shared memory: a device scratch
        heap = 2 * HEAP_WARPS * cap if 8 * cap > SMEM_MAX else 0
        # one allocation: [heap scratch] nbr, counts | sorted_ids, cell_start
        # (the kernels write every entry but the scratch's)
        whole = torch.empty(heap + K * m + 2 * K + nh * nw + 1,
                            dtype=torch.int32, device=dev)
        buf = whole[heap:heap + K * m + K]
        rest = whole[heap + K * m + K:]
        sorted_ids, cell_start = knn_buckets(ys, xs, H, W,
                                             (rest[:K], rest[K:]))
        _lib.launch("fstt_knn", dev, ys.data_ptr(), xs.data_ptr(),
                    sorted_ids.data_ptr(), cell_start.data_ptr(), K, S, nh,
                    nw, m, whole.data_ptr() if heap else None, HEAP_WARPS,
                    buf.data_ptr(), buf[K * m:].data_ptr())
    return buf if packed else (buf[:K * m].view(K, m), buf[K * m:])
