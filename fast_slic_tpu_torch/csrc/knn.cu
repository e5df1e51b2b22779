// Grid-bucketed K-nearest-neighbour lists over cluster centres: the
// clusters bucketed by cell (knn_buckets_kernel), then a warp a cluster
// walks its window with its heap on chip (knn_kernel).
//
// Replaces fast_slic_tpu/native/cca_native.cpp:fstpu_knn, host C++ in the
// JAX package (no TPU kernel): the reference's walk (fast-slic.cpp:80-130)
// over the half-open 6x6-cell window [c-3, c+3) of the query's cell, cells
// in ascending (cy, cx), clusters in ascending number within a cell, with a
// bounded max-heap of (distance, index) pairs in tuple order.  Its quirk is
// kept: a candidate is rejected whenever its distance reaches the heap's
// maximum, even while the heap is not full; the output is the heap's array
// layout, padded with -1, and the count can be below m.
//
// Bound on the card: neither bytes nor operations.  A call reads 8 bytes a
// cluster and writes 4 (m + 1); a query visits ~33 candidates with a few
// operations each.  The time is latency: the launch, one CTA's count, scan
// and ordered placement, and each warp's walk, whose accepted candidates
// run one by one through the heap.  The designs keep those chains short.
//
// knn_buckets_kernel: one CTA of 1024 threads gives sorted_ids [K] (the
// clusters by cell, ascending cluster number within a cell: a stable
// counting sort) and cell_start [nh * nw + 1].  A cluster's cell is its
// centre's, clamped to the grid.  The count table lives in shared memory,
// range_cells cells of it a pass (a larger grid takes several passes:
// count, scan, place).  Counting is shared atomics; the scan is a thread's
// run of cells, then the warps'.  Placement keeps the order: `tile`
// clusters are staged at a time (each chunk of 32 consecutive clusters by
// one warp: its cell, and from __match_any_sync its rank among the chunk's
// clusters of the same cell and, on the group's last lane, the group's
// size; in one pass over one tile the count stages them too).  Then every
// warp walks the chunks in order, placing the clusters of its 1/32 of the
// cells: each goes to its cell's cursor plus its rank, and the group's last
// lane advances the cursor.  The clusters of a SLIC model are numbered in
// grid order, so a warp's cells sit in few chunks and it skips the rest.
//
// knn_kernel: a warp a query cluster.  The window's row gy is one run of
// sorted_ids, cell_start[gy * nw + gx0] .. cell_start[gy * nw + gx1], so
// the window is at most six runs, read in order as one sequence of
// candidates, 32 a batch (lane j the batch's j-th).  The heap's maximum
// never rises during a walk (an accepted candidate has d < top; a pop
// removes the maximum), so a candidate with d >= top, top read at the
// batch's start, is rejected by the walk too: the lanes compute their
// distances at once and drop those.  The survivors then run one by one in
// lane order (__ballot_sync, __ffs): lane 0 runs the exact push, sift-up
// and sift-down, and the lanes that the new top rejects are dropped, so
// every survivor run is an accept.  The heap of cap = min(m, K - 1) + 1
// pairs lives in shared memory, one a warp; where one warp's heap does not
// fit a block's shared memory, the same kernel keeps it in a device
// scratch, a fixed number of warps striding over the clusters.
//
// The distance is (int)(|dx| + |dy|) in float32, each operation rounded
// on its own (-fmad=false; there is no product to contract in any case).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kBucketThreads = 1024;
constexpr int kKnnWarps = 4;           // warps a block, fewer for big heaps
constexpr int kSmemMax = 232448;       // a block's shared memory on sm_90
constexpr int kWindowRows = 6;         // rows of the half-open window

// (d, n) tuple order, as std::pair<int, int> compares
__device__ __forceinline__ bool pair_less(int2 a, int2 b) {
    return a.x < b.x || (a.x == b.x && a.y < b.y);
}

// the centre's cell, clamped to the grid (C truncation, as the reference)
__device__ __forceinline__ int bucket_of(float y, float x, int S, int nh,
                                         int nw) {
    const int cy = min(max((int)y / S, 0), nh - 1);
    const int cx = min(max((int)x / S, 0), nw - 1);
    return cy * nw + cx;
}

// Stage cluster i of a tile (its warp's lanes hold 32 consecutive ones):
// its cell in the range (-1 outside it) and, in info, its rank among its
// chunk's clusters of that cell and, on the group's last lane, the group's
// size << 8.
__device__ __forceinline__ void stage(int32_t* st_cell, int32_t* st_info,
                                      int i, int cell) {
    const int lane = threadIdx.x & 31;
    const unsigned peers = __match_any_sync(kFull, cell);
    const int rank = __popc(peers & ((1u << lane) - 1));
    const int size = (peers >> lane) == 1u ? __popc(peers) : 0;
    st_cell[i] = cell;
    st_info[i] = rank | (size << 8);
}

__global__ void __launch_bounds__(kBucketThreads)
knn_buckets_kernel(const float* __restrict__ ys, const float* __restrict__ xs,
                   int K, int S, int nh, int nw, int range_cells, int tile,
                   int32_t* __restrict__ sorted_ids,
                   int32_t* __restrict__ cell_start) {
    // [range] count, then cursor; [tile] each: staged cell, staged rank,
    // slot
    extern __shared__ int32_t smem[];
    __shared__ int32_t warp_sum[kBucketThreads / 32];
    __shared__ int32_t range_total;
    const int ncell = nh * nw;
    const int range = min(range_cells, ncell);
    int32_t* table = smem;
    int32_t* st_cell = smem + range;
    int32_t* st_info = st_cell + tile;
    int32_t* st_dst = st_info + tile;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    // one range and one tile: the count stages the clusters too
    const bool fused = range == ncell && tile >= K;
    int base = 0;  // clusters in the cells before this range
    for (int c0 = 0; c0 < ncell; c0 += range) {
        const int n = min(range, ncell - c0);
        for (int i = tid; i < n; i += kBucketThreads) table[i] = 0;
        __syncthreads();
        for (int k = tid; k < ((K + 31) & ~31); k += kBucketThreads) {
            const unsigned c = k < K
                ? bucket_of(ys[k], xs[k], S, nh, nw) - c0 : ~0u;
            if (c < (unsigned)n) atomicAdd(&table[c], 1);
            if (fused) stage(st_cell, st_info, k, k < K ? (int)c : -1);
        }
        __syncthreads();
        // exclusive scan: a thread's run of cells, then the warps'
        const int per = (n + kBucketThreads - 1) / kBucketThreads;
        const int lo = min(tid * per, n), hi = min(lo + per, n);
        int sum = 0;
        for (int i = lo; i < hi; i++) sum += table[i];
        int incl = sum;
        for (int o = 1; o < 32; o <<= 1) {
            const int t = __shfl_up_sync(kFull, incl, o);
            if (lane >= o) incl += t;
        }
        if (lane == 31) warp_sum[warp] = incl;
        __syncthreads();
        if (warp == 0) {
            const int w = warp_sum[lane];
            int wi = w;
            for (int o = 1; o < 32; o <<= 1) {
                const int t = __shfl_up_sync(kFull, wi, o);
                if (lane >= o) wi += t;
            }
            warp_sum[lane] = wi - w;
            if (lane == 31) range_total = wi;
        }
        __syncthreads();
        int run = base + warp_sum[warp] + incl - sum;
        for (int i = lo; i < hi; i++) {
            const int c = table[i];
            table[i] = run;
            cell_start[c0 + i] = run;
            run += c;
        }
        // place the range's clusters, a tile at a time in cluster order
        for (int t0 = 0; t0 < K; t0 += tile) {
            const int tn = min(tile, K - t0);
            if (!fused) {
                __syncthreads();  // the last tile's scatter done
                for (int i = tid; i < ((tn + 31) & ~31); i += kBucketThreads) {
                    const int k = t0 + i;
                    const unsigned c = k < K
                        ? bucket_of(ys[k], xs[k], S, nh, nw) - c0 : ~0u;
                    stage(st_cell, st_info, i,
                          c < (unsigned)n ? (int)c : -1);
                }
            }
            __syncthreads();  // cursors and the staging written
            {
                // warp w places the clusters of its 1/32 of the range's
                // cells, all warps at once, each walking the chunks in
                // order; the next chunk's cells and ranks are read ahead
                const int lo = (int)((long long)n * warp / 32);
                const int hi = (int)((long long)n * (warp + 1) / 32);
                int c = lane < tn ? st_cell[lane] : -1;
                int info = lane < tn ? st_info[lane] : 0;
                for (int i = lane; i < ((tn + 31) & ~31); i += 32) {
                    const int c_next = i + 32 < tn ? st_cell[i + 32] : -1;
                    const int info_next = i + 32 < tn ? st_info[i + 32] : 0;
                    const bool mine = c >= lo && c < hi;
                    if (__any_sync(kFull, mine)) {
                        const int cur = mine ? table[c] : 0;
                        if (mine) st_dst[i] = cur + (info & 255);
                        __syncwarp();
                        if (mine && (info >> 8)) table[c] = cur + (info >> 8);
                        __syncwarp();
                    }
                    c = c_next;
                    info = info_next;
                }
            }
            __syncthreads();
            for (int i = tid; i < tn; i += kBucketThreads)
                if (st_cell[i] >= 0) sorted_ids[st_dst[i]] = t0 + i;
        }
        __syncthreads();
        base += range_total;
        __syncthreads();  // range_total read before the next range's scan
    }
    if (tid == 0) cell_start[ncell] = K;
}

// Push (d, n) into the heap h of `size` pairs with sift-up, then pop the
// maximum with sift-down if that makes more than m; returns the new top.
__device__ __forceinline__ int heap_insert(int2* h, int size, int m,
                                           int2 item) {
    int i = size;
    while (i > 0) {
        const int parent = (i - 1) >> 1;
        const int2 p = h[parent];
        if (!pair_less(p, item)) break;
        h[i] = p;
        i = parent;
    }
    h[i] = item;
    if (size + 1 > m) {  // size == m: back to m pairs
        const int2 x = h[m];
        int j = 0;
        for (;;) {
            const int l = 2 * j + 1, r = l + 1;
            int big = j;
            int2 b = x;
            if (l < m) {
                const int2 lv = h[l];
                if (pair_less(b, lv)) { big = l; b = lv; }
            }
            if (r < m) {
                const int2 rv = h[r];
                if (pair_less(b, rv)) { big = r; b = rv; }
            }
            if (big == j) break;
            h[j] = b;
            j = big;
        }
        h[j] = x;
    }
    return h[0].x;
}

template <bool kDeviceHeap>
__global__ void __launch_bounds__(kKnnWarps * 32)
knn_kernel(const float* __restrict__ ys, const float* __restrict__ xs,
           const int32_t* __restrict__ sorted_ids,
           const int32_t* __restrict__ cell_start, int K, int S, int nh,
           int nw, int m, int cap, int2* __restrict__ dev_heap,
           int32_t* __restrict__ out, int32_t* __restrict__ out_counts) {
    extern __shared__ int2 smem_heap[];
    const int lane = threadIdx.x & 31, wib = threadIdx.x >> 5;
    const int wpb = blockDim.x >> 5;
    const int gw = blockIdx.x * wpb + wib, nwarps = gridDim.x * wpb;
    int2* h = kDeviceHeap ? dev_heap + (size_t)gw * cap
                          : smem_heap + (size_t)wib * cap;
    for (int k = gw; k < K; k += nwarps) {
        const float yk = ys[k], xk = xs[k];
        // the query's cell, unclamped (C truncation, as the reference)
        const int cy = (int)yk / S, cx = (int)xk / S;
        const int gy0 = max(cy - 3, 0), gy1 = min(cy + 3, nh);
        const int gx0 = max(cx - 3, 0), gx1 = min(cx + 3, nw);
        // lane r reads window row gy0 + r's run of sorted_ids
        int rs = 0, rlen = 0;
        if (lane < gy1 - gy0 && gx0 < gx1) {
            const int c = (gy0 + lane) * nw;
            rs = cell_start[c + gx0];
            rlen = cell_start[c + gx1] - rs;
        }
        // candidate v of the window's sequence is sorted_ids[v + shift[r]]
        // for the first row r with v < end[r]
        int shift[kWindowRows], end[kWindowRows];
        int total = 0;
#pragma unroll
        for (int r = 0; r < kWindowRows; r++) {
            shift[r] = __shfl_sync(kFull, rs, r) - total;
            total += __shfl_sync(kFull, rlen, r);
            end[r] = total;
        }
        int size = 0, top = 0;  // top: the heap's maximum d while size > 0
        for (int b0 = 0; b0 < total; b0 += 32) {
            const int v = b0 + lane;
            int p = -1;
#pragma unroll
            for (int r = kWindowRows - 1; r >= 0; r--)
                if (v < end[r]) p = v + shift[r];
            int n = -1, d = 0;
            if (p >= 0) {
                n = sorted_ids[p];
                d = (int)(fabsf(xs[n] - xk) + fabsf(ys[n] - yk));
            }
            // every survivor is accepted: after each push the lanes that
            // the new top rejects are dropped
            unsigned surv = __ballot_sync(
                kFull, n >= 0 && n != k && (size == 0 || d < top));
            while (surv) {
                const int src = __ffs(surv) - 1;
                const int2 item = make_int2(__shfl_sync(kFull, d, src),
                                            __shfl_sync(kFull, n, src));
                int t = 0;
                if (lane == 0) t = heap_insert(h, size, m, item);
                top = __shfl_sync(kFull, t, 0);
                size = min(size + 1, m);
                surv &= __ballot_sync(kFull, d < top) & ~((2u << src) - 1);
            }
        }
        __syncwarp();
        for (int i = lane; i < m; i += 32)
            out[(size_t)k * m + i] = i < size ? h[i].y : -1;
        if (lane == 0) out_counts[k] = size;
        __syncwarp();  // the heap read before the next cluster's pushes
    }
}

}  // namespace

// sorted_ids [K] and cell_start [nh * nw + 1] (int32) of the K centres;
// range_cells cells of the count table a pass, tile clusters staged at a
// time (shared memory: 4 * (min(range_cells, nh * nw) + 3 * tile) bytes).
extern "C" int fstt_knn_buckets(const void* ys, const void* xs, int K, int S,
                                int nh, int nw, int range_cells, int tile,
                                void* sorted_ids, void* cell_start,
                                void* stream) {
    const int ncell = nh * nw;
    if (ncell < 1 || range_cells < 1 || tile < 32 || tile % 32)
        return (int)cudaErrorInvalidValue;
    const size_t smem = 4 * ((size_t)(range_cells < ncell ? range_cells
                                                          : ncell)
                             + 3 * (size_t)tile);
    if (smem + 4 * (kBucketThreads / 32 + 1) > (size_t)kSmemMax)
        return (int)cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            knn_buckets_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    knn_buckets_kernel<<<1, kBucketThreads, smem, (cudaStream_t)stream>>>(
        (const float*)ys, (const float*)xs, K, S, nh, nw, range_cells, tile,
        (int32_t*)sorted_ids, (int32_t*)cell_start);
    return (int)cudaGetLastError();
}

// nbr [K, m] and counts [K] (int32).  heap: null to keep each warp's heap
// in shared memory (it must fit: 8 * (min(m, K - 1) + 1) bytes at most
// kSmemMax), else a device scratch of heap_warps heaps of that many pairs,
// heap_warps a multiple of kKnnWarps.
extern "C" int fstt_knn(const void* ys, const void* xs,
                        const void* sorted_ids, const void* cell_start,
                        int K, int S, int nh, int nw, int m, void* heap,
                        int heap_warps, void* out, void* out_counts,
                        void* stream) {
    if (K <= 0 || m <= 0) return (int)cudaSuccess;
    const int cap = (m < K - 1 ? m : K - 1) + 1;
    const size_t per_warp = (size_t)cap * sizeof(int2);
    int warps = kKnnWarps;
    const float* y = (const float*)ys;
    const float* x = (const float*)xs;
    const int32_t* ids = (const int32_t*)sorted_ids;
    const int32_t* starts = (const int32_t*)cell_start;
    cudaStream_t s = (cudaStream_t)stream;
    if (heap) {
        if (heap_warps < kKnnWarps || heap_warps % kKnnWarps)
            return (int)cudaErrorInvalidValue;
        knn_kernel<true><<<heap_warps / kKnnWarps, warps * 32, 0, s>>>(
            y, x, ids, starts, K, S, nh, nw, m, cap, (int2*)heap,
            (int32_t*)out, (int32_t*)out_counts);
    } else {
        if (per_warp > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
        if ((size_t)kSmemMax / per_warp < (size_t)warps)
            warps = (int)(kSmemMax / per_warp);
        const size_t smem = warps * per_warp;
        if (smem > 48 * 1024) {
            cudaError_t err = cudaFuncSetAttribute(
                knn_kernel<false>,
                cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
            if (err != cudaSuccess) return (int)err;
        }
        knn_kernel<false><<<(K + warps - 1) / warps, warps * 32, smem, s>>>(
            y, x, ids, starts, K, S, nh, nw, m, cap, nullptr, (int32_t*)out,
            (int32_t*)out_counts);
    }
    return (int)cudaGetLastError();
}
