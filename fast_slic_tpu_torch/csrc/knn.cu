// Grid-bucketed K-nearest-neighbour lists over cluster centres, one thread
// per cluster.
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
// The wrapper (kernels/knn.py) buckets the clusters by cell with torch ops
// (a stable sort of the cell ids, ascending cluster number within a cell)
// and passes the sorted ids with the cells' start offsets.  The heap of
// m + 1 pairs lives in a device scratch [m + 1, K] (slot-major, so a warp's
// threads touch neighbouring words at each slot), since m is arbitrary.
//
// Bound on the card: neither bytes nor operations.  A call reads 8 bytes a
// cluster and writes 4 (m + 1); each thread visits ~36 candidates with a
// few operations each.  At K=1600 there are 13 warps, so the time is the
// latency of one thread's walk; the design keeps that walk to the loads of
// the candidates' centres (L1/L2 hits) and the heap's few slots.
//
// The distance is (int)(|dx| + |dy|) in float32, each operation rounded
// on its own (-fmad=false; there is no product to contract in any case).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// (d, n) tuple order, as std::pair<int, int> compares
__device__ __forceinline__ bool pair_less(int da, int na, int db, int nb) {
    return da < db || (da == db && na < nb);
}

__global__ void knn_kernel(const float* __restrict__ ys,
                           const float* __restrict__ xs,
                           const int32_t* __restrict__ sorted_ids,
                           const int32_t* __restrict__ cell_start,
                           int K, int S, int nh, int nw, int m,
                           int32_t* __restrict__ heap_d,
                           int32_t* __restrict__ heap_n,
                           int32_t* __restrict__ out,
                           int32_t* __restrict__ out_counts) {
    int k = blockIdx.x * blockDim.x + threadIdx.x;
    if (k >= K) return;
    // heap slot i of this thread lives at [i * K + k]
    int32_t* hd = heap_d + k;
    int32_t* hn = heap_n + k;
    const float yk = ys[k], xk = xs[k];
    // the query's cell, unclamped (C truncation, as the reference)
    int cy = (int)yk / S, cx = (int)xk / S;
    int gy0 = cy - 3 > 0 ? cy - 3 : 0;
    int gy1 = cy + 3 < nh ? cy + 3 : nh;
    int gx0 = cx - 3 > 0 ? cx - 3 : 0;
    int gx1 = cx + 3 < nw ? cx + 3 : nw;
    int size = 0;
    int top = 0;  // heap[0].d while size > 0
    for (int gy = gy0; gy < gy1; gy++) {
        for (int gx = gx0; gx < gx1; gx++) {
            int c = gy * nw + gx;
            int end = cell_start[c + 1];
            for (int p = cell_start[c]; p < end; p++) {
                int n = sorted_ids[p];
                if (n == k) continue;
                int d = (int)(fabsf(xs[n] - xk) + fabsf(ys[n] - yk));
                if (size > 0 && top <= d) continue;
                // push with sift-up
                int i = size++;
                while (i > 0) {
                    int parent = (i - 1) / 2;
                    int pd = hd[parent * K], pn = hn[parent * K];
                    if (!pair_less(pd, pn, d, n)) break;
                    hd[i * K] = pd;
                    hn[i * K] = pn;
                    i = parent;
                }
                hd[i * K] = d;
                hn[i * K] = n;
                // pop the maximum with sift-down while over m
                while (size > m) {
                    size--;
                    int xd = hd[size * K], xn = hn[size * K];
                    int j = 0;
                    for (;;) {
                        int l = 2 * j + 1, r = 2 * j + 2, big = j;
                        int bd = xd, bn = xn;
                        if (l < size) {
                            int ld = hd[l * K], ln = hn[l * K];
                            if (pair_less(bd, bn, ld, ln)) {
                                big = l; bd = ld; bn = ln;
                            }
                        }
                        if (r < size) {
                            int rd = hd[r * K], rn = hn[r * K];
                            if (pair_less(bd, bn, rd, rn)) {
                                big = r; bd = rd; bn = rn;
                            }
                        }
                        if (big == j) break;
                        hd[j * K] = bd;
                        hn[j * K] = bn;
                        j = big;
                    }
                    hd[j * K] = xd;
                    hn[j * K] = xn;
                }
                top = hd[0];
            }
        }
    }
    out_counts[k] = size;
    for (int i = 0; i < m; i++)
        out[(size_t)k * m + i] = i < size ? hn[i * K] : -1;
}

}  // namespace

extern "C" int fstt_knn(const void* ys, const void* xs,
                        const void* sorted_ids, const void* cell_start,
                        int K, int S, int nh, int nw, int m, void* heap_d,
                        void* heap_n, void* out, void* out_counts,
                        void* stream) {
    if (K > 0 && m > 0) {
        int threads = 128;
        int blocks = (K + threads - 1) / threads;
        knn_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
            (const float*)ys, (const float*)xs, (const int32_t*)sorted_ids,
            (const int32_t*)cell_start, K, S, nh, nw, m, (int32_t*)heap_d,
            (int32_t*)heap_n, (int32_t*)out, (int32_t*)out_counts);
    }
    return (int)cudaGetLastError();
}
