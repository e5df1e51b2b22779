// Variants of kernels of the library, beside which their designs were
// chosen, for scripts/kernel_variants.py.  The library's sources are
// included, so each variant shares everything but the part it changes.
//
// cc_variant: the CCA with its tile-local step as a union-find in shared
// memory (a 32x32 block, a thread a pixel; one union a pair of touching runs
// at the first column where they overlap, min-root linking with atomicMin,
// then each run start finds its root), optionally with path halving in the
// finds; the library's cc_seams and cc_flatten follow.
//
// assign_variant: the assign kernel with each step's rows of the planes
// staged in shared memory by 16-byte loads before the slot loop (0); the
// library's kernel with one row group of 8 rows a block (1), or without the
// spatial table (2).
//
// assign_float_variant: the library's float assign with G row groups of R
// consecutive rows a thread (a cell row's rows split over as many blocks as
// make one step each), the pixels loaded after the staging unless
// "prefetch" (the first step's before it): G=2, R=4, prefetch, with a
// thread's rows G apart, so that every thread's rows span the cell row (0,
// the first design); G=2, R=4, prefetch (1, the second); G=2, R=4 (2);
// G=1, R=8, prefetch (3); G=4, R=2, prefetch (4); G=2, R=2, prefetch (5);
// G=4, R=1, prefetch (6); G=1, R=4, prefetch (7, the third); G=1, R=2,
// prefetch (8); G=1, R=2 (9); G=1, R=4 (10, as the library).
//
// knn_variant: the KNN walk as PR 9 designed it, one thread a cluster
// over the window's cells with its heap in a device scratch [2, m + 1, K]
// (slot-major) (0); an empty kernel of one warp, the floor of any launch
// (1); the warp walk's first design (2); the library's walk with a heap of
// at most 32 pairs held by the lanes, lane j heap[j], its sift-up and
// sift-down done at once by ballots and shuffles (3).  knn_walk_variant
// and
// knn_buckets_variant: the library's two kernels cut short, for the time
// of their parts.
//
// segsum_variant: the segment sum, with a frame axis, as one global atomic
// a pixel and nonzero value, a thread a pixel (0: the design before the
// shared table, the library's framed_segment_sum kernel until it shared
// segment_sum's), or a lane's runs of four pixels summed in registers, each
// run adding to device memory (1: the runs without the table).

#include "../fast_slic_tpu_torch/csrc/cca.cu"
#include "../fast_slic_tpu_torch/csrc/assign.cu"
#include "../fast_slic_tpu_torch/csrc/assign_float.cu"
#include "../fast_slic_tpu_torch/csrc/knn.cu"

namespace {

__device__ __forceinline__ int find_halving(volatile int32_t* parent, int x) {
    while (true) {
        const int y = parent[x];
        if (y == x) return x;
        const int z = parent[y];
        if (z == y) return y;
        parent[x] = z;  // an ancestor: every later walk is shorter
        x = z;
    }
}

template <bool kHalve>
__device__ __forceinline__ void unite_shared(int32_t* parent, int a, int b) {
    while (true) {
        a = kHalve ? find_halving(parent, a) : find_root(parent, a);
        b = kHalve ? find_halving(parent, b) : find_root(parent, b);
        if (a == b) return;
        if (a > b) {
            const int t = a;
            a = b;
            b = t;
        }
        const int old = atomicMin(parent + b, a);
        if (old == b) return;
        b = old;
    }
}

template <bool kHalve>
__global__ void __launch_bounds__(kTile * kTile)
cc_local_union_find(const int32_t* __restrict__ labels,
                    int32_t* __restrict__ out, int H, int W) {
    __shared__ int32_t lab_s[kTile * kTile];
    __shared__ int32_t parent[kTile * kTile];
    __shared__ uint32_t run_starts[kTile];
    const int c = threadIdx.x, r = threadIdx.y;
    const int gi = blockIdx.y * kTile + r, gj = blockIdx.x * kTile + c;
    const bool valid = gi < H && gj < W;
    const int gp = gi * W + gj;
    const int lab = valid ? labels[gp] : 0;
    const int left = __shfl_up_sync(0xFFFFFFFFu, lab, 1);
    const bool start = c == 0 || left != lab;
    const uint32_t runs = __ballot_sync(0xFFFFFFFFu, start);
    const int s = 31 - __clz(runs & (0xFFFFFFFFu >> (31 - c)));
    const int p = r * kTile + c;
    lab_s[p] = lab;
    parent[p] = r * kTile + s;
    if (c == 0) run_starts[r] = runs;
    __syncthreads();
    if (valid && r > 0 && lab_s[p - kTile] == lab &&
        (start || ((run_starts[r - 1] >> c) & 1)))
        unite_shared<kHalve>(parent, p - kTile, p);
    __syncthreads();
    if (valid && start)
        parent[p] = kHalve ? find_halving(parent, p) : find_root(parent, p);
    __syncthreads();
    if (valid) {
        // with halving a run start may hold an ancestor short of its root;
        // the flatten pass follows it
        const int root = parent[r * kTile + s];
        out[gp] = (blockIdx.y * kTile + root / kTile) * W +
                  blockIdx.x * kTile + root % kTile;
    }
}

// the library's assign kernel with each step's rows of the three planes
// staged in shared memory by 16-byte loads (kVec), as one block, before the
// slot loop reads them
template <int G, int R, bool kVec, bool kManhattan, bool kTable>
__global__ void __launch_bounds__(kCols * G)
assign_staged(const int32_t* __restrict__ planes,
              const float* __restrict__ table,
              const int32_t* __restrict__ cand,
              int32_t* __restrict__ assignment,
              int32_t* __restrict__ min_dists, float coef, int H, int W,
              int S, int GH, int GW, int C, int stride, int rem, int K,
              int B, int ncells) {
    constexpr int kStep = G * R;
    // records: id, y, x, L, a, b of ncells * Cp slots, then ncells counts,
    // then the spatial table
    extern __shared__ int32_t rec[];
    __shared__ __align__(16) int32_t band[kVec ? 3 * kStep * kCols : 1];
    const int tx = threadIdx.x, g = threadIdx.y;
    const int tid = g * kCols + tx;
    const int ci = blockIdx.y, cj0 = blockIdx.x * ncells, f = blockIdx.z;

    // the processed rows of cell row ci (the last takes the rest of the
    // frame) and the columns of the block's cells
    const int r0 = ci * S;
    const int r1 = ci == GH - 1 ? H : min(r0 + S, H);
    const int i0 = r0 + (rem - r0 % stride + stride) % stride;
    if (i0 >= r1) return;
    const int nrows = (r1 - i0 + stride - 1) / stride;
    const int j0 = cj0 * S;
    const int j1 = cj0 + ncells >= GW ? W : min(j0 + ncells * S, W);
    const long long n = (long long)H * W;
    const long long cs = B * n;  // channel stride of planes

    // kVec: the step's rows of the three planes into shared memory, 16
    // bytes a thread (j1 - j0 <= kCols and a multiple of 4)
    auto load_band = [&](int ib, int nr) {
        const int nq = (j1 - j0) >> 2;
        const int plane_quads = nr * nq;
        for (int q = tid; q < 3 * plane_quads; q += kCols * G) {
            const int c = q / plane_quads;
            const int r = (q - c * plane_quads) / nq;
            const int x = q - c * plane_quads - r * nq;
            const long long p = c * cs + f * n +
                                (long long)(ib + r * stride) * W + j0 + 4 * x;
            *reinterpret_cast<int4*>(band + (c * kStep + r) * kCols + 4 * x) =
                __ldg(reinterpret_cast<const int4*>(planes + p));
        }
    };

    const int Cp = C | 1;
    const int per = ncells * Cp;
    int32_t* r_id = rec;
    int32_t* r_y = rec + per;
    int32_t* r_x = rec + 2 * per;
    int32_t* r_l = rec + 3 * per;
    int32_t* r_a = rec + 4 * per;
    int32_t* r_b = rec + 5 * per;
    int32_t* count = rec + 6 * per;
    int32_t* spt = count + ncells;
    const int cells = min(ncells, GW - cj0);
    if (tid < ncells) count[tid] = tid < cells ? C : 0;
    if (kTable) {
        const int side = S + 1;
        for (int d = tid; d < (kManhattan ? 2 * S + 1 : side * side);
             d += kCols * G) {
            float sp;
            if (kManhattan) {
                sp = coef * (float)d;
            } else {
                const float fi = (float)(d / side);
                const float fj = (float)(d % side);
                sp = coef * sqrtf(fi * fi + fj * fj);
            }
            spt[d] = (int)truncf(sp);
        }
    }
    if (kVec) load_band(i0, min(kStep, nrows));
    __syncthreads();
    const int32_t* ids = cand + (((long long)f * GH + ci) * GW + cj0) * C;
    const float* tab = table + (long long)f * K * 5;
    for (int q = tid; q < cells * C; q += kCols * G) {
        const int c = q / C;
        const int s = q - c * C;
        const int o = c * Cp + s;
        const int k = ids[q];
        r_id[o] = k;
        if (k < 0) {
            atomicMin(count + c, s);  // the walk stops at the first empty
            continue;
        }
        const float* e = tab + 5 * k;
        r_y[o] = (int)e[0];
        r_x[o] = (int)e[1];
        r_l[o] = (int)e[2];
        r_a[o] = (int)e[3];
        r_b[o] = (int)e[4];
    }
    __syncthreads();

    for (int rb = 0; rb < nrows; rb += kStep) {
        const int nr = min(kStep, nrows - rb);
        const int ib = i0 + rb * stride;  // first row of this step
        if (kVec && rb > 0) {
            __syncthreads();  // the previous step's rows are read
            load_band(ib, nr);
            __syncthreads();
        }
        for (int j = j0 + tx; j < j1; j += kCols) {
            const int t = j - j0;
            int l0[R], l1[R], l2[R], best[R];
#pragma unroll
            for (int r = 0; r < R; ++r) {
                const int rr = r * G + g;  // row of the step
                best[r] = kNone;
                l0[r] = l1[r] = l2[r] = 0;
                if (rr < nr) {
                    if (kVec) {
                        l0[r] = band[rr * kCols + t];
                        l1[r] = band[(kStep + rr) * kCols + t];
                        l2[r] = band[(2 * kStep + rr) * kCols + t];
                    } else {
                        const long long p =
                            f * n + (long long)(ib + rr * stride) * W + j;
                        l0[r] = planes[p];
                        l1[r] = planes[cs + p];
                        l2[r] = planes[2 * cs + p];
                    }
                }
            }
            const int cell = min(j / S, GW - 1) - cj0;
            const int base = cell * Cp;
            const int filled = count[cell];
            for (int s = 0; s < filled; ++s) {
                const int o = base + s;
                const int dj = j - r_x[o];
                const int adj = abs(dj);
                if (adj > S) continue;
                const int cy = r_y[o], cl = r_l[o], ca = r_a[o], cb = r_b[o];
                const float fj = (float)dj;
                const float fj2 = fj * fj;
#pragma unroll
                for (int r = 0; r < R; ++r) {
                    const int rr = r * G + g;
                    if (rr >= nr) break;
                    const int di = ib + rr * stride - cy;
                    const int adi = abs(di);
                    if (adi > S) continue;
                    int spatial;
                    if (kTable) {
                        spatial = spt[kManhattan ? adi + adj
                                                 : adi * (S + 1) + adj];
                    } else if (kManhattan) {
                        spatial = (int)truncf(coef * (float)(adi + adj));
                    } else {
                        const float fi = (float)di;
                        spatial = (int)truncf(coef * sqrtf(fi * fi + fj2));
                    }
                    const int dist = spatial + abs(l0[r] - cl) +
                                     abs(l1[r] - ca) + abs(l2[r] - cb);
                    best[r] = min(best[r], (dist << 7) | s);
                }
            }
#pragma unroll
            for (int r = 0; r < R; ++r) {
                const int rr = r * G + g;
                if (rr >= nr) break;
                const long long p =
                    f * n + (long long)(ib + rr * stride) * W + j;
                if (best[r] != kNone) {
                    assignment[p] = r_id[base + (best[r] & 0x7F)];
                    if (min_dists) min_dists[p] = best[r] >> 7;
                } else if (min_dists) {
                    min_dists[p] = kUnassigned;
                }
            }
        }
    }
}


template <int G, int R>
int run_staged(const void* planes, const void* table, const void* cand,
               void* assignment, void* min_dists, float coef, int H, int W,
               int S, int GH, int GW, int C, int stride, int rem,
               int manhattan, int K, int B, cudaStream_t stream) {
    const int ncells = min(max(kCols / S, 1), kMaxCells);
    if (!(W % 4 == 0 && S % 4 == 0 && ncells * S <= kCols &&
          ((uintptr_t)planes & 15) == 0))
        return (int)cudaErrorInvalidValue;
    const dim3 blocks((GW + ncells - 1) / ncells, GH, B);
    const int entries = manhattan ? 2 * S + 1 : (S + 1) * (S + 1);
    if (entries > kMaxTable) return (int)cudaErrorInvalidValue;
    const size_t shmem =
        (6 * ncells * (C | 1) + ncells + entries) * sizeof(int32_t);
    auto kernel = manhattan ? assign_staged<G, R, true, true, true>
                            : assign_staged<G, R, true, false, true>;
    kernel<<<blocks, dim3(kCols, G), shmem, stream>>>(
        (const int32_t*)planes, (const float*)table, (const int32_t*)cand,
        (int32_t*)assignment, (int32_t*)min_dists, coef, H, W, S, GH, GW, C,
        stride, rem, K, B, ncells);
    return (int)cudaGetLastError();
}

// ids [B, Nf] frame-local, vals [V, B, Nf], out [B, V, bins]: a thread a
// pixel, frame f in blockIdx.y (the library's framed_segment_sum before
// the shared table; at B = 1 the segment sum's design before it too)
__global__ void segsum_atomics(const int32_t* __restrict__ ids,
                               const int32_t* __restrict__ vals,
                               int32_t* __restrict__ out, int B, int Nf,
                               int V, int bins) {
    int p = blockIdx.x * blockDim.x + threadIdx.x;
    int f = blockIdx.y;
    if (p >= Nf) return;
    long long q = (long long)f * Nf + p;
    int k = ids[q];
    if (k < 0 || k >= bins) return;
    long long vs = (long long)B * Nf;
    int32_t* o = out + (long long)f * V * bins + k;
    for (int v = 0; v < V; ++v) {
        int x = vals[v * vs + q];
        if (x != 0) atomicAdd(o + (long long)v * bins, x);
    }
}

// a lane's four pixels (scalar loads), its runs summed in registers, the
// same layout
__global__ void segsum_runs(const int32_t* __restrict__ ids,
                            const int32_t* __restrict__ vals,
                            unsigned* __restrict__ out, int B, int Nf, int V,
                            int bins) {
    const long long f = blockIdx.y;
    const long long p = 4 * ((long long)blockIdx.x * blockDim.x + threadIdx.x);
    if (p >= Nf) return;
    ids += f * Nf;
    vals += f * Nf;
    out += f * V * bins;
    int id[4];
    for (int q = 0; q < 4; ++q) {
        id[q] = p + q < Nf ? ids[p + q] : -1;
        if (id[q] < 0 || id[q] >= bins) id[q] = -1;
    }
    for (int v = 0; v < V; ++v) {
        unsigned x[4];
        for (int q = 0; q < 4; ++q)
            x[q] = p + q < Nf ? vals[v * B * (long long)Nf + p + q] : 0;
        for (int q = 2; q >= 0; --q) x[q] += id[q] == id[q + 1] ? x[q + 1] : 0;
        for (int q = 0; q < 4; ++q)
            if (id[q] >= 0 && (q == 0 || id[q] != id[q - 1]) && x[q])
                atomicAdd(out + (long long)v * bins + id[q], x[q]);
    }
}

// one thread a cluster; heap slot i of cluster k at [i * K + k]
__global__ void knn_thread_kernel(const float* __restrict__ ys,
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
    int32_t* hd = heap_d + k;
    int32_t* hn = heap_n + k;
    const float yk = ys[k], xk = xs[k];
    int cy = (int)yk / S, cx = (int)xk / S;
    int gy0 = cy - 3 > 0 ? cy - 3 : 0;
    int gy1 = cy + 3 < nh ? cy + 3 : nh;
    int gx0 = cx - 3 > 0 ? cx - 3 : 0;
    int gx1 = cx + 3 < nw ? cx + 3 : nw;
    int size = 0;
    int top = 0;
    for (int gy = gy0; gy < gy1; gy++) {
        for (int gx = gx0; gx < gx1; gx++) {
            int c = gy * nw + gx;
            int end = cell_start[c + 1];
            for (int p = cell_start[c]; p < end; p++) {
                int n = sorted_ids[p];
                if (n == k) continue;
                int d = (int)(fabsf(xs[n] - xk) + fabsf(ys[n] - yk));
                if (size > 0 && top <= d) continue;
                int i = size++;
                while (i > 0) {
                    int parent = (i - 1) / 2;
                    int pd = hd[parent * K], pn = hn[parent * K];
                    if (!pair_less(make_int2(pd, pn), make_int2(d, n)))
                        break;
                    hd[i * K] = pd;
                    hn[i * K] = pn;
                    i = parent;
                }
                hd[i * K] = d;
                hn[i * K] = n;
                while (size > m) {
                    size--;
                    int xd = hd[size * K], xn = hn[size * K];
                    int j = 0;
                    for (;;) {
                        int l = 2 * j + 1, r = 2 * j + 2, big = j;
                        int bd = xd, bn = xn;
                        if (l < size) {
                            int ld = hd[l * K], ln = hn[l * K];
                            if (pair_less(make_int2(bd, bn),
                                          make_int2(ld, ln))) {
                                big = l; bd = ld; bn = ln;
                            }
                        }
                        if (r < size) {
                            int rd = hd[r * K], rn = hn[r * K];
                            if (pair_less(make_int2(bd, bn),
                                          make_int2(rd, rn))) {
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

__global__ void empty_kernel() {}

// the warp walk's first design: each batch survivor tested one by one
// against the current top (no drop of the lanes a new top rejects), the
// heap behind a generic pointer
__device__ int heap_insert_v1(int2* h, int size, int m, int2 item) {
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

__global__ void __launch_bounds__(kKnnWarps * 32)
knn_warp_v1(const float* __restrict__ ys, const float* __restrict__ xs,
           const int32_t* __restrict__ sorted_ids,
           const int32_t* __restrict__ cell_start, int K, int S, int nh,
           int nw, int m, int cap, int2* __restrict__ dev_heap,
           int32_t* __restrict__ out, int32_t* __restrict__ out_counts) {
    extern __shared__ int2 smem_heap[];
    const int lane = threadIdx.x & 31, wib = threadIdx.x >> 5;
    const int wpb = blockDim.x >> 5;
    const int gw = blockIdx.x * wpb + wib, nwarps = gridDim.x * wpb;
    int2* h = dev_heap ? dev_heap + (size_t)gw * cap
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
            unsigned surv = __ballot_sync(
                kFull, n >= 0 && n != k && (size == 0 || d < top));
            while (surv) {
                const int src = __ffs(surv) - 1;
                surv &= surv - 1;
                const int dn = __shfl_sync(kFull, d, src);
                const int nn = __shfl_sync(kFull, n, src);
                if (size > 0 && top <= dn) continue;
                int t = 0;
                if (lane == 0)
                    t = heap_insert_v1(h, size, m, make_int2(dn, nn));
                top = __shfl_sync(kFull, t, 0);
                size = min(size + 1, m);
            }
        }
        __syncwarp();
        for (int i = lane; i < m; i += 32)
            out[(size_t)k * m + i] = i < size ? h[i].y : -1;
        if (lane == 0) out_counts[k] = size;
        __syncwarp();  // the heap read before the next cluster's pushes
    }
}

// the library's bucketing cut short, for the time of its parts: stop 1
// after the count (and, in one pass, the staging), 2 after the scan, 3
// after the staging (no placement)
__global__ void __launch_bounds__(kBucketThreads)
knn_buckets_cut(int stop, const float* __restrict__ ys,
                const float* __restrict__ xs, int K, int S, int nh, int nw,
                int range_cells, int tile, int32_t* __restrict__ sorted_ids,
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
        if (stop == 1) return;
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
        if (stop == 2) return;
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
            if (stop == 3) return;
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

// the library's walk (its heaps in shared memory) cut short: stop 1 after
// reading the window's runs, 2 after the batches' loads, distances and
// ballots (no heap), 3 in full
__global__ void __launch_bounds__(kKnnWarps * 32)
knn_walk_cut(int stop, const float* __restrict__ ys,
             const float* __restrict__ xs,
           const int32_t* __restrict__ sorted_ids,
           const int32_t* __restrict__ cell_start, int K, int S, int nh,
           int nw, int m, int cap, int2* __restrict__ dev_heap,
           int32_t* __restrict__ out, int32_t* __restrict__ out_counts) {
    extern __shared__ int2 smem_heap[];
    const int lane = threadIdx.x & 31, wib = threadIdx.x >> 5;
    const int wpb = blockDim.x >> 5;
    const int gw = blockIdx.x * wpb + wib, nwarps = gridDim.x * wpb;
    int2* h = false ? dev_heap + (size_t)gw * cap
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
        for (int b0 = 0; b0 < total && stop > 1; b0 += 32) {
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
            if (stop == 2) size += __popc(surv) > 0;
            while (surv && stop == 3) {
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

// The heap of at most 32 pairs held by the warp's lanes, lane j heap[j]
// as (hd, hn): push (d, n) at position i with the sift-up done at once.
// The ancestors of i that are less than the item are a run at the bottom
// of the path (the heap's values fall from the root down), so each of
// them, and i, takes its parent's value, but the highest, which takes the
// item.
__device__ __forceinline__ void lanes_push(int& hd, int& hn, int lane, int i,
                                           int2 item) {
    // 1-based numbering: node q is an ancestor (or self) of node p when
    // p's leading bits are q
    const int q = lane + 1, p = i + 1;
    const int dl = __clz(q) - __clz(p);
    const bool anc = dl >= 0 && (p >> dl) == q;
    const bool less = anc && lane != i && pair_less(make_int2(hd, hn), item);
    const unsigned less_mask = __ballot_sync(kFull, less);
    const int parent = lane > 0 ? (lane - 1) >> 1 : 0;
    const int pd = __shfl_sync(kFull, hd, parent);
    const int pn = __shfl_sync(kFull, hn, parent);
    if (anc && (lane == i || less)) {
        const bool shift = lane > 0 && ((less_mask >> parent) & 1);
        hd = shift ? pd : item.x;
        hn = shift ? pn : item.y;
    }
}

// Pop the maximum of the lanes' heap of m + 1 pairs (m <= 31): the last
// pair x sifts down from the root.  Its path goes to the larger child
// while that child exceeds x; each node on it moves up to its parent and x
// lands on the path's last node.
__device__ __forceinline__ void lanes_pop(int& hd, int& hn, int lane, int m) {
    const int2 x = make_int2(__shfl_sync(kFull, hd, m),
                             __shfl_sync(kFull, hn, m));
    const int2 me = make_int2(hd, hn);
    const int sib = (lane & 1) ? lane + 1 : lane - 1;
    const int2 sv = make_int2(__shfl_sync(kFull, hd, sib & 31),
                              __shfl_sync(kFull, hn, sib & 31));
    const bool larger = sib < 1 || sib >= m || pair_less(sv, me);
    const bool step = lane >= 1 && lane < m && larger && pair_less(x, me);
    const unsigned step_mask = __ballot_sync(kFull, step);
    bool on = step;  // every node from here up to the root's child steps
    for (int a = (lane - 1) >> 1; on && a > 0; a = (a - 1) >> 1)
        on = (step_mask >> a) & 1;
    const unsigned on_mask = __ballot_sync(kFull, on);
    const int l = 2 * lane + 1, r = l + 1;
    const int ld = __shfl_sync(kFull, hd, l & 31);
    const int ln = __shfl_sync(kFull, hn, l & 31);
    const int rd = __shfl_sync(kFull, hd, r & 31);
    const int rn = __shfl_sync(kFull, hn, r & 31);
    if (lane < m) {
        if (l < 32 && ((on_mask >> l) & 1)) {
            hd = ld;
            hn = ln;
        } else if (r < 32 && ((on_mask >> r) & 1)) {
            hd = rd;
            hn = rn;
        } else if (lane == 0 || ((on_mask >> lane) & 1)) {
            hd = x.x;
            hn = x.y;
        }
    }
}

// the library's walk with the heap of at most 32 pairs in the lanes
__global__ void __launch_bounds__(kKnnWarps * 32)
knn_walk_lanes(const float* __restrict__ ys,
               const float* __restrict__ xs,
           const int32_t* __restrict__ sorted_ids,
           const int32_t* __restrict__ cell_start, int K, int S, int nh,
           int nw, int m, int cap, int2* __restrict__ dev_heap,
           int32_t* __restrict__ out, int32_t* __restrict__ out_counts) {
    const int lane = threadIdx.x & 31, wib = threadIdx.x >> 5;
    const int wpb = blockDim.x >> 5;
    const int gw = blockIdx.x * wpb + wib, nwarps = gridDim.x * wpb;
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
        int hd = 0, hn = 0;     // this lane's pair of the heap
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
                lanes_push(hd, hn, lane, size, item);
                if (size + 1 > m) lanes_pop(hd, hn, lane, m);
                top = __shfl_sync(kFull, hd, 0);
                size = min(size + 1, m);
                surv &= __ballot_sync(kFull, d < top) & ~((2u << src) - 1);
            }
        }
        for (int i = lane; i < m; i += 32)
            out[(size_t)k * m + i] = i < size ? hn : -1;
        if (lane == 0) out_counts[k] = size;
    }
}

}  // namespace

// v 0: one thread a cluster (heap_d, heap_n: [m + 1, K] each), 1: an empty
// launch (every other argument unused), 2: the warp walk's first design
// (its heaps in shared memory; heap_d, heap_n unused), 3: the library's
// walk with its heap in the lanes (heaps of at most 32 pairs)
extern "C" int knn_variant(int v, const void* ys, const void* xs,
                           const void* sorted_ids, const void* cell_start,
                           int K, int S, int nh, int nw, int m, void* heap_d,
                           void* heap_n, void* out, void* out_counts,
                           void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (v == 1) {
        empty_kernel<<<1, 32, 0, s>>>();
    } else if (v == 2) {
        const int cap = (m < K - 1 ? m : K - 1) + 1;
        knn_warp_v1<<<(K + kKnnWarps - 1) / kKnnWarps, kKnnWarps * 32,
                      kKnnWarps * cap * sizeof(int2), s>>>(
            (const float*)ys, (const float*)xs, (const int32_t*)sorted_ids,
            (const int32_t*)cell_start, K, S, nh, nw, m, cap, nullptr,
            (int32_t*)out, (int32_t*)out_counts);
    } else if (v == 3) {
        if ((m < K - 1 ? m : K - 1) + 1 > 32)
            return (int)cudaErrorInvalidValue;
        knn_walk_lanes<<<(K + kKnnWarps - 1) / kKnnWarps, kKnnWarps * 32, 0,
                         s>>>(
            (const float*)ys, (const float*)xs, (const int32_t*)sorted_ids,
            (const int32_t*)cell_start, K, S, nh, nw, m, 0, nullptr,
            (int32_t*)out, (int32_t*)out_counts);
    } else if (K > 0 && m > 0) {
        knn_thread_kernel<<<(K + 127) / 128, 128, 0, s>>>(
            (const float*)ys, (const float*)xs, (const int32_t*)sorted_ids,
            (const int32_t*)cell_start, K, S, nh, nw, m, (int32_t*)heap_d,
            (int32_t*)heap_n, (int32_t*)out, (int32_t*)out_counts);
    }
    return (int)cudaGetLastError();
}

// the walk cut at `stop` (see knn_walk_cut), its heaps in shared memory,
// as fstt_knn launches it; K may be below the buckets' count, to walk the
// first K clusters only
extern "C" int knn_walk_variant(int stop, const void* ys, const void* xs,
                                const void* sorted_ids,
                                const void* cell_start, int K, int S, int nh,
                                int nw, int m, void* out, void* out_counts,
                                void* stream) {
    const int cap = (m < K - 1 ? m : K - 1) + 1;
    knn_walk_cut<<<(K + kKnnWarps - 1) / kKnnWarps, kKnnWarps * 32,
                   kKnnWarps * cap * sizeof(int2), (cudaStream_t)stream>>>(
        stop, (const float*)ys, (const float*)xs, (const int32_t*)sorted_ids,
        (const int32_t*)cell_start, K, S, nh, nw, m, cap, nullptr,
        (int32_t*)out, (int32_t*)out_counts);
    return (int)cudaGetLastError();
}

// the bucketing cut at `stop` (see knn_buckets_cut), as fstt_knn_buckets
// launches it
extern "C" int knn_buckets_variant(int stop, const void* ys, const void* xs,
                                   int K, int S, int nh, int nw,
                                   int range_cells, int tile,
                                   void* sorted_ids, void* cell_start,
                                   void* stream) {
    const int ncell = nh * nw;
    const size_t smem = 4 * ((size_t)(range_cells < ncell ? range_cells
                                                          : ncell)
                             + 3 * (size_t)tile);
    knn_buckets_cut<<<1, kBucketThreads, smem, (cudaStream_t)stream>>>(
        stop, (const float*)ys, (const float*)xs, K, S, nh, nw, range_cells,
        tile, (int32_t*)sorted_ids, (int32_t*)cell_start);
    return (int)cudaGetLastError();
}

// v 0: union-find local step, 1: the same with path halving
extern "C" int cc_variant(int v, const void* labels, void* out, int H, int W,
                          void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    const int32_t* lab = (const int32_t*)labels;
    int32_t* o = (int32_t*)out;
    dim3 tiles((W + kTile - 1) / kTile, (H + kTile - 1) / kTile);
    if (v == 0)
        cc_local_union_find<false><<<tiles, dim3(kTile, kTile), 0, s>>>(
            lab, o, H, W);
    else
        cc_local_union_find<true><<<tiles, dim3(kTile, kTile), 0, s>>>(
            lab, o, H, W);
    const int row_seams = tiles.y - 1, col_seams = tiles.x - 1;
    const int seam_pixels = row_seams * W + col_seams * H;
    const int n = H * W;
    if (seam_pixels > 0) {
        cc_seams<<<(seam_pixels + 255) / 256, 256, 0, s>>>(
            lab, o, H, W, row_seams, col_seams);
    }
    cc_flatten<<<(n + 255) / 256, 256, 0, s>>>(o, n);
    return (int)cudaGetLastError();
}

// v 0: 16-byte staged rows, 1: one row group of 8 rows, 2: no table
extern "C" int assign_variant(int v, const void* planes, const void* table,
                              const void* cand, void* assignment,
                              void* min_dists, float coef, int H, int W,
                              int S, int GH, int GW, int C, int stride,
                              int rem, int manhattan, int K, int B,
                              void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (v == 0)
        return run_staged<kGroups, kRows>(planes, table, cand, assignment,
                                          min_dists, coef, H, W, S, GH, GW, C,
                                          stride, rem, manhattan, K, B, s);
    if (v == 1)
        return run_assign<1, 8, true>(planes, table, cand, assignment,
                                      min_dists, coef, H, W, S, GH, GW, C,
                                      stride, rem, manhattan, K, B, s);
    return run_assign<kGroups, kRows, false>(planes, table, cand, assignment,
                                             min_dists, coef, H, W, S, GH, GW,
                                             C, stride, rem, manhattan, K, B,
                                             s);
}

// v: the variant numbers above
extern "C" int assign_float_variant(
    int v, const void* planes, const void* feats, const void* table,
    const void* cent, const void* cand, void* assignment, void* min_dists,
    float coef, int H, int W, int S, int GH, int GW, int C, int stride,
    int rem, int variant, int manhattan, int K, int B, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
#define FSTT_VARIANT(G, R, P, SP)                                            \
    fassign::run_assign_float<G, R, P, SP>(                                  \
        planes, feats, table, cent, cand, assignment, min_dists, coef, H, W, \
        S, GH, GW, C, stride, rem, variant, manhattan, K, B, s)
    switch (v) {
        case 0: return FSTT_VARIANT(2, 4, true, true);
        case 1: return FSTT_VARIANT(2, 4, true, false);
        case 2: return FSTT_VARIANT(2, 4, false, false);
        case 3: return FSTT_VARIANT(1, 8, true, false);
        case 4: return FSTT_VARIANT(4, 2, true, false);
        case 5: return FSTT_VARIANT(2, 2, true, false);
        case 6: return FSTT_VARIANT(4, 1, true, false);
        case 7: return FSTT_VARIANT(1, 4, true, false);
        case 8: return FSTT_VARIANT(1, 2, true, false);
        case 9: return FSTT_VARIANT(1, 2, false, false);
        default: return FSTT_VARIANT(1, 4, false, false);
    }
#undef FSTT_VARIANT
}

// v 0: a global atomic a pixel and value, 1: a lane's runs to device
// memory; ids [B, Nf], vals [V, B, Nf], out [B, V, bins] ([V, bins] at B=1)
extern "C" int segsum_variant(int v, const void* ids, const void* vals,
                              void* out, int B, int Nf, int V, int bins,
                              void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (v == 0)
        segsum_atomics<<<dim3((Nf + 255) / 256, B), 256, 0, s>>>(
            (const int32_t*)ids, (const int32_t*)vals, (int32_t*)out, B, Nf,
            V, bins);
    else
        segsum_runs<<<dim3((Nf + 1023) / 1024, B), 256, 0, s>>>(
            (const int32_t*)ids, (const int32_t*)vals, (unsigned*)out, B, Nf,
            V, bins);
    return (int)cudaGetLastError();
}
