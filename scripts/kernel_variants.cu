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
// segsum_variant: the segment sum, with a frame axis, as one global atomic
// a pixel and nonzero value, a thread a pixel (0: the design before the
// shared table, the library's framed_segment_sum kernel until it shared
// segment_sum's), or a lane's runs of four pixels summed in registers, each
// run adding to device memory (1: the runs without the table).

#include "../fast_slic_tpu_torch/csrc/cca.cu"
#include "../fast_slic_tpu_torch/csrc/assign.cu"
#include "../fast_slic_tpu_torch/csrc/assign_float.cu"

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

}  // namespace

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
