// SLIC assignment (standard, quantized variant) on the rows i % stride ==
// rem: one block a run of cells of one cell row, one thread a column and
// row group.
//
// Replaces fast_slic_tpu/pallas/assign_tpu.py:_assign_kernel (pallas_call
// in assign_pallas_standard).  The TPU kernel expanded per-cell candidate
// fields to pixels with 0/1 selection matmuls, because Mosaic has no
// gather; here a block gathers its cells' candidates (cand [GH, GW, C] from
// pipeline.build_candidates, visit-ordered, -1 = empty and always at the
// tail) from the [K, 5] f32 table (y, x, L, a, b) once.
//
// The argmin is the one of pipeline.assign_xla (fast_slic_tpu/pipeline.py
// :323-342): min over (dist << 7) | slot, so the lowest slot (the
// first-visited cluster) wins ties; dist = trunc(coef * spatial) + L1 colour
// distance inside the window |di|, |dj| <= S around the int-cast centre.
// The walk over a cell's slots stops at the first empty one.  The
// assignment is written in place on the processed rows where a candidate
// won; elsewhere the old value stays.  min_dists (optional) gets the
// winning dist, or 0xFFFF where nothing won.
//
// Bound on the card: at 720p stride 3 the call must move 4.9 MB (the
// planes' processed rows read, the assignment written; 1.5 us at 3.35
// TB/s) and does ~12 operations a visited slot.  A thread a pixel that
// loads each slot's id and then its five table fields is bound by L1 load
// throughput instead: a dependent load pair a slot, and a warp spanning two
// cells pays two wavefronts a load.  The design: a block owns whole cells (one
// cell row, up to 128 / S cells along j, one thread a column and kGroups
// row groups), gathers each cell's C candidates ONCE into shared memory as
// ints -- id, (int)y, (int)x, (int)L, (int)a, (int)b, the same truncation
// the distance takes -- with each cell's filled count, and each thread
// keeps the colours and the best packed distance of kRows processed rows of
// its column in registers.  The slot loop is outside and the row loop
// inside, so a record is read from shared memory once for all of a
// thread's rows, the column window test runs once a slot and the row test
// once a row.  A cell's records are C | 1 words apart, so the two cells a
// warp can span read from distinct banks.  The spatial term trunc(coef *
// spatial) is read from a per-block table over |di| + |dj| (Manhattan) or
// (|di|, |dj|) (Euclidean), filled with the same float operations, so the
// loop does no int-float conversion.  Each thread loads its own pixels (a
// warp reads 128 consecutive bytes a row); staging the rows in shared
// memory with 16-byte loads was slower (PERF.md §6, kernel designs that
// lost).  Stores
// go only to the processed rows.  What bounds it now is the slot loop's
// instruction count and the block's staging latency, one wave of blocks at
// B = 1.
//
// Frame axis: B stacked frames (planes [3, B, H, W], table [B, K, 5], cand
// [B, GH, GW, C], assignment and min_dists [B, H, W]; the stacked batch
// mode, the TPU kernel's frames= grid) run in one launch with the frame as
// blockIdx.z; all row and cell math stays frame-local, so B = 1 is the
// single-frame pass.
//
// Exactness: built with -fmad=false, so coef * sqrtf(di*di + dj*dj) rounds
// each operation as the JAX package does; coef arrives as the exact
// float32 that pipeline.derive_scalars computes on the host.  Cells are
// clamped at the grid edge (min(i / S, GH - 1)) as in the JAX package.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kUnassigned = 0xFFFF;
constexpr int kNone = 0x7FFFFFFF;
constexpr int kCols = 128;     // columns a block: one thread each
constexpr int kMaxCells = 8;   // cells a block at most (S < 16)
constexpr int kGroups = 2;     // row groups a block
constexpr int kRows = 4;       // processed rows a thread holds at once
constexpr int kMaxTable = 4096;  // entries of the spatial term's table

// blockDim (kCols, G): thread (t, g) takes columns j0 + t, j0 + t + kCols,
// ... and the step's rows g, g + G, ...; a block step covers G * R
// processed rows.  kTable: the spatial term trunc(coef * spatial) comes
// from a table over |di| + |dj| (Manhattan) or (|di|, |dj|) (Euclidean),
// filled by the block with the same float operations
template <int G, int R, bool kManhattan, bool kTable>
__global__ void __launch_bounds__(kCols * G)
assign_kernel(const int32_t* __restrict__ planes,
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
        for (int j = j0 + tx; j < j1; j += kCols) {
            int l0[R], l1[R], l2[R], best[R];
#pragma unroll
            for (int r = 0; r < R; ++r) {
                const int rr = r * G + g;  // row of the step
                best[r] = kNone;
                l0[r] = l1[r] = l2[r] = 0;
                if (rr < nr) {
                    const long long p =
                        f * n + (long long)(ib + rr * stride) * W + j;
                    l0[r] = planes[p];
                    l1[r] = planes[cs + p];
                    l2[r] = planes[2 * cs + p];
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

// one assign pass with G row groups of R rows a thread (kTab: with the
// spatial table where it fits)
template <int G, int R, bool kTab>
int run_assign(const void* planes, const void* table, const void* cand,
               void* assignment, void* min_dists, float coef, int H, int W,
               int S, int GH, int GW, int C, int stride, int rem,
               int manhattan, int K, int B, cudaStream_t stream) {
    if (rem < H && W > 0 && B > 0 && GH > 0 && GW > 0) {
        // S > kCols: one cell a block, its columns in turns
        const int ncells = min(max(kCols / S, 1), kMaxCells);
        const dim3 blocks((GW + ncells - 1) / ncells, GH, B);
        const dim3 threads(kCols, G);
        const int entries = manhattan ? 2 * S + 1 : (S + 1) * (S + 1);
        const bool tab = kTab && entries <= kMaxTable;
        const size_t shmem = (6 * ncells * (C | 1) + ncells +
                              (tab ? entries : 0)) * sizeof(int32_t);
        using Kernel = decltype(&assign_kernel<G, R, true, true>);
        const Kernel kernels[2][2] = {
            {assign_kernel<G, R, false, false>,
             assign_kernel<G, R, false, true>},
            {assign_kernel<G, R, true, false>,
             assign_kernel<G, R, true, true>}};
        kernels[manhattan != 0][tab]<<<blocks, threads, shmem, stream>>>(
            (const int32_t*)planes, (const float*)table,
            (const int32_t*)cand, (int32_t*)assignment, (int32_t*)min_dists,
            coef, H, W, S, GH, GW, C, stride, rem, K, B, ncells);
    }
    return (int)cudaGetLastError();
}

}  // namespace

// B frames of K clusters each (B = 1: one frame)
extern "C" int fstt_assign(const void* planes, const void* table,
                           const void* cand, void* assignment,
                           void* min_dists, float coef, int H, int W, int S,
                           int GH, int GW, int C, int stride, int rem,
                           int manhattan, int K, int B, void* stream) {
    return run_assign<kGroups, kRows, true>(
        planes, table, cand, assignment, min_dists, coef, H, W, S, GH, GW, C,
        stride, rem, manhattan, K, B, (cudaStream_t)stream);
}
