// SLIC assignment with float distances (real, real_l2, real_noq, lsc) on the
// rows i % stride == rem: one block a run of cells of one cell row, one
// thread a column and row group.
//
// Replaces fast_slic_tpu/pallas/assign_tpu.py:_assign_kernel_float
// (pallas_call in assign_pallas_float), which serves all four variants.
// The TPU kernel expanded every per-cell candidate field (y, x, r, g, b, id
// and, for LSC, the ten centroid features) to pixels with bf16
// mantissa-split selection matmuls, because Mosaic has no gather; here a
// block gathers its cells' candidates (cand [GH, GW, C] from
// pipeline.build_candidates, visit-ordered, -1 = empty and always at the
// tail) from the [K, 5] f32 table (y, x, L, a, b) and, for LSC, the [K, 10]
// f32 centroid features once.
//
// The winner is the first slot with a strictly smaller distance (the
// reference's first-writer tie rule, assign_tpu.py:432): slots are visit
// ordered, so `dist < md` over slots in order reproduces it.  Where a
// candidate won, the assignment is written in place and min_dists (optional)
// gets its distance; where none did, the old assignment stays and min_dists
// gets FLT_MAX (assign_tpu.py:452).
//
// Distances, operation for operation as fast_slic_tpu/pipeline.assign_xla
// and the Pallas kernel compute them (assign_tpu.py:372-429):
//   real      window |i - (int)cy| <= S, |j - (int)cx| <= S;
//             sp = coef * sqrtf(di*di + dj*dj), or coef * (float)(|di|+|dj|)
//             when manhattan; dist = sp + (float)(L1 of the int-cast colour)
//   real_l2   sp = (coef*di)^2 + (coef*dj)^2; dist = sp + dr^2 + dg^2 + db^2
//             on the int-cast colour, summed left to right
//   real_noq  float centre; window y_lo = max((int)trunc(cy - S), 0),
//             y_hi = min((int)trunc((cy + S) + 1), H) (two float roundings,
//             in this order), likewise x; dr = (float)L - r, ...,
//             dy = coef * ((float)i - cy), dx = coef * ((float)j - cx);
//             dist = |dr|+|dg|+|db|+|dx|+|dy| (manhattan) or
//             dr^2+dg^2+db^2+dx^2+dy^2, left to right
//   lsc       window as real; dist = sum over channels 0..9 of d*d with
//             d = feat - centroid, accumulated from 0.0f in channel order
// The library is built with -fmad=false, so every product and sum above is
// rounded on its own, as the JAX package's _nofma forces on the TPU.
//
// Bound on the card: at 720p stride 3 the call must move 4.9 MB (13.5 MB
// for LSC, whose ten feature planes are read instead of the three colour
// planes) and does 14-30 float operations a visited slot, so it is bound by
// its bytes (1.5 us, LSC 4.0).  A thread a pixel that loads each slot's id
// and then gathers its table fields (LSC: twelve floats) is bound by L1
// load issue instead: a chain of dependent loads a slot, and a warp
// spanning two cells pays two wavefronts a gather.  The design, as the
// quantized assign's (csrc/assign.cu): a block owns whole cells (one cell
// row, up to 128 / S cells along j, one thread a column) and gathers each
// cell's C candidates ONCE into shared memory as the record its variant
// reads, with each cell's filled count:
//   real, real_l2  id, (int)cy, (int)cx, (int)L, (int)a, (int)b   8 words
//   real_noq       id, x_lo, x_hi, y_lo, y_hi (the float window above,
//                  computed once a slot), cy, cx, L, a, b          12 words
//   lsc            id, (int)cy, (int)cx, the ten centroid floats   16 words
// Records are 16-byte multiples, read as int4 loads (the first one holds
// the column window, the rest are read only for a slot in it), and a
// cell's records are C | 1 records apart, so the two cells a warp can span
// read from distinct banks.  Each thread keeps the colours (LSC: the ten
// features), the best distance and the best slot of kRows consecutive
// processed rows of its column in registers; the slot loop is outside and
// the row loop inside, so a record is read once for all of a thread's rows,
// the column window test runs once a slot and the row test once a row.  A
// warp's rows are consecutive too, so it skips the slots whose row window
// misses them all (about a third of a 3x3 neighbourhood): with a thread's
// rows spread over its cell row, every warp computed every slot, and LSC,
// whose distance is 30 float operations a row, ran no faster than a thread
// a pixel.  A cell row's processed rows split over as many blocks as make
// one step each, and each of those blocks stages the cells' records.
// The spatial term of real and real_l2 comes from a table over |di| + |dj|
// (Manhattan) or (|di|, |dj|), filled with the same float operations
// (exact: negation is exact, so (coef * -d)^2 == (coef * d)^2 and
// sqrtf((-d)^2 + ...) == sqrtf(d^2 + ...)); real_noq's depends on the float
// centre and is computed in the loop.  Each thread loads its own pixels
// after the staging and stores only to the processed rows.
//
// Shape (PERF.md §6, kernel designs that lost; on the H100): 128 threads
// a block, one row group of kRows = 4 rows a thread, so a cell row's 8
// processed rows at stride 3 take 2 blocks (660 at 720p) and its 24 at
// stride 1 take 6.  Two row groups, 8 rows a thread, 2 rows a thread, and
// loading the first step's pixels before the staging were each slower.  What
// bounds it now is latency, not bytes or operations: a block runs its
// three phases in turn (stage the records, load its pixels, walk the
// slots), LSC keeps 91 registers a thread (so at most five blocks an SM),
// and each LSC slot a warp visits costs 30 float operations a row.
//
// Frame axis: B stacked frames (planes [3, B, H, W], feats [10, B, H, W],
// table [B, K, 5], cent [B, K, 10], cand [B, GH, GW, C], assignment and
// min_dists [B, H, W]; the stacked batch mode, the TPU kernel's frames=
// grid) run in one launch with the frame as blockIdx.z; all row and cell
// math stays frame-local, so B = 1 is the single-frame pass.  Cells are
// clamped at the grid edge (min(i / S, GH - 1)) as in the JAX package.

#include <cfloat>
#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace {
// a named namespace, its names apart from csrc/assign.cu's
namespace fassign {

enum Variant { kReal = 0, kRealL2 = 1, kRealNoq = 2, kLsc = 3 };
constexpr int kFeat = 10;
constexpr int kCols = 128;       // columns a block: one thread each
constexpr int kMaxCells = 8;     // cells a block at most (S < 16)
constexpr int kGroups = 1;       // row groups a block
constexpr int kRows = 4;         // processed rows a thread holds at once
constexpr int kMaxTable = 4096;  // entries of the spatial term's table

// words of a staged candidate record
template <int V>
__host__ __device__ constexpr int record_words() {
    return V == kLsc ? 16 : V == kRealNoq ? 12 : 8;
}

// the per-pixel values a thread holds: the int colours (real, real_l2),
// the colours as floats (real_noq) or the ten LSC features
template <int V>
struct Pixel {
    static constexpr int kN = V == kLsc ? kFeat : 3;
    using T = typename std::conditional<V == kLsc || V == kRealNoq, float,
                                        int>::type;
};

// row r < R of a thread of row group gg (of GT) within a step of GT * R
// processed rows: R consecutive rows a thread, or (kSpread) rows GT apart
template <int R, bool kSpread>
__device__ __forceinline__ int step_row(int r, int GT, int gg) {
    return kSpread ? r * GT + gg : gg * R + r;
}

// the values of rows ib + step_row(r) * stride, r < R, of column j; the
// rows past the step's nr are zeros (their distances are computed and
// masked)
template <int V, int R, bool kSpread>
__device__ __forceinline__ void load_rows(
    typename Pixel<V>::T (&px)[R][Pixel<V>::kN],
    const int32_t* __restrict__ planes, const float* __restrict__ feats,
    long long frame0, long long cs, int W, int ib, int nr, int stride,
    int GT, int gg, int j) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
        const int rr = step_row<R, kSpread>(r, GT, gg);
        const long long p = frame0 + (long long)(ib + rr * stride) * W + j;
#pragma unroll
        for (int c = 0; c < Pixel<V>::kN; ++c) {
            if (rr >= nr) px[r][c] = 0;
            else if constexpr (V == kLsc) px[r][c] = feats[c * cs + p];
            else px[r][c] = (typename Pixel<V>::T)planes[c * cs + p];
        }
    }
}

// blockDim (kCols, G), grid (column runs, GH * parts, B): the parts blocks
// of a cell row split its processed rows, so thread (t, g) of part q takes
// columns j0 + t, j0 + t + kCols, ... and the step's rows gg * R ... gg * R
// + R - 1 (kSpread: gg, gg + GT, ...) with gg = q * G + g and GT = G *
// parts; a step covers GT * R processed rows.  A thread's R rows of a slot
// are computed without branches and masked (the row window and the step's
// end), so their R float chains interleave.  kTable: the spatial term of
// real / real_l2 comes from a table over |di| + |dj| (Manhattan) or (|di|,
// |dj|).  kPrefetch: the first step's pixels are loaded before the records
// are staged (the library does not: PERF.md §6, kernel designs that lost)
template <int V, bool kManhattan, bool kTable, int G, int R, bool kPrefetch,
          bool kSpread>
__global__ void __launch_bounds__(kCols * G)
assign_float_kernel(const int32_t* __restrict__ planes,
                    const float* __restrict__ feats,
                    const float* __restrict__ table,
                    const float* __restrict__ cent,
                    const int32_t* __restrict__ cand,
                    int32_t* __restrict__ assignment,
                    float* __restrict__ min_dists, float coef, int H, int W,
                    int S, int GH, int GW, int C, int stride, int rem, int K,
                    int B, int ncells, int parts) {
    constexpr int RW = record_words<V>();
    constexpr int NC = Pixel<V>::kN;
    using T = typename Pixel<V>::T;
    // records of ncells * Cp slots, then ncells counts, then the spatial
    // table
    extern __shared__ int4 smem[];
    int32_t* rec = reinterpret_cast<int32_t*>(smem);
    const int tx = threadIdx.x, g = threadIdx.y;
    const int tid = g * kCols + tx;
    const int ci = blockIdx.y / parts;
    const int GT = G * parts, gg = (blockIdx.y - ci * parts) * G + g;
    const int step = GT * R;
    const int cj0 = blockIdx.x * ncells, f = blockIdx.z;

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
    const long long cs = B * n;  // channel stride of planes and feats
    const long long frame0 = f * n;

    T px[R][NC];
    if (kPrefetch && j0 + tx < j1)
        load_rows<V, R, kSpread>(px, planes, feats, frame0, cs, W, i0,
                                 min(step, nrows), stride, GT, gg, j0 + tx);

    const int Cp = C | 1;
    int32_t* count = rec + ncells * Cp * RW;
    float* spt = reinterpret_cast<float*>(count + ncells);
    const int cells = min(ncells, GW - cj0);
    if (tid < ncells) count[tid] = tid < cells ? C : 0;
    if constexpr (kTable) {
        const int side = S + 1;
        const bool linear = V == kReal && kManhattan;
        for (int d = tid; d < (linear ? 2 * S + 1 : side * side);
             d += kCols * G) {
            float sp;
            if (linear) {
                sp = coef * (float)d;
            } else {
                const float fi = (float)(d / side);
                const float fj = (float)(d % side);
                if constexpr (V == kRealL2) {
                    const float fy = coef * fi;
                    const float fx = coef * fj;
                    sp = fy * fy + fx * fx;
                } else {
                    sp = coef * sqrtf(fi * fi + fj * fj);
                }
            }
            spt[d] = sp;
        }
    }
    __syncthreads();
    const int32_t* ids = cand + (((long long)f * GH + ci) * GW + cj0) * C;
    const float* tab = table + (long long)f * K * 5;
    const float* cen = V == kLsc ? cent + (long long)f * K * kFeat : nullptr;
    for (int q = tid; q < cells * C; q += kCols * G) {
        const int c = q / C;
        const int s = q - c * C;
        int32_t* r = rec + (c * Cp + s) * RW;
        const int k = ids[q];
        r[0] = k;
        if (k < 0) {
            atomicMin(count + c, s);  // the walk stops at the first empty
            continue;
        }
        const float* e = tab + 5 * k;
        if constexpr (V == kRealNoq) {
            const float cy = e[0];
            const float cx = e[1];
            r[1] = max((int)truncf(cx - (float)S), 0);
            r[2] = min((int)truncf((cx + (float)S) + 1.0f), W);
            r[3] = max((int)truncf(cy - (float)S), 0);
            r[4] = min((int)truncf((cy + (float)S) + 1.0f), H);
            r[5] = __float_as_int(cy);
            r[6] = __float_as_int(cx);
            for (int ch = 0; ch < 3; ++ch)
                r[7 + ch] = __float_as_int(e[2 + ch]);
        } else {
            r[1] = (int)e[0];
            r[2] = (int)e[1];
            if constexpr (V == kLsc) {
                const float* cf = cen + kFeat * k;
                for (int ch = 0; ch < kFeat; ++ch)
                    r[3 + ch] = __float_as_int(cf[ch]);
            } else {
                for (int ch = 0; ch < 3; ++ch) r[3 + ch] = (int)e[2 + ch];
            }
        }
    }
    __syncthreads();

    for (int rb = 0; rb < nrows; rb += step) {
        const int nr = min(step, nrows - rb);
        const int ib = i0 + rb * stride;  // first row of this step
        // the thread's first and last row of the step (rows rise with r)
        const int rlo = step_row<R, kSpread>(0, GT, gg);
        if (rlo >= nr) continue;  // none of the thread's rows is left
        int rhi = rlo;
#pragma unroll
        for (int r = 1; r < R; ++r) {
            const int rr = step_row<R, kSpread>(r, GT, gg);
            if (rr < nr) rhi = rr;
        }
        const int ilo = ib + rlo * stride, ihi = ib + rhi * stride;
        for (int j = j0 + tx; j < j1; j += kCols) {
            if (!kPrefetch || rb > 0 || j != j0 + tx)
                load_rows<V, R, kSpread>(px, planes, feats, frame0, cs, W, ib,
                                         nr, stride, GT, gg, j);
            float md[R];
            int ms[R];
#pragma unroll
            for (int r = 0; r < R; ++r) {
                md[r] = FLT_MAX;
                ms[r] = -1;
            }
            const int cell = min(j / S, GW - 1) - cj0;
            const int32_t* base = rec + cell * Cp * RW;
            const int filled = count[cell];
            for (int s = 0; s < filled; ++s) {
                const int4* o = reinterpret_cast<const int4*>(base + s * RW);
                const int4 w0 = o[0];
                float dist[R];
                bool in[R];
                if constexpr (V == kRealNoq) {
                    const int y_lo = w0.w;
                    if (j < w0.y || j >= w0.z) continue;  // x_lo, x_hi
                    const int4 w1 = o[1];
                    const int y_hi = w1.x;
                    if (ihi < y_lo || ilo >= y_hi) continue;
                    const int4 w2 = o[2];
                    const float cy = __int_as_float(w1.y);
                    const float cx = __int_as_float(w1.z);
                    const float cl = __int_as_float(w1.w);
                    const float ca = __int_as_float(w2.x);
                    const float cb = __int_as_float(w2.y);
                    const float dx = coef * ((float)j - cx);
#pragma unroll
                    for (int r = 0; r < R; ++r) {
                        const int rr = step_row<R, kSpread>(r, GT, gg);
                        const int i = ib + rr * stride;
                        in[r] = rr < nr && i >= y_lo && i < y_hi;
                        const float dr = px[r][0] - cl;
                        const float dg = px[r][1] - ca;
                        const float db = px[r][2] - cb;
                        const float dy = coef * ((float)i - cy);
                        if constexpr (kManhattan) {
                            dist[r] = fabsf(dr) + fabsf(dg) + fabsf(db) +
                                      fabsf(dx) + fabsf(dy);
                        } else {
                            dist[r] = dr * dr + dg * dg + db * db + dx * dx +
                                      dy * dy;
                        }
                    }
                } else {
                    const int dj = j - w0.z;
                    const int adj = abs(dj);
                    if (adj > S) continue;
                    const int cy = w0.y;
                    if (ihi < cy - S || ilo > cy + S) continue;
#pragma unroll
                    for (int r = 0; r < R; ++r) {
                        const int rr = step_row<R, kSpread>(r, GT, gg);
                        in[r] = rr < nr && abs(ib + rr * stride - cy) <= S;
                    }
                    if constexpr (V == kLsc) {
                        const int4 w1 = o[1];
                        const int4 w2 = o[2];
                        const int4 w3 = o[3];
                        const float cf[kFeat] = {
                            __int_as_float(w0.w), __int_as_float(w1.x),
                            __int_as_float(w1.y), __int_as_float(w1.z),
                            __int_as_float(w1.w), __int_as_float(w2.x),
                            __int_as_float(w2.y), __int_as_float(w2.z),
                            __int_as_float(w2.w), __int_as_float(w3.x)};
#pragma unroll
                        for (int r = 0; r < R; ++r) dist[r] = 0.0f;
                        // channel order within each row; the rows' chains
                        // interleave
#pragma unroll
                        for (int ch = 0; ch < kFeat; ++ch) {
#pragma unroll
                            for (int r = 0; r < R; ++r) {
                                const float d = px[r][ch] - cf[ch];
                                dist[r] = dist[r] + d * d;
                            }
                        }
                    } else {
                        const int4 w1 = o[1];
                        const int cl = w0.w, ca = w1.x, cb = w1.y;
                        const float fj = (float)dj;
                        const float fj2 = fj * fj;
                        const float fxl2 = coef * fj;
#pragma unroll
                        for (int r = 0; r < R; ++r) {
                            const int di =
                                ib + step_row<R, kSpread>(r, GT, gg) * stride -
                                cy;
                            const int adi = min(abs(di), S);  // masked past S
                            float sp;
                            if constexpr (kTable) {
                                sp = spt[V == kReal && kManhattan
                                             ? adi + adj
                                             : adi * (S + 1) + adj];
                            } else if constexpr (V == kRealL2) {
                                const float fy = coef * (float)di;
                                sp = fy * fy + fxl2 * fxl2;
                            } else if constexpr (kManhattan) {
                                sp = coef * (float)(adi + adj);
                            } else {
                                const float fi = (float)di;
                                sp = coef * sqrtf(fi * fi + fj2);
                            }
                            if constexpr (V == kRealL2) {
                                const float dr = (float)(px[r][0] - cl);
                                const float dg = (float)(px[r][1] - ca);
                                const float db = (float)(px[r][2] - cb);
                                dist[r] = sp + dr * dr + dg * dg + db * db;
                            } else {
                                const int cd = abs(px[r][0] - cl) +
                                               abs(px[r][1] - ca) +
                                               abs(px[r][2] - cb);
                                dist[r] = sp + (float)cd;
                            }
                        }
                    }
                }
#pragma unroll
                for (int r = 0; r < R; ++r) {
                    if (in[r] && dist[r] < md[r]) {
                        md[r] = dist[r];
                        ms[r] = s;
                    }
                }
            }
#pragma unroll
            for (int r = 0; r < R; ++r) {
                const int rr = step_row<R, kSpread>(r, GT, gg);
                if (rr >= nr) continue;
                const long long p =
                    frame0 + (long long)(ib + rr * stride) * W + j;
                if (ms[r] >= 0) {
                    assignment[p] = base[ms[r] * RW];
                    if (min_dists) min_dists[p] = md[r];
                } else if (min_dists) {
                    min_dists[p] = FLT_MAX;
                }
            }
        }
    }
}

template <int V, bool kManhattan, bool kTable, int G, int R, bool kPrefetch,
          bool kSpread>
int launch(const void* planes, const void* feats, const void* table,
           const void* cent, const void* cand, void* assignment,
           void* min_dists, float coef, int H, int W, int S, int GH, int GW,
           int C, int stride, int rem, int K, int B, int ncells, int parts,
           size_t shmem, cudaStream_t stream) {
    const auto kernel =
        assign_float_kernel<V, kManhattan, kTable, G, R, kPrefetch, kSpread>;
    if (shmem > 48 * 1024) {  // above the default only when opted in
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
        if (err != cudaSuccess) return (int)err;
    }
    const dim3 blocks((GW + ncells - 1) / ncells, GH * parts, B);
    kernel<<<blocks, dim3(kCols, G), shmem, stream>>>(
        (const int32_t*)planes, (const float*)feats, (const float*)table,
        (const float*)cent, (const int32_t*)cand, (int32_t*)assignment,
        (float*)min_dists, coef, H, W, S, GH, GW, C, stride, rem, K, B,
        ncells, parts);
    return (int)cudaGetLastError();
}

// one float assign pass with G row groups of R rows a thread; a cell row's
// processed rows (at most ceil(S / stride)) split over as many blocks as
// make one step each
template <int G, int R, bool kPrefetch, bool kSpread>
int run_assign_float(const void* planes, const void* feats,
                     const void* table, const void* cent, const void* cand,
                     void* assignment, void* min_dists, float coef, int H,
                     int W, int S, int GH, int GW, int C, int stride,
                     int rem, int variant, int manhattan, int K, int B,
                     cudaStream_t stream) {
    if (variant < kReal || variant > kLsc) return (int)cudaErrorInvalidValue;
    if (!(rem < H && W > 0 && B > 0 && GH > 0 && GW > 0 && C > 0))
        return (int)cudaGetLastError();
    // S > kCols: one cell a block, its columns in turns
    const int ncells = min(max(kCols / S, 1), kMaxCells);
    const int rows = (S + stride - 1) / stride;
    const int parts = (rows + G * R - 1) / (G * R);
    const int rw = variant == kLsc ? record_words<kLsc>()
                   : variant == kRealNoq ? record_words<kRealNoq>()
                                         : record_words<kReal>();
    const int entries = variant == kReal && manhattan ? 2 * S + 1
                        : variant <= kRealL2         ? (S + 1) * (S + 1)
                                                     : 0;
    const bool tab = entries > 0 && entries <= kMaxTable;
    const size_t shmem =
        ((size_t)ncells * (C | 1) * rw + ncells + (tab ? entries : 0)) *
        sizeof(int32_t);
#define FSTT_LAUNCH(V, M, T)                                                \
    return launch<V, M, T, G, R, kPrefetch, kSpread>(                       \
        planes, feats, table, cent, cand, assignment, min_dists, coef, H, W, \
        S, GH, GW, C, stride, rem, K, B, ncells, parts, shmem, stream)
    switch (variant) {
        case kReal:
            if (manhattan) {
                if (tab) FSTT_LAUNCH(kReal, true, true);
                FSTT_LAUNCH(kReal, true, false);
            }
            if (tab) FSTT_LAUNCH(kReal, false, true);
            FSTT_LAUNCH(kReal, false, false);
        case kRealL2:  // the l2 spatial term ignores manhattan
            if (tab) FSTT_LAUNCH(kRealL2, false, true);
            FSTT_LAUNCH(kRealL2, false, false);
        case kRealNoq:
            if (manhattan) FSTT_LAUNCH(kRealNoq, true, false);
            FSTT_LAUNCH(kRealNoq, false, false);
        default:
            FSTT_LAUNCH(kLsc, false, false);
    }
#undef FSTT_LAUNCH
}

}  // namespace fassign
}  // namespace

// variant: 0 real, 1 real_l2, 2 real_noq, 3 lsc.  B frames of K clusters
// (B = 1: one frame): planes int32 [3, B, H, W] (unused by lsc), feats f32
// [10, B, H, W] and cent f32 [B, K, 10] (lsc only, else null), table f32
// [B, K, 5], cand int32 [B, GH, GW, C], assignment int32 [B, H, W] updated
// in place, min_dists f32 [B, H, W] or null.
extern "C" int fstt_assign_float(const void* planes, const void* feats,
                                 const void* table, const void* cent,
                                 const void* cand, void* assignment,
                                 void* min_dists, float coef, int H, int W,
                                 int S, int GH, int GW, int C, int stride,
                                 int rem, int variant, int manhattan, int K,
                                 int B, void* stream) {
    return fassign::run_assign_float<fassign::kGroups, fassign::kRows, false,
                                     false>(
        planes, feats, table, cent, cand, assignment, min_dists, coef, H, W,
        S, GH, GW, C, stride, rem, variant, manhattan, K, B,
        (cudaStream_t)stream);
}
