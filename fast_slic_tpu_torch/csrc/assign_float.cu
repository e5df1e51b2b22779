// SLIC assignment with float distances (real, real_l2, real_noq, lsc), one
// thread per pixel of the rows i % stride == rem.
//
// Replaces fast_slic_tpu/pallas/assign_tpu.py:_assign_kernel_float
// (pallas_call in assign_pallas_float), which serves all four variants.
// The TPU kernel expanded every per-cell candidate field (y, x, r, g, b, id
// and, for LSC, the ten centroid features) to pixels with bf16
// mantissa-split selection matmuls, because Mosaic has no gather; here each
// thread reads its own cell's candidate ids (cand [GH, GW, C] from
// pipeline.build_candidates, visit-ordered, -1 = empty and always at the
// tail), the [K, 5] f32 table (y, x, L, a, b) and, for LSC, the [K, 10] f32
// centroid features (64 KB at K=1600, served from L1/L2).
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
// Bound on the card: the planes (and LSC's 10 feature planes, 37 MB at
// 720p) are streamed once; the candidate data (C*20 bytes a cell, C*60 for
// LSC) is shared by the S*S threads of a cell and hits in L1/L2, so the
// kernel is bound by its per-slot float work.  Each thread keeps its pixel
// (and LSC's 10 features) in registers and stops at the first empty slot.

// Frame axis: B stacked frames (planes [3, B, H, W], feats [10, B, H, W],
// table [B, K, 5], cent [B, K, 10], cand [B, GH, GW, C], assignment and
// min_dists [B, H, W]; the stacked batch mode, the TPU kernel's frames=
// grid) run in one launch with the frame as blockIdx.z; all row and cell
// math stays frame-local, so B = 1 is the single-frame pass.

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

enum Variant { kReal = 0, kRealL2 = 1, kRealNoq = 2, kLsc = 3 };
constexpr int kFeat = 10;

template <int V, bool kManhattan>
__global__ void assign_float_kernel(const int32_t* __restrict__ planes,
                                    const float* __restrict__ feats,
                                    const float* __restrict__ table,
                                    const float* __restrict__ cent,
                                    const int32_t* __restrict__ cand,
                                    int32_t* __restrict__ assignment,
                                    float* __restrict__ min_dists, float coef,
                                    int H, int W, int S, int GH, int GW,
                                    int C, int stride, int rem, int K,
                                    int B) {
    int j = blockIdx.x * blockDim.x + threadIdx.x;
    int i = rem + blockIdx.y * stride;
    int fr = blockIdx.z;
    if (j >= W || i >= H) return;
    long long n = (long long)H * W;
    long long p = fr * n + (long long)i * W + j;  // pixel of the stack
    long long cs = B * n;                         // channel stride
    int l0 = 0, l1 = 0, l2 = 0;
    float f[kFeat];
    if (V == kLsc) {
#pragma unroll
        for (int c = 0; c < kFeat; ++c) f[c] = feats[c * cs + p];
        cent += (long long)fr * K * kFeat;
    } else {
        l0 = planes[p];
        l1 = planes[cs + p];
        l2 = planes[2 * cs + p];
    }
    int ci = min(i / S, GH - 1);
    int cj = min(j / S, GW - 1);
    const int32_t* ids = cand + (((long long)fr * GH + ci) * GW + cj) * C;
    table += (long long)fr * K * 5;

    float md = FLT_MAX;
    int ms = -1;
    for (int s = 0; s < C; ++s) {
        int k = ids[s];
        if (k < 0) break;  // empty slots sort to the tail
        const float* c = table + 5 * k;
        float dist;
        if (V == kRealNoq) {
            float cy = c[0];
            float cx = c[1];
            int y_lo = max((int)truncf(cy - (float)S), 0);
            int y_hi = min((int)truncf((cy + (float)S) + 1.0f), H);
            int x_lo = max((int)truncf(cx - (float)S), 0);
            int x_hi = min((int)truncf((cx + (float)S) + 1.0f), W);
            if (i < y_lo || i >= y_hi || j < x_lo || j >= x_hi) continue;
            float dr = (float)l0 - c[2];
            float dg = (float)l1 - c[3];
            float db = (float)l2 - c[4];
            float dy = coef * ((float)i - cy);
            float dx = coef * ((float)j - cx);
            if (kManhattan) {
                dist = fabsf(dr) + fabsf(dg) + fabsf(db) + fabsf(dx) +
                       fabsf(dy);
            } else {
                dist = dr * dr + dg * dg + db * db + dx * dx + dy * dy;
            }
        } else {
            int di = i - (int)c[0];
            int dj = j - (int)c[1];
            if (abs(di) > S || abs(dj) > S) continue;
            if (V == kLsc) {
                const float* cf = cent + kFeat * k;
                dist = 0.0f;
#pragma unroll
                for (int ch = 0; ch < kFeat; ++ch) {
                    float d = f[ch] - cf[ch];
                    dist = dist + d * d;
                }
            } else if (V == kRealL2) {
                float fy = coef * (float)di;
                float fx = coef * (float)dj;
                float sp = fy * fy + fx * fx;
                float dr = (float)(l0 - (int)c[2]);
                float dg = (float)(l1 - (int)c[3]);
                float db = (float)(l2 - (int)c[4]);
                dist = sp + dr * dr + dg * dg + db * db;
            } else {
                float sp;
                if (kManhattan) {
                    sp = coef * (float)(abs(di) + abs(dj));
                } else {
                    float fi = (float)di;
                    float fj = (float)dj;
                    sp = coef * sqrtf(fi * fi + fj * fj);
                }
                int cd = abs(l0 - (int)c[2]) + abs(l1 - (int)c[3]) +
                         abs(l2 - (int)c[4]);
                dist = sp + (float)cd;
            }
        }
        if (dist < md) {
            md = dist;
            ms = s;
        }
    }
    if (ms >= 0) {
        assignment[p] = ids[ms];
        if (min_dists) min_dists[p] = md;
    } else if (min_dists) {
        min_dists[p] = FLT_MAX;
    }
}

template <int V, bool kManhattan>
void launch(dim3 blocks, dim3 threads, cudaStream_t stream,
            const void* planes, const void* feats, const void* table,
            const void* cent, const void* cand, void* assignment,
            void* min_dists, float coef, int H, int W, int S, int GH, int GW,
            int C, int stride, int rem, int K, int B) {
    assign_float_kernel<V, kManhattan><<<blocks, threads, 0, stream>>>(
        (const int32_t*)planes, (const float*)feats, (const float*)table,
        (const float*)cent, (const int32_t*)cand, (int32_t*)assignment,
        (float*)min_dists, coef, H, W, S, GH, GW, C, stride, rem, K, B);
}

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
    int rows = rem < H ? (H - rem + stride - 1) / stride : 0;
    if (rows > 0 && W > 0 && B > 0) {
        dim3 threads(128);
        dim3 blocks((W + threads.x - 1) / threads.x, rows, B);
        cudaStream_t st = (cudaStream_t)stream;
#define FSTT_LAUNCH(V, M)                                                   \
    launch<V, M>(blocks, threads, st, planes, feats, table, cent, cand,     \
                 assignment, min_dists, coef, H, W, S, GH, GW, C, stride,   \
                 rem, K, B)
        switch (variant) {
            case kReal:
                if (manhattan) FSTT_LAUNCH(kReal, true);
                else FSTT_LAUNCH(kReal, false);
                break;
            case kRealL2:  // the l2 spatial term ignores manhattan
                FSTT_LAUNCH(kRealL2, false);
                break;
            case kRealNoq:
                if (manhattan) FSTT_LAUNCH(kRealNoq, true);
                else FSTT_LAUNCH(kRealNoq, false);
                break;
            case kLsc:
                FSTT_LAUNCH(kLsc, false);
                break;
            default:
                return (int)cudaErrorInvalidValue;
        }
#undef FSTT_LAUNCH
    }
    return (int)cudaGetLastError();
}
