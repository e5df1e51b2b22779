// SLIC assignment (standard, quantized variant), one thread per pixel of the
// rows i % stride == rem.
//
// Replaces fast_slic_tpu/pallas/assign_tpu.py:_assign_kernel (pallas_call
// in assign_pallas_standard).  The TPU kernel expanded per-cell candidate
// fields to pixels with 0/1 selection matmuls, because Mosaic has no
// gather; here each thread reads its own cell's candidate ids
// (cand [GH, GW, C] from pipeline.build_candidates, visit-ordered, -1 =
// empty and always at the tail) and the [K, 5] f32 table (y, x, L, a, b).
//
// The argmin is the one of pipeline.assign_xla (fast_slic_tpu/pipeline.py
// :323-342): min over (dist << 7) | slot, so the lowest slot (the
// first-visited cluster) wins ties; dist = trunc(coef * spatial) + L1 colour
// distance inside the window |di|, |dj| <= S around the int-cast centre.
// The assignment is written in place on the processed rows where a
// candidate won; elsewhere the old value stays.  min_dists (optional) gets
// the winning dist, or 0xFFFF where nothing won.
//
// Bound on the card: at 720p the planes (11 MB) and the assignment are
// streamed once; the candidate ids and table (C*20 bytes a cell) are shared
// by the S*S threads of a cell and hit in L1/L2, so the kernel is bound by
// its per-slot integer/float work (C = 16 slots, about 20 ops each).  The
// design keeps all slot state in registers and stops at the first empty
// slot.
//
// Frame axis: B stacked frames (planes [3, B, H, W], table [B, K, 5], cand
// [B, GH, GW, C], assignment and min_dists [B, H, W]; the stacked batch
// mode, the TPU kernel's frames= grid) run in one launch with the frame as
// blockIdx.z; all row and cell math stays frame-local, so B = 1 is the
// single-frame pass.
//
// Exactness: built with -fmad=false, so coef * sqrtf(di*di + dj*dj) rounds
// each operation as the JAX package does; coef arrives as the exact
// float32 that pipeline.derive_scalars computes on the host.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kUnassigned = 0xFFFF;
constexpr int kNone = 0x7FFFFFFF;

__global__ void assign_kernel(const int32_t* __restrict__ planes,
                              const float* __restrict__ table,
                              const int32_t* __restrict__ cand,
                              int32_t* __restrict__ assignment,
                              int32_t* __restrict__ min_dists, float coef,
                              int H, int W, int S, int GH, int GW, int C,
                              int stride, int rem, int manhattan, int K,
                              int B) {
    int j = blockIdx.x * blockDim.x + threadIdx.x;
    int i = rem + blockIdx.y * stride;
    int f = blockIdx.z;
    if (j >= W || i >= H) return;
    long long n = (long long)H * W;
    long long p = f * n + (long long)i * W + j;  // pixel of the [B, H, W] stack
    long long cs = B * n;                        // channel stride of planes
    int l0 = planes[p];
    int l1 = planes[cs + p];
    int l2 = planes[2 * cs + p];
    int ci = min(i / S, GH - 1);
    int cj = min(j / S, GW - 1);
    const int32_t* ids = cand + (((long long)f * GH + ci) * GW + cj) * C;
    table += (long long)f * K * 5;

    int best = kNone;
    for (int s = 0; s < C; ++s) {
        int k = ids[s];
        if (k < 0) break;  // empty slots sort to the tail
        const float* c = table + 5 * k;
        int cy = (int)c[0];
        int cx = (int)c[1];
        int di = i - cy;
        int dj = j - cx;
        int adi = abs(di);
        int adj = abs(dj);
        if (adi > S || adj > S) continue;
        float sp;
        if (manhattan) {
            sp = coef * (float)(adi + adj);
        } else {
            float fi = (float)di;
            float fj = (float)dj;
            sp = coef * sqrtf(fi * fi + fj * fj);
        }
        int dist = (int)truncf(sp) + abs(l0 - (int)c[2]) +
                   abs(l1 - (int)c[3]) + abs(l2 - (int)c[4]);
        int packed = (dist << 7) | s;
        best = min(best, packed);
    }
    if (best != kNone) {
        assignment[p] = ids[best & 0x7F];
        if (min_dists) min_dists[p] = best >> 7;
    } else if (min_dists) {
        min_dists[p] = kUnassigned;
    }
}

}  // namespace

// B frames of K clusters each (B = 1: one frame)
extern "C" int fstt_assign(const void* planes, const void* table,
                           const void* cand, void* assignment,
                           void* min_dists, float coef, int H, int W, int S,
                           int GH, int GW, int C, int stride, int rem,
                           int manhattan, int K, int B, void* stream) {
    int rows = rem < H ? (H - rem + stride - 1) / stride : 0;
    if (rows > 0 && W > 0 && B > 0) {
        dim3 threads(128);
        dim3 blocks((W + threads.x - 1) / threads.x, rows, B);
        assign_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
            (const int32_t*)planes, (const float*)table,
            (const int32_t*)cand, (int32_t*)assignment, (int32_t*)min_dists,
            coef, H, W, S, GH, GW, C, stride, rem, manhattan, K, B);
    }
    return (int)cudaGetLastError();
}
