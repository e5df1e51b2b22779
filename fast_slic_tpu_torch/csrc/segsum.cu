// Exact int32 segment sums with global atomics: the SLIC centroid update
// (plain and masked by the preemptive grid), the CCA area / orphan-target
// sums, and their per-frame form for stacked frames.
//
// Replaces four TPU kernels:
//   fast_slic_tpu/pallas/segsum_tpu.py:_update_padded_kernel
//     (pallas_call in slic_update_padded_pallas)      -> slic_update
//   fast_slic_tpu/pallas/segsum_tpu.py:_update_kernel
//     (pallas_call in slic_update_pallas)             -> slic_update_masked
//   fast_slic_tpu/pallas/segsum_tpu.py:_segsum_kernel
//     (pallas_call in segment_sum_pallas)             -> segment_sum
//   fast_slic_tpu/pallas/segsum_tpu.py:_framed_segsum_kernel
//     (pallas_call in framed_segment_sum_pallas)      -> framed_segment_sum
// The TPU serialised scatter-adds, so it built one-hot tiles in VMEM and
// reduced them with byte-split bf16 matmuls, which limited values to 2^16
// and needed hi-bucket band guards (masked pixels kept the tile's minimum
// id) and a per-frame VMEM output block.  Hopper has native int32 atomics:
// each thread adds its pixel's values into a zeroed buffer.  Integer
// addition is associative, so the result is exact and independent of the
// order the atomics land in, and none of those devices is needed.
//
// slic_update builds [count, i, j, L, a, b] in-kernel from the
// full-resolution assignment and planes, for the rows i % stride == rem; a
// pixel counts if its id != 0xFFFF (the reference's update accumulators,
// context.cpp:309-354).  slic_update_masked also drops every pixel whose
// preemptive mask is 0, from the count too (preemptive.h: inactive cells
// are not accumulated).  Both take B stacked frames ([B, H, W] assignment,
// [3, B, H, W] planes, [B, H, W] mask): the frame is blockIdx.z, rows stay
// frame-local, and frame f's cluster k lands in bin f*K + k.
//
// Bound on the card: atomic throughput into L2.  Neighbouring pixels mostly
// share a cluster (or component), so the atomics of a warp contend on a few
// addresses.  This first version issues them directly; warp aggregation or
// per-block shared-memory bins are the next step.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kUnassigned = 0xFFFF;

template <bool kMasked>
__global__ void slic_update_kernel(const int32_t* __restrict__ assignment,
                                   const int32_t* __restrict__ planes,
                                   const uint8_t* __restrict__ mask,
                                   int32_t* __restrict__ out, int H, int W,
                                   int K, int B, int stride, int rem) {
    int j = blockIdx.x * blockDim.x + threadIdx.x;
    int i = rem + blockIdx.y * stride;
    int f = blockIdx.z;
    if (j >= W || i >= H) return;
    long long n = (long long)H * W;
    long long p = f * n + (long long)i * W + j;  // pixel of the [B, H, W] stack
    if (kMasked && !mask[p]) return;
    int k = assignment[p];
    if (k == kUnassigned || k < 0 || k >= K) return;
    long long bins = (long long)B * K;
    long long cs = B * n;  // channel stride of planes [3, B, H, W]
    int32_t* o = out + (long long)f * K + k;
    atomicAdd(o, 1);
    atomicAdd(o + bins, i);
    atomicAdd(o + 2 * bins, j);
    atomicAdd(o + 3 * bins, planes[p]);
    atomicAdd(o + 4 * bins, planes[cs + p]);
    atomicAdd(o + 5 * bins, planes[2 * cs + p]);
}

__global__ void segment_sum_kernel(const int32_t* __restrict__ ids,
                                   const int32_t* __restrict__ vals,
                                   int32_t* __restrict__ out, int N, int V,
                                   int bins) {
    int p = blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= N) return;
    int k = ids[p];
    if (k < 0 || k >= bins) return;
    for (int v = 0; v < V; ++v) {
        int x = vals[(long long)v * N + p];
        if (x != 0) atomicAdd(out + (long long)v * bins + k, x);
    }
}

// ids [B, Nf] frame-local, vals [V, B, Nf], out [B, V, bins]
__global__ void framed_segment_sum_kernel(const int32_t* __restrict__ ids,
                                          const int32_t* __restrict__ vals,
                                          int32_t* __restrict__ out, int B,
                                          int Nf, int V, int bins) {
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

template <bool kMasked>
int launch_update(const void* assignment, const void* planes,
                  const void* mask, void* out, int H, int W, int K, int B,
                  int stride, int rem, void* stream) {
    int rows = rem < H ? (H - rem + stride - 1) / stride : 0;
    if (rows > 0 && W > 0 && B > 0) {
        dim3 threads(128);
        dim3 blocks((W + threads.x - 1) / threads.x, rows, B);
        slic_update_kernel<kMasked>
            <<<blocks, threads, 0, (cudaStream_t)stream>>>(
                (const int32_t*)assignment, (const int32_t*)planes,
                (const uint8_t*)mask, (int32_t*)out, H, W, K, B, stride,
                rem);
    }
    return (int)cudaGetLastError();
}

}  // namespace

// assignment int32 [B, H, W], planes int32 [3, B, H, W];
// out int32 [6, B*K], zeroed by the caller
extern "C" int fstt_slic_update(const void* assignment, const void* planes,
                                void* out, int H, int W, int K, int B,
                                int stride, int rem, void* stream) {
    return launch_update<false>(assignment, planes, nullptr, out, H, W, K, B,
                                stride, rem, stream);
}

// as fstt_slic_update, plus mask bool (one byte, 0/1) [B, H, W]
extern "C" int fstt_slic_update_masked(const void* assignment,
                                       const void* planes, const void* mask,
                                       void* out, int H, int W, int K, int B,
                                       int stride, int rem, void* stream) {
    return launch_update<true>(assignment, planes, mask, out, H, W, K, B,
                               stride, rem, stream);
}

// out: int32 [V, bins], zeroed by the caller; ids outside [0, bins) drop
extern "C" int fstt_segment_sum(const void* ids, const void* vals, void* out,
                                int N, int V, int bins, void* stream) {
    if (N > 0) {
        int threads = 256;
        int blocks = (N + threads - 1) / threads;
        segment_sum_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
            (const int32_t*)ids, (const int32_t*)vals, (int32_t*)out, N, V,
            bins);
    }
    return (int)cudaGetLastError();
}

// out: int32 [B, V, bins], zeroed by the caller; ids outside [0, bins) drop
extern "C" int fstt_framed_segment_sum(const void* ids, const void* vals,
                                       void* out, int B, int Nf, int V,
                                       int bins, void* stream) {
    if (B > 0 && Nf > 0) {
        dim3 threads(256);
        dim3 blocks((Nf + threads.x - 1) / threads.x, B);
        framed_segment_sum_kernel<<<blocks, threads, 0,
                                    (cudaStream_t)stream>>>(
            (const int32_t*)ids, (const int32_t*)vals, (int32_t*)out, B, Nf,
            V, bins);
    }
    return (int)cudaGetLastError();
}
