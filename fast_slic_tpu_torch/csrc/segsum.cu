// Exact int32 segment sums with global atomics: the SLIC centroid update and
// the CCA area / orphan-target sums.
//
// Replaces two TPU kernels that share one body (_segsum_accumulate):
//   fast_slic_tpu/pallas/segsum_tpu.py:_update_padded_kernel
//     (pallas_call in slic_update_padded_pallas), and
//   fast_slic_tpu/pallas/segsum_tpu.py:_segsum_kernel
//     (pallas_call in segment_sum_pallas).
// The TPU serialised scatter-adds, so it built one-hot tiles in VMEM and
// reduced them with byte-split bf16 matmuls, which limited values to 2^16.
// Hopper has native int32 atomics: each thread adds its pixel's values into
// a zeroed [V, bins] buffer.  Integer addition is associative, so the
// result is exact and independent of the order the atomics land in.
//
// slic_update builds [count, i, j, L, a, b] in-kernel from the
// full-resolution assignment and planes, for the rows i % stride == rem; a
// pixel counts if its id != 0xFFFF (the reference's update accumulators,
// context.cpp:309-354).
//
// Bound on the card: atomic throughput into L2.  Neighbouring pixels mostly
// share a cluster (or component), so the atomics of a warp contend on a few
// addresses.  This first version issues them directly; warp aggregation or
// per-block shared-memory bins are the next step.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kUnassigned = 0xFFFF;

__global__ void slic_update_kernel(const int32_t* __restrict__ assignment,
                                   const int32_t* __restrict__ planes,
                                   int32_t* __restrict__ out, int H, int W,
                                   int K, int stride, int rem) {
    int j = blockIdx.x * blockDim.x + threadIdx.x;
    int i = rem + blockIdx.y * stride;
    if (j >= W || i >= H) return;
    int n = H * W;
    int p = i * W + j;
    int k = assignment[p];
    if (k == kUnassigned || k < 0 || k >= K) return;
    atomicAdd(out + k, 1);
    atomicAdd(out + K + k, i);
    atomicAdd(out + 2 * K + k, j);
    atomicAdd(out + 3 * K + k, planes[p]);
    atomicAdd(out + 4 * K + k, planes[n + p]);
    atomicAdd(out + 5 * K + k, planes[2 * n + p]);
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

}  // namespace

// out: int32 [6, K], zeroed by the caller
extern "C" int fstt_slic_update(const void* assignment, const void* planes,
                                void* out, int H, int W, int K, int stride,
                                int rem, void* stream) {
    int rows = rem < H ? (H - rem + stride - 1) / stride : 0;
    if (rows > 0 && W > 0) {
        dim3 threads(128);
        dim3 blocks((W + threads.x - 1) / threads.x, rows);
        slic_update_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
            (const int32_t*)assignment, (const int32_t*)planes,
            (int32_t*)out, H, W, K, stride, rem);
    }
    return (int)cudaGetLastError();
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
