// f32 segment sums with an optional in-kernel weight multiply: LSC's
// weighted feature accumulation (after_update).
//
// Replaces fast_slic_tpu/pallas/segsum_tpu.py:_fsegsum_kernel (pallas_call
// in float_segsum_pallas).  The TPU serialised scatter-adds, so that kernel
// split every value into three bf16 mantissa chunks and accumulated them
// with one-hot matmuls inside a hi-bucket band.  Hopper has float atomics:
// each block sums its contiguous chunk of pixels into a privatised copy of
// the [V, bins] table in shared memory (11 x 1601 x 4 B = 70 KB at K=1600),
// then adds every non-zero bin to the output with one global atomicAdd.
// When the table does not fit in shared memory (K above ~5,000 for V=11),
// the pixels add straight into the output with global atomics.
//
// Pixels with mask 0 add nothing (so they land in no bin, which is what
// routing them to bin K with a zero value gives).  With wrow >= 0, rows
// v < wrow are multiplied by row wrow (the per-pixel weight) before they
// are added; row wrow and above are added as they are.
//
// Float atomics land in an order that changes from run to run, so the sums
// are not deterministic: each bin equals the sequential sum up to f32
// rounding of a different order (the reference's thread-local float
// accumulators differ the same way, lsc.cpp:245-297).  LSC's contract is
// label agreement >= 0.999, not bit equality.
//
// Bound on the card: shared-memory atomics.  Neighbouring pixels mostly
// share a cluster, so the atomics of a warp hit the same V addresses; the
// privatised table keeps that contention out of L2.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kSharedLimit = 200 * 1024;  // of the 227 KB a block may use

template <bool kShared>
__global__ void fsegsum_kernel(const int32_t* __restrict__ ids,
                               const int32_t* __restrict__ mask,
                               const float* __restrict__ vals,
                               float* __restrict__ out, int N, int V,
                               int bins, int wrow, int chunk) {
    extern __shared__ float sbins[];
    float* acc = kShared ? sbins : out;
    if (kShared) {
        for (int e = threadIdx.x; e < V * bins; e += blockDim.x) sbins[e] = 0.f;
        __syncthreads();
    }
    int begin = blockIdx.x * chunk;
    int end = min(begin + chunk, N);
    for (int p = begin + threadIdx.x; p < end; p += blockDim.x) {
        if (mask[p] == 0) continue;
        int k = ids[p];
        if (k < 0 || k >= bins) continue;
        float w = wrow >= 0 ? vals[(long long)wrow * N + p] : 1.0f;
        for (int v = 0; v < V; ++v) {
            float x = vals[(long long)v * N + p];
            if (v < wrow) x = x * w;
            atomicAdd(acc + v * bins + k, x);
        }
    }
    if (kShared) {
        __syncthreads();
        for (int e = threadIdx.x; e < V * bins; e += blockDim.x) {
            float x = sbins[e];
            if (x != 0.f) atomicAdd(out + e, x);
        }
    }
}

}  // namespace

// ids int32 [N], mask int32 [N], vals f32 [V, N]; out f32 [V, bins], zeroed
// by the caller.  wrow < 0: no weight multiply.
extern "C" int fstt_fsegsum(const void* ids, const void* mask,
                            const void* vals, void* out, int N, int V,
                            int bins, int wrow, void* stream) {
    if (N <= 0 || V <= 0 || bins <= 0) return (int)cudaGetLastError();
    cudaStream_t st = (cudaStream_t)stream;
    size_t smem = (size_t)V * bins * sizeof(float);
    if (smem <= kSharedLimit) {
        cudaError_t err = cudaFuncSetAttribute(
            fsegsum_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (err != cudaSuccess) return (int)err;
        int threads = 512;
        // about three blocks an SM; each takes a contiguous run of pixels, so
        // it touches few clusters and flushes few bins
        int blocks = min((N + threads - 1) / threads, 396);
        int chunk = (N + blocks - 1) / blocks;
        fsegsum_kernel<true><<<blocks, threads, smem, st>>>(
            (const int32_t*)ids, (const int32_t*)mask, (const float*)vals,
            (float*)out, N, V, bins, wrow, chunk);
    } else {
        int threads = 256;
        int blocks = (N + threads - 1) / threads;
        fsegsum_kernel<false><<<blocks, threads, 0, st>>>(
            (const int32_t*)ids, (const int32_t*)mask, (const float*)vals,
            (float*)out, N, V, bins, wrow, threads);
    }
    return (int)cudaGetLastError();
}
