// Kernel K4: the UMAP tail accumulation on Hopper (sm_90a).
//
// Replaces the TPU kernel spark_rapids_ml_tpu/ops/pallas/umap.py
// tail_accumulate (kernel _tail_kernel): every epoch of the UMAP layout
// SGD adds each edge's attractive gradient row g[e] (E = n*k edges, dim
// wide, head-major order) to the row of the edge's tail,
//
//     out[t] = sum of g[e] over the edges e whose tail is t,
//
// the reference's zeros.at[dst].add(g). The edge list is fixed for a fit,
// so the host plan (ops/kernels/umap.py build_tail_plan) sorts the edges
// by tail once: perm (E) is the stable tail-sorted edge order and
// offsets (n + 1) the CSR row starts over it. The TPU kernel's 256-row
// tiles, 1024-edge blocks, sentinel padding and one-hot matmuls were
// VMEM/MXU geometry and are not carried over.
//
// Design: one warp per tail row. The lanes stride the row's run of the
// sorted stream (edge offsets[t] + lane, + 32, ...), read each g row
// through perm (the reference's separate jnp.take gather is fused in),
// and sum up to CHUNK features in float64 registers; a fixed xor
// butterfly of shuffles then gives every lane the row's sum, and the
// lanes write the row once. No atomics and a fixed summation order: the
// result is bitwise repeatable, and the float64 sums round once, so it
// lies within half an ulp of the exact sum (hub rows with hundreds of
// in-edges included). Rows with no in-edges write zeros. Widths above
// CHUNK loop over feature chunks, re-reading the row's perm run.
//
// Bound at config 13 (n = 50,000, k = 15, dim = 2): the bytes, each
// read or written once: g 6.0 MB, perm 3.0 MB, offsets 0.2 MB, out
// 0.4 MB, about 2.9 us at 3.35 TB/s, below one launch's latency, so
// the launch is what a call costs. The reads of g through perm are
// random 8-byte rows, a sector each.

#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;   // warps (tail rows) per block
constexpr int CHUNK = 4;   // features summed per pass over a row's edges

__global__ void __launch_bounds__(WARPS * 32)
tail_rows(const float* __restrict__ g, const int* __restrict__ perm,
          const int* __restrict__ offsets, float* __restrict__ out, int n, int dim) {
    const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (row >= n) return;
    const int begin = offsets[row];
    const int end = offsets[row + 1];
    for (int c0 = 0; c0 < dim; c0 += CHUNK) {
        const int width = min(CHUNK, dim - c0);
        double acc[CHUNK];
#pragma unroll
        for (int j = 0; j < CHUNK; ++j) acc[j] = 0.0;
        for (int e = begin + lane; e < end; e += 32) {
            const float* src = g + static_cast<long long>(perm[e]) * dim + c0;
#pragma unroll
            for (int j = 0; j < CHUNK; ++j) {
                if (j < width) acc[j] += static_cast<double>(__ldg(src + j));
            }
        }
#pragma unroll
        for (int j = 0; j < CHUNK; ++j) {
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) {
                acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], off);
            }
        }
        float* dst = out + static_cast<long long>(row) * dim + c0;
#pragma unroll
        for (int j = 0; j < CHUNK; ++j) {
            if (lane == j && j < width) dst[j] = static_cast<float>(acc[j]);
        }
    }
}

}  // namespace

// g (E, dim) f32, perm (E) int32, offsets (n + 1) int32 on the device;
// out (n, dim) f32 is written whole. Returns the launch's CUDA error.
extern "C" int umap_tail_accumulate(const float* g, const int* perm, const int* offsets,
                                    float* out, int n, int dim, cudaStream_t stream) {
    if (n <= 0 || dim <= 0) return static_cast<int>(cudaErrorInvalidValue);
    const unsigned blocks = static_cast<unsigned>((n + WARPS - 1) / WARPS);
    tail_rows<<<blocks, WARPS * 32, 0, stream>>>(g, perm, offsets, out, n, dim);
    return static_cast<int>(cudaGetLastError());
}
