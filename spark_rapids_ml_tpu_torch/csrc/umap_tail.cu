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
// Design. Each warp takes ROWS_PER_WARP consecutive tail rows. If all of
// their runs are short (at most SHORT_RUN edges, a warp-uniform test on
// offsets), each row gets its own group of 32 / ROWS_PER_WARP lanes;
// otherwise the warp walks its rows one after another with all 32 lanes,
// so a hub row is spread over the whole warp. Either way a lane takes
// UNROLL edges of its row a round: it starts all UNROLL perm loads, then
// all the g row loads through them (the reference's separate jnp.take
// gather is fused in), then the float64 adds, in a fixed edge order. That
// divides the rounds of dependent loads by UNROLL (a 1,161-edge hub takes
// 5 rounds of the whole warp, not 37). A fixed xor butterfly over the
// row's lanes then gives each lane the row's sum, and the row is written
// once. No atomics and a fixed summation order: the result is bitwise
// repeatable, and the float64 sums round once, so it lies within half an
// ulp of the exact sum. Rows with no in-edges write zeros. At dim = 2
// (UMAP's default embedding) a pass gathers each edge's two features in
// one 8-byte load: the random reads of g cost a sector each, and one load
// per edge, not one per feature, halves the scattered requests. Other
// widths sum 4 features a pass with 4-byte loads, re-reading the row's
// perm run for each pass. The grid is a fixed function of n: the plan
// needs no host sync.
//
// Bound at config 13 (n = 50,000, k = 15, dim = 2): the bytes, each
// read or written once: g 6.0 MB, perm 3.0 MB, offsets 0.2 MB, out
// 0.4 MB, about 2.9 us at 3.35 TB/s, below one launch's latency, so
// the launch and the chain of dependent loads (offsets, perm, g) are
// what a call costs. The reads of g through perm are random 8-byte rows,
// a sector each: 24 MB of sectors through L2 at config 13.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;                                 // warps per block
constexpr int ROWS_PER_WARP = 4;                         // consecutive tail rows a warp takes
constexpr int UNROLL = 8;                                // edges a lane loads ahead a round
constexpr int GROUP_LANES = 32 / ROWS_PER_WARP;          // lanes of a row when all runs are short
constexpr int SHORT_RUN = GROUP_LANES * UNROLL;          // a short run takes one round of its group

static_assert(32 % ROWS_PER_WARP == 0, "rows split the warp evenly");

// VW floats of g in one load (VW = 1 or 2; the caller checks alignment).
template <int VW>
__device__ __forceinline__ void load_vec(const float* p, float* v) {
    if constexpr (VW == 2) {
        const float2 q = __ldg(reinterpret_cast<const float2*>(p));
        v[0] = q.x; v[1] = q.y;
    } else {
        v[0] = __ldg(p);
    }
}

// Adds the lane's share of edges [begin, end) of one row, features
// [c0, c0 + width), into acc: rounds of LANES * UNROLL edges, lane `lane`
// taking edges base + u * LANES + lane, u = 0 .. UNROLL - 1. Each edge's
// CH features come in CH / VW loads (width is a multiple of VW).
template <int LANES, int CH, int VW>
__device__ __forceinline__ void sum_run(const float* __restrict__ g, const int* __restrict__ perm,
                                        int begin, int end, int lane, int c0, int width, int dim,
                                        double acc[CH]) {
    for (int base = begin; base < end; base += LANES * UNROLL) {
        int src[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const int e = base + u * LANES + lane;
            src[u] = e < end ? __ldg(perm + e) : -1;
        }
        float v[UNROLL][CH];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const float* row = g + static_cast<long long>(src[u]) * dim + c0;
#pragma unroll
            for (int j = 0; j < CH; j += VW) {
                if (src[u] >= 0 && j < width) {
                    load_vec<VW>(row + j, &v[u][j]);
                } else {
#pragma unroll
                    for (int w = 0; w < VW; ++w) v[u][j + w] = 0.f;
                }
            }
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)
#pragma unroll
            for (int j = 0; j < CH; ++j) acc[j] += static_cast<double>(v[u][j]);
    }
}

// The butterfly over aligned groups of LANES lanes, then lane j of the
// group writes feature j of its row.
template <int LANES, int CH>
__device__ __forceinline__ void write_row(double acc[CH], float* __restrict__ dst, int lane, int width,
                                          bool live) {
#pragma unroll
    for (int j = 0; j < CH; ++j) {
#pragma unroll
        for (int off = LANES / 2; off > 0; off >>= 1) acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], off);
    }
#pragma unroll
    for (int j = 0; j < CH; ++j) {
        if (live && lane == j && j < width) dst[j] = static_cast<float>(acc[j]);
    }
}

// CH features a pass over a row's run, gathered VW at a time: <2, 2> at
// dim = 2, <4, 1> otherwise.
template <int CH, int VW>
__global__ void __launch_bounds__(WARPS * 32)
tail_rows(const float* __restrict__ g, const int* __restrict__ perm,
          const int* __restrict__ offsets, float* __restrict__ out, int n, int dim) {
    const int row0 = (blockIdx.x * WARPS + (threadIdx.x >> 5)) * ROWS_PER_WARP;
    const int lane = threadIdx.x & 31;
    if (row0 >= n) return;  // warp-uniform
    const int rows = min(ROWS_PER_WARP, n - row0);
    // Lane i <= rows holds offsets[row0 + i]: the warp's row starts.
    const int start = lane <= rows ? __ldg(offsets + row0 + lane) : 0;
    const int next = __shfl_down_sync(0xffffffffu, start, 1);
    const bool all_short = __all_sync(0xffffffffu, lane >= rows || next - start <= SHORT_RUN);

    if (all_short) {
        const int r = lane / GROUP_LANES;  // the row of this lane's group
        const int gl = lane % GROUP_LANES;
        const int begin = __shfl_sync(0xffffffffu, start, r);
        const int end = __shfl_sync(0xffffffffu, start, r + 1);
        const bool live = r < rows;
        for (int c0 = 0; c0 < dim; c0 += CH) {
            double acc[CH] = {};
            const int width = min(CH, dim - c0);
            if (live) sum_run<GROUP_LANES, CH, VW>(g, perm, begin, end, gl, c0, width, dim, acc);
            write_row<GROUP_LANES, CH>(acc, out + static_cast<long long>(row0 + r) * dim + c0, gl, width, live);
        }
    } else {
        for (int r = 0; r < rows; ++r) {
            const int begin = __shfl_sync(0xffffffffu, start, r);
            const int end = __shfl_sync(0xffffffffu, start, r + 1);
            for (int c0 = 0; c0 < dim; c0 += CH) {
                double acc[CH] = {};
                const int width = min(CH, dim - c0);
                sum_run<32, CH, VW>(g, perm, begin, end, lane, c0, width, dim, acc);
                write_row<32, CH>(acc, out + static_cast<long long>(row0 + r) * dim + c0, lane, width, true);
            }
        }
    }
}

template <int CH, int VW>
int launch(const float* g, const int* perm, const int* offsets, float* out, int n, int dim,
           cudaStream_t stream) {
    const int warps = (n + ROWS_PER_WARP - 1) / ROWS_PER_WARP;
    const unsigned blocks = static_cast<unsigned>((warps + WARPS - 1) / WARPS);
    tail_rows<CH, VW><<<blocks, WARPS * 32, 0, stream>>>(g, perm, offsets, out, n, dim);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// g (E, dim) f32, perm (E) int32, offsets (n + 1) int32 on the device;
// out (n, dim) f32 is written whole. Returns the launch's CUDA error.
extern "C" int umap_tail_accumulate(const float* g, const int* perm, const int* offsets,
                                    float* out, int n, int dim, cudaStream_t stream) {
    if (n <= 0 || dim <= 0) return static_cast<int>(cudaErrorInvalidValue);
    if (dim == 2 && reinterpret_cast<uintptr_t>(g) % 8 == 0)
        return launch<2, 2>(g, perm, offsets, out, n, dim, stream);
    return launch<4, 1>(g, perm, offsets, out, n, dim, stream);
}
