// Centered Gram kernel K1: C = (x - mean)^T (x - mean) for a row-major
// x (n, d), in the input type (float or double), on Hopper (sm_90a).
//
// Replaces the TPU kernel spark_rapids_ml_tpu/ops/pallas/covariance.py
// (centered_gram_pallas, body _cov_kernel). The TPU kernel keeps the whole
// (d, d) accumulator in VMEM and walks the rows in one sequential grid; at
// d = 1024 that accumulator is 4 MB, which no Hopper block can hold, and
// Hopper blocks run in no fixed order. So this kernel tiles the OUTPUT:
//
//   gram_tiles     one block per (upper-triangular 64x64 output tile,
//                  row chunk). The block walks its rows BK at a time,
//                  loads the two 64-column panels into shared memory
//                  subtracting the mean on load (ragged rows and columns
//                  load as 0, so no padding of x is needed), and each of
//                  its 16x16 threads accumulates a 4x4 register micro-tile
//                  with IEEE fused multiply-adds in the input type. The
//                  block writes its partial tile to workspace[chunk].
//   reduce_mirror  sums the chunk partials of every element in a fixed
//                  order (chunk 0 first) and mirrors the upper triangle
//                  into the lower one. No atomics: the result is
//                  deterministic run to run and exactly symmetric.
//
// Bound: 2 * n * d * (d + 1) / 2 flops against n * d reads of x, so at the
// main path's d = 1024 it is bound by operations (fp32 outside the tensor
// cores), not bytes. This first version is simple and right; wgmma, TMA
// and 3xTF32 are later work.
//
// C interface (bound with ctypes): centered_gram_f32 / centered_gram_f64
// launch both kernels on `stream` and return cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;             // output tile edge
constexpr int BK = 32;               // rows per shared-memory step
constexpr int TX = 16;               // threads along output columns
constexpr int TY = 16;               // threads along output rows
constexpr int MICRO = TILE / TX;     // 4x4 accumulators per thread
constexpr int THREADS = TX * TY;

__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
gram_tiles(const T* __restrict__ x, const T* __restrict__ mean, T* __restrict__ ws,
           int64_t n, int64_t d, int tiles, int64_t rows_per_split) {
  // blockIdx.x enumerates the upper-triangular tile pairs (ti <= tj) row
  // by row; row ti of the triangle holds tiles - ti pairs.
  int p = blockIdx.x;
  int ti = 0;
  while (p >= tiles - ti) {
    p -= tiles - ti;
    ++ti;
  }
  const int tj = ti + p;
  const int64_t split = blockIdx.y;
  const int64_t row0 = split * rows_per_split;
  const int64_t row1 = row0 + rows_per_split < n ? row0 + rows_per_split : n;

  __shared__ T as[BK][TILE];
  __shared__ T bs[BK][TILE];
  __shared__ T mean_a[TILE];
  __shared__ T mean_b[TILE];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * TX + tx;
  const int64_t col_a0 = (int64_t)ti * TILE;
  const int64_t col_b0 = (int64_t)tj * TILE;

  if (tid < TILE) {
    const int64_t ca = col_a0 + tid;
    const int64_t cb = col_b0 + tid;
    mean_a[tid] = ca < d ? mean[ca] : T(0);
    mean_b[tid] = cb < d ? mean[cb] : T(0);
  }

  T acc[MICRO][MICRO];
#pragma unroll
  for (int i = 0; i < MICRO; ++i)
#pragma unroll
    for (int j = 0; j < MICRO; ++j) acc[i][j] = T(0);
  __syncthreads();

  for (int64_t r0 = row0; r0 < row1; r0 += BK) {
    // Consecutive threads load consecutive columns of one row: coalesced.
#pragma unroll
    for (int e = tid; e < BK * TILE; e += THREADS) {
      const int rr = e / TILE;
      const int cc = e % TILE;
      const int64_t r = r0 + rr;
      const int64_t ca = col_a0 + cc;
      const int64_t cb = col_b0 + cc;
      const bool row_ok = r < row1;
      as[rr][cc] = (row_ok && ca < d) ? x[r * d + ca] - mean_a[cc] : T(0);
      bs[rr][cc] = (row_ok && cb < d) ? x[r * d + cb] - mean_b[cc] : T(0);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      // Strided micro-tile (rows ty + 16 i, columns tx + 16 j): the reads
      // of `as` are warp broadcasts, the reads of `bs` hit distinct banks.
      T a[MICRO];
      T b[MICRO];
#pragma unroll
      for (int i = 0; i < MICRO; ++i) a[i] = as[k][ty + TY * i];
#pragma unroll
      for (int j = 0; j < MICRO; ++j) b[j] = bs[k][tx + TX * j];
#pragma unroll
      for (int i = 0; i < MICRO; ++i)
#pragma unroll
        for (int j = 0; j < MICRO; ++j) acc[i][j] = fma_rn(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  T* out = ws + split * d * d;
#pragma unroll
  for (int i = 0; i < MICRO; ++i) {
    const int64_t r = col_a0 + ty + TY * i;
#pragma unroll
    for (int j = 0; j < MICRO; ++j) {
      const int64_t c = col_b0 + tx + TX * j;
      if (r < d && c < d) out[r * d + c] = acc[i][j];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(256)
reduce_mirror(const T* __restrict__ ws, T* __restrict__ out, int64_t d, int splits) {
  const int64_t total = d * d;
  for (int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += (int64_t)gridDim.x * blockDim.x) {
    const int64_t r = idx / d;
    const int64_t c = idx % d;
    // Element (min, max) lies in an upper tile, which gram_tiles wrote.
    const int64_t src = r <= c ? r * d + c : c * d + r;
    T s = T(0);
    for (int z = 0; z < splits; ++z) s += ws[z * total + src];
    out[idx] = s;
  }
}

template <typename T>
int launch(const T* x, const T* mean, T* ws, T* out, long long n, long long d, int splits,
           long long rows_per_split, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int tiles = (int)((d + TILE - 1) / TILE);
  const long long pairs = (long long)tiles * (tiles + 1) / 2;
  dim3 grid((unsigned)pairs, (unsigned)splits);
  dim3 block(TX, TY);
  gram_tiles<T><<<grid, block, 0, stream>>>(x, mean, ws, n, d, tiles, rows_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long total = d * d;
  long long rblocks = (total + 255) / 256;
  if (rblocks > 4096) rblocks = 4096;
  reduce_mirror<T><<<(unsigned)rblocks, 256, 0, stream>>>(ws, out, d, splits);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int centered_gram_f32(const float* x, const float* mean, float* ws, float* out,
                                 long long n, long long d, int splits,
                                 long long rows_per_split, void* stream) {
  return launch<float>(x, mean, ws, out, n, d, splits, rows_per_split, stream);
}

extern "C" int centered_gram_f64(const double* x, const double* mean, double* ws, double* out,
                                 long long n, long long d, int splits,
                                 long long rows_per_split, void* stream) {
  return launch<double>(x, mean, ws, out, n, d, splits, rows_per_split, stream);
}
