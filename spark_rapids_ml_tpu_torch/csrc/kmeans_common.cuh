// Shared pieces of the KMeans assignment kernels K2 (kmeans_assign_stats.cu)
// and K3 (kmeans_assign_packed.cu): the three precision modes, the center
// norms both kernels score with, and the fixed-order reduction of the
// per-block partials. Both kernels include this header, so the same
// arithmetic gives the same bits in each.
//
// Precision modes (the reference kernels' vocabulary):
//   PREC_HIGHEST  IEEE fp32 products, fp32 fused multiply-adds.
//   PREC_HIGH     the 3-pass bf16 split: v = hi + lo with hi = bf16(v) and
//                 lo = bf16(v - hi); a dot is hi*hi + hi*lo + lo*hi, each a
//                 product of bf16 values (exact in fp32), accumulated in fp32.
//                 The stats use x_hi + x_lo (one-hot rows are exact in bf16).
//   PREC_DEFAULT  one pass on bf16-rounded x and centers; stats of bf16(x).
// The cost's sum of x^2 and the center norms c2 use the unrounded fp32
// values in every mode, as the reference computes them outside its dots.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace kmeans {

constexpr int PREC_HIGHEST = 0;
constexpr int PREC_HIGH = 1;
constexpr int PREC_DEFAULT = 2;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The operand parts a mode multiplies: (hi, lo); lo is 0 unless PREC_HIGH.
template <int PREC>
__device__ __forceinline__ void split(float v, float& hi, float& lo) {
  if (PREC == PREC_HIGHEST) {
    hi = v;
    lo = 0.0f;
  } else if (PREC == PREC_HIGH) {
    hi = bf16_round(v);
    lo = bf16_round(v - hi);
  } else {
    hi = bf16_round(v);
    lo = 0.0f;
  }
}

// acc + x.c for one feature, in the mode's passes and order.
template <int PREC>
__device__ __forceinline__ float dot_step(float acc, float xh, float xl, float ch, float cl) {
  acc = __fmaf_rn(xh, ch, acc);
  if (PREC == PREC_HIGH) {
    acc = __fmaf_rn(xh, cl, acc);
    acc = __fmaf_rn(xl, ch, acc);
  }
  return acc;
}

// The value a row contributes to its cluster's sum in this mode.
template <int PREC>
__device__ __forceinline__ float stat_value(float v) {
  float hi, lo;
  split<PREC>(v, hi, lo);
  return hi + lo;
}

// Loads one row into registers, zero past d, split into the mode's parts;
// returns the row's ||x||^2 of the unrounded values (zeros add nothing).
template <int DIM, int PREC>
__device__ __forceinline__ float load_row(const float* __restrict__ xrow, int d, float (&xh)[DIM],
                                          float (&xl)[DIM]) {
  float x2 = 0.0f;
#pragma unroll
  for (int j = 0; j < DIM; ++j) {
    const float v = j < d ? xrow[j] : 0.0f;
    x2 = __fmaf_rn(v, v, x2);
    split<PREC>(v, xh[j], xl[j]);
  }
  return x2;
}

// x.c for a row in registers against one center row in shared memory
// (DIM floats, 16-byte aligned; the lo row is read only in PREC_HIGH).
// Features in order, four per 128-bit shared load.
template <int DIM, int PREC>
__device__ __forceinline__ float center_dot(const float (&xh)[DIM], const float (&xl)[DIM],
                                            const float* __restrict__ ch,
                                            const float* __restrict__ cl) {
  const float4* h4 = reinterpret_cast<const float4*>(ch);
  const float4* l4 = reinterpret_cast<const float4*>(cl);
  float acc = 0.0f;
#pragma unroll
  for (int q = 0; q < DIM / 4; ++q) {
    const float4 h = h4[q];
    const float4 l = PREC == PREC_HIGH ? l4[q] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    acc = dot_step<PREC>(acc, xh[4 * q + 0], xl[4 * q + 0], h.x, l.x);
    acc = dot_step<PREC>(acc, xh[4 * q + 1], xl[4 * q + 1], h.y, l.y);
    acc = dot_step<PREC>(acc, xh[4 * q + 2], xl[4 * q + 2], h.z, l.z);
    acc = dot_step<PREC>(acc, xh[4 * q + 3], xl[4 * q + 3], h.w, l.w);
  }
  return acc;
}

// The score a center gets: c2 - 2 x.c (||x||^2 dropped, argmin-invariant).
__device__ __forceinline__ float score(float c2, float xc) { return c2 - 2.0f * xc; }

// ||c||^2 in fp32, features in order: every block and the final reduction
// compute it the same way, so the c2 returned is the c2 that was scored.
__device__ __forceinline__ float center_norm(const float* __restrict__ c, int d) {
  float s = 0.0f;
  for (int j = 0; j < d; ++j) s = __fmaf_rn(c[j], c[j], s);
  return s;
}

// Sums the per-block partials in block order (no atomics, so the result
// is the same on every run) and writes c2. Element ranges of the grid-
// stride loop: [0, kd) sums, [kd, kd + k) counts, kd + k the cost,
// [kd + k + 1, kd + 2k + 1) c2.
__global__ void __launch_bounds__(256)
reduce_partials(const float* __restrict__ ws_sums, const int* __restrict__ ws_counts,
                const double* __restrict__ ws_cost, const float* __restrict__ centers,
                int blocks, int k, int d, float* __restrict__ sums,
                long long* __restrict__ counts, float* __restrict__ cost,
                float* __restrict__ c2) {
  const long long kd = (long long)k * d;
  const long long total = kd + 2LL * k + 1;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
    if (e < kd) {
      double s = 0.0;
      for (int b = 0; b < blocks; ++b) s += (double)ws_sums[(long long)b * kd + e];
      sums[e] = (float)s;
    } else if (e < kd + k) {
      const long long c = e - kd;
      long long s = 0;
      for (int b = 0; b < blocks; ++b) s += ws_counts[(long long)b * k + c];
      counts[c] = s;
    } else if (e == kd + k) {
      double s = 0.0;
      for (int b = 0; b < blocks; ++b) s += ws_cost[b];
      cost[0] = (float)s;
    } else {
      const long long c = e - kd - k - 1;
      c2[c] = center_norm(centers + c * d, d);
    }
  }
}

inline int launch_reduce(const float* ws_sums, const int* ws_counts, const double* ws_cost,
                         const float* centers, int blocks, int k, int d, float* sums,
                         long long* counts, float* cost, float* c2, cudaStream_t stream) {
  const long long total = (long long)k * d + 2LL * k + 1;
  long long grid = (total + 255) / 256;
  if (grid > 1024) grid = 1024;
  reduce_partials<<<(unsigned)grid, 256, 0, stream>>>(ws_sums, ws_counts, ws_cost, centers,
                                                       blocks, k, d, sums, counts, cost, c2);
  return (int)cudaGetLastError();
}

// Fixed-order tree sum of one double per thread; the result is in red[0].
template <int THREADS>
__device__ __forceinline__ void block_sum(double* red, double v) {
  red[threadIdx.x] = v;
  __syncthreads();
#pragma unroll
  for (int s = THREADS / 2; s > 0; s >>= 1) {
    if ((int)threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
}

}  // namespace kmeans
