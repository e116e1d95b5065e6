// KMeans assignment + statistics for small d and small k, kernel K3, on
// Hopper (sm_90a).
//
// Replaces the TPU kernel spark_rapids_ml_tpu/ops/pallas/kmeans.py
// (assign_stats_packed, body _assign_stats_packed_kernel). That kernel
// packed P = 128/dg row groups into one 128-lane contraction against
// block-diagonal centers: a property of the TPU's systolic array. What
// carries over is its contract: the same statistics as K2
// (kmeans_assign_stats.cu) for d_pad <= dg and k <= kg, where (dg, kg) is
// (16, 16), (32, 32) or (64, 64) by the reference's _packed_geometry.
//
//   assign_packed_blocks<DG, PREC>  dg = kg = DG are compile-time, so the
//       score loop over kg centers x dg features unrolls (fully up to
//       32 x 32). Centers (zero past d and k) and c2 sit in shared memory;
//       unused slots score the finite sentinel 2^125, so no row lands
//       there (never +inf: the "high" split of inf is NaN). A thread
//       scores one row held in registers with the same center_dot as K2,
//       so its labels are K2's. Then each warp adds its 32 rows to its own
//       (kg, dg) partial sums in row order, lane j owning feature j (two
//       half-warps with two copies at dg = 16): no races, no atomics.
//       Partials merge in warp order into [S, k, d].
//   reduce_partials  (kmeans_common.cuh) sums them in block order.
// Bitwise repeatable; counts equal K2's, sums and cost within rounding.
//
// Bound: at the main path's 20M x 16, k = 16 it is the 0.38 ms read of x
// (1.28 GB at 3.35 TB/s), not its 0.15 ms of operations (2.n.k.d =
// 10 GFLOP at 67 TFLOP/s). The design keeps the per-row work to the
// k.d = 256 FMAs and one pass of d loads, and reads x once from device
// memory (the stats pass rereads the warp's rows from L1).
//
// C interface (ctypes): kmeans_assign_packed launches both kernels on
// `stream` and returns cudaGetLastError().

#include "kmeans_common.cuh"

namespace {

using namespace kmeans;

constexpr float UNUSED_SCORE = 4.2535295865117308e37f;  // 2^125

template <int DG>
struct Geometry {
  static constexpr int NW = DG == 64 ? 4 : 8;        // warps per block
  static constexpr int THREADS = NW * 32;
  static constexpr int SUBS = DG < 32 ? 32 / DG : 1;  // partial copies per warp
  static constexpr int UNROLL = DG * DG <= 1024 ? DG : 4;
  static constexpr size_t SMEM = sizeof(double) * THREADS + 4 * (2 * DG * DG + DG)
                                 + 4 * (size_t)NW * SUBS * DG * (DG + 1);
};

template <int DG, int PREC>
__global__ void __launch_bounds__(Geometry<DG>::THREADS)
assign_packed_blocks(const float* __restrict__ x, const float* __restrict__ centers, long long n,
                     int d, int k, long long rows_per_block, float* __restrict__ ws_sums,
                     int* __restrict__ ws_counts, double* __restrict__ ws_cost) {
  using G = Geometry<DG>;
  extern __shared__ __align__(16) unsigned char smem[];
  double* red = reinterpret_cast<double*>(smem);
  float* c_hi = reinterpret_cast<float*>(red + G::THREADS);
  float* c_lo = c_hi + DG * DG;
  float* c2s = c_lo + DG * DG;
  float* wsum = c2s + DG;                                       // [NW * SUBS][DG][DG]
  int* wcnt = reinterpret_cast<int*>(wsum + G::NW * G::SUBS * DG * DG);  // [NW * SUBS][DG]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int e = tid; e < DG * DG; e += G::THREADS) {
    const int c = e / DG;
    const int j = e % DG;
    split<PREC>(c < k && j < d ? centers[(long long)c * d + j] : 0.0f, c_hi[e], c_lo[e]);
  }
  for (int c = tid; c < DG; c += G::THREADS)
    c2s[c] = c < k ? center_norm(centers + (long long)c * d, d) : UNUSED_SCORE;
  for (int e = tid; e < G::NW * G::SUBS * DG * DG; e += G::THREADS) wsum[e] = 0.0f;
  for (int e = tid; e < G::NW * G::SUBS * DG; e += G::THREADS) wcnt[e] = 0;
  __syncthreads();

  // Lane roles in the statistics pass: half-warp h takes rows h, h + SUBS,
  // ... of the warp's 32 and owns feature j of its own partial copy.
  const int h = lane / (32 / G::SUBS);
  const int j0 = lane % (32 / G::SUBS);
  float* my_sum = wsum + (warp * G::SUBS + h) * DG * DG;
  int* my_cnt = wcnt + (warp * G::SUBS + h) * DG;

  double cost = 0.0;
  const long long row0 = (long long)blockIdx.x * rows_per_block;
  const long long row1 = row0 + rows_per_block < n ? row0 + rows_per_block : n;
  for (long long t0 = row0; t0 < row1; t0 += G::THREADS) {
    const long long r = t0 + tid;
    int label = -1;
    if (r < row1) {
      float xh[DG], xl[DG];
      const float x2 = load_row<DG, PREC>(x + r * d, d, xh, xl);
      float best = __int_as_float(0x7f800000);  // +inf
      label = 0;
#pragma unroll (G::UNROLL)
      for (int c = 0; c < DG; ++c) {
        const float s = score(c2s[c], center_dot<DG, PREC>(xh, xl, c_hi + c * DG, c_lo + c * DG));
        if (s < best) {
          best = s;
          label = c;
        }
      }
      cost += (double)x2 + (double)best;
    }
    const long long wrow0 = t0 + warp * 32;
#pragma unroll 4
    for (int rr = 0; rr < 32 / G::SUBS; ++rr) {
      const int src = rr * G::SUBS + h;
      const int lab = __shfl_sync(0xffffffffu, label, src);
      if (lab >= 0) {
        const float* xr = x + (wrow0 + src) * d;
        for (int j = j0; j < d; j += 32 / G::SUBS) my_sum[lab * DG + j] += stat_value<PREC>(xr[j]);
        if (j0 == 0) my_cnt[lab] += 1;
      }
    }
  }
  __syncthreads();

  float* out = ws_sums + (long long)blockIdx.x * k * d;
  for (int e = tid; e < k * d; e += G::THREADS) {
    const int c = e / d;
    const int j = e - c * d;
    float s = 0.0f;
    for (int q = 0; q < G::NW * G::SUBS; ++q) s += wsum[q * DG * DG + c * DG + j];
    out[e] = s;
  }
  for (int c = tid; c < k; c += G::THREADS) {
    int s = 0;
    for (int q = 0; q < G::NW * G::SUBS; ++q) s += wcnt[q * DG + c];
    ws_counts[(long long)blockIdx.x * k + c] = s;
  }
  block_sum<G::THREADS>(red, cost);
  if (tid == 0) ws_cost[blockIdx.x] = red[0];
}

template <int DG, int PREC>
int launch_blocks(const float* x, const float* centers, long long n, int d, int k, int blocks,
                  long long rows_per_block, float* ws_sums, int* ws_counts, double* ws_cost,
                  cudaStream_t stream) {
  auto kernel = assign_packed_blocks<DG, PREC>;
  const size_t smem = Geometry<DG>::SMEM;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, Geometry<DG>::THREADS, smem, stream>>>(x, centers, n, d, k, rows_per_block,
                                                         ws_sums, ws_counts, ws_cost);
  return (int)cudaGetLastError();
}

template <int DG>
int launch_prec(int prec, const float* x, const float* centers, long long n, int d, int k,
                int blocks, long long rpb, float* ws_sums, int* ws_counts, double* ws_cost,
                cudaStream_t st) {
  if (prec == PREC_HIGHEST)
    return launch_blocks<DG, PREC_HIGHEST>(x, centers, n, d, k, blocks, rpb, ws_sums, ws_counts, ws_cost, st);
  if (prec == PREC_HIGH)
    return launch_blocks<DG, PREC_HIGH>(x, centers, n, d, k, blocks, rpb, ws_sums, ws_counts, ws_cost, st);
  if (prec == PREC_DEFAULT)
    return launch_blocks<DG, PREC_DEFAULT>(x, centers, n, d, k, blocks, rpb, ws_sums, ws_counts, ws_cost, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Threads per block at group width dg (the wrapper sizes row chunks by it).
extern "C" int kmeans_assign_packed_threads(int dg) {
  return dg == 16 ? Geometry<16>::THREADS : dg == 32 ? Geometry<32>::THREADS
                                                     : Geometry<64>::THREADS;
}

extern "C" int kmeans_assign_packed(const float* x, const float* centers, long long n, int d,
                                    int k, int dg, int prec, int blocks, long long rows_per_block,
                                    float* ws_sums, int* ws_counts, double* ws_cost, float* sums,
                                    long long* counts, float* cost, float* c2, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (d < 1 || k < 1 || d > dg || k > dg || blocks < 1) return (int)cudaErrorInvalidValue;
  int err;
  if (dg == 16)
    err = launch_prec<16>(prec, x, centers, n, d, k, blocks, rows_per_block, ws_sums, ws_counts, ws_cost, stream);
  else if (dg == 32)
    err = launch_prec<32>(prec, x, centers, n, d, k, blocks, rows_per_block, ws_sums, ws_counts, ws_cost, stream);
  else if (dg == 64)
    err = launch_prec<64>(prec, x, centers, n, d, k, blocks, rows_per_block, ws_sums, ws_counts, ws_cost, stream);
  else
    return (int)cudaErrorInvalidValue;
  if (err != 0) return err;
  return kmeans::launch_reduce(ws_sums, ws_counts, ws_cost, centers, blocks, k, d, sums, counts, cost,
                       c2, stream);
}
