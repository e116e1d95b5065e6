// KMeans assignment + update statistics, kernel K2, on Hopper (sm_90a).
//
// Replaces the TPU kernel spark_rapids_ml_tpu/ops/pallas/kmeans.py
// (assign_stats_fused, body _assign_stats_kernel). For row-major float32
// x (n, d) and centers (k, d) it computes, over the n real rows:
//   score(row, c) = c2[c] - 2 x.c, label = argmin (lowest index on ties,
//   as jnp.argmin), sums[label] += x, counts[label] += 1,
//   cost += ||x||^2 + min score,
// and returns the c2 it scored with. No (n, k) array is ever written.
//
// The TPU kernel walked one sequential grid into one resident accumulator
// and read x transposed and padded (a lane-layout artifact). Hopper blocks
// run in no order, so this kernel follows the K1 pattern instead:
//
//   assign_stats_blocks  each block walks a contiguous chunk of rows, 256
//                        at a time, with the centers (split into the
//                        precision mode's parts) and c2 in shared memory.
//                        A thread scores one row against all k centers in
//                        fp32 FMAs, the row held in registers (d <= 64,
//                        padded to 16/32/64) or read from cache (d > 64).
//                        The tile's rows are then grouped by label with a
//                        stable counting sort (warp __match_any_sync ranks,
//                        per-warp counts, a warp scan for the offsets), and
//                        each (cluster, feature) sum is owned by one thread,
//                        which adds its cluster's rows in row order. Counts
//                        are integers; the cost is a double per thread and
//                        a fixed-order tree. The ragged edge is masked, so
//                        x is never padded. Partials go to [S, k, d].
//   reduce_partials      (kmeans_common.cuh) sums the S partials in block
//                        order. No atomics anywhere: bitwise repeatable.
//
// Bound: 2.n.k.d operations on n.d.4 bytes. At the main path's 20M x 16,
// k = 100, highest, that is 64 GFLOP, 0.96 ms at 67 TFLOP/s fp32 against
// 0.38 ms to read 1.28 GB: bound by operations. The design answers with
// the row in registers and 128-bit broadcast loads of the centers (one
// shared load per four FMAs); the grouping and the owned sums cost about
// d operations per row, against k.d for the scores. The precision modes
// (kmeans_common.cuh) run on the fp32 units too: "high" does three FMAs
// per product. Tensor cores (wgmma over a row tile) are later work.
//
// C interface (ctypes): kmeans_assign_stats launches both kernels on
// `stream` and returns cudaGetLastError(); kmeans_assign_stats_smem_bytes
// is the shared memory one block needs.

#include "kmeans_common.cuh"

namespace {

using namespace kmeans;

constexpr int BLOCK = 256;
constexpr int NW = BLOCK / 32;
constexpr size_t MAX_SMEM = 232448;  // 227 KB, a Hopper block's most

int register_width(int d) { return d <= 16 ? 16 : d <= 32 ? 32 : d <= 64 ? 64 : 0; }

size_t smem_bytes(int d, int k) {
  const size_t ds = register_width(d) ? register_width(d) : d;
  return sizeof(double) * BLOCK                       // cost tree
         + 4 * (2 * (size_t)k * ds + k + (size_t)k * d)  // c_hi, c_lo, c2, block sums
         + 4 * ((size_t)k * (NW + 2) + 1 + BLOCK);       // counts, warp counts, offsets, order
}

template <int DREG, int PREC>
__global__ void __launch_bounds__(BLOCK)
assign_stats_blocks(const float* __restrict__ x, const float* __restrict__ centers, long long n,
                    int d, int k, long long rows_per_block, float* __restrict__ ws_sums,
                    int* __restrict__ ws_counts, double* __restrict__ ws_cost) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ds = DREG > 0 ? DREG : d;
  double* red = reinterpret_cast<double*>(smem);
  float* c_hi = reinterpret_cast<float*>(red + BLOCK);
  float* c_lo = c_hi + k * ds;
  float* c2s = c_lo + k * ds;
  float* bsums = c2s + k;
  int* bcount = reinterpret_cast<int*>(bsums + k * d);
  int* wcnt = bcount + k;      // [NW][k]
  int* toff = wcnt + NW * k;   // [k + 1]
  int* order = toff + k + 1;   // [BLOCK]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int e = tid; e < k * ds; e += BLOCK) {
    const int c = e / ds;
    const int j = e - c * ds;
    split<PREC>(j < d ? centers[(long long)c * d + j] : 0.0f, c_hi[e], c_lo[e]);
  }
  for (int c = tid; c < k; c += BLOCK) {
    c2s[c] = center_norm(centers + (long long)c * d, d);
    bcount[c] = 0;
  }
  for (int e = tid; e < k * d; e += BLOCK) bsums[e] = 0.0f;
  double cost = 0.0;
  const long long row0 = (long long)blockIdx.x * rows_per_block;
  const long long row1 = row0 + rows_per_block < n ? row0 + rows_per_block : n;
  __syncthreads();

  for (long long t0 = row0; t0 < row1; t0 += BLOCK) {
    const long long r = t0 + tid;
    const bool valid = r < row1;
    for (int e = tid; e < NW * k; e += BLOCK) wcnt[e] = 0;
    int label = -1;
    if (valid) {
      const float* xrow = x + r * d;
      float best = __int_as_float(0x7f800000);  // +inf
      float x2;
      if constexpr (DREG > 0) {
        float xh[DREG], xl[DREG];
        x2 = load_row<DREG, PREC>(xrow, d, xh, xl);
        for (int c = 0; c < k; ++c) {
          const float s = score(c2s[c], center_dot<DREG, PREC>(xh, xl, c_hi + c * DREG,
                                                               c_lo + c * DREG));
          if (s < best) {
            best = s;
            label = c;
          }
        }
      } else {
        x2 = 0.0f;
        for (int j = 0; j < d; ++j) x2 = __fmaf_rn(xrow[j], xrow[j], x2);
        for (int c = 0; c < k; ++c) {
          float acc = 0.0f;
          for (int j = 0; j < d; ++j) {
            float xh, xl;
            split<PREC>(xrow[j], xh, xl);
            acc = dot_step<PREC>(acc, xh, xl, c_hi[c * ds + j], c_lo[c * ds + j]);
          }
          const float s = score(c2s[c], acc);
          if (s < best) {
            best = s;
            label = c;
          }
        }
      }
      if (label < 0) label = 0;  // every score NaN: the reference's argmin gives 0 too
      cost += (double)x2 + (double)best;
    }
    __syncthreads();  // warp counts zeroed; the previous tile's sums are done

    // Stable counting sort of the tile's rows by label.
    const unsigned peers = __match_any_sync(0xffffffffu, label);
    const int rank = __popc(peers & ((1u << lane) - 1u));
    if (valid && rank == 0) wcnt[warp * k + label] = __popc(peers);
    __syncthreads();
    if (warp == 0) {
      const int per = (k + 31) / 32;
      const int c0 = lane * per;
      const int c1 = c0 + per < k ? c0 + per : k;
      int local = 0;
      for (int c = c0; c < c1; ++c)
        for (int w = 0; w < NW; ++w) local += wcnt[w * k + c];
      int incl = local;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += v;
      }
      int run = incl - local;
      for (int c = c0; c < c1; ++c) {
        int t = 0;
        for (int w = 0; w < NW; ++w) t += wcnt[w * k + c];
        toff[c] = run;
        run += t;
        bcount[c] += t;
      }
      if (lane == 31) toff[k] = incl;
    }
    __syncthreads();
    if (valid) {
      int pos = toff[label] + rank;
      for (int w = 0; w < warp; ++w) pos += wcnt[w * k + label];
      order[pos] = tid;
    }
    __syncthreads();

    // Each (cluster, feature) sum has one owner thread: row order, no races.
    for (int e = tid; e < k * d; e += BLOCK) {
      const int c = e / d;
      const int j = e - c * d;
      float acc = 0.0f;
      for (int p = toff[c]; p < toff[c + 1]; ++p)
        acc += stat_value<PREC>(x[(t0 + order[p]) * d + j]);
      bsums[e] += acc;
    }
  }
  __syncthreads();

  float* out = ws_sums + (long long)blockIdx.x * k * d;
  for (int e = tid; e < k * d; e += BLOCK) out[e] = bsums[e];
  for (int c = tid; c < k; c += BLOCK) ws_counts[(long long)blockIdx.x * k + c] = bcount[c];
  block_sum<BLOCK>(red, cost);
  if (tid == 0) ws_cost[blockIdx.x] = red[0];
}

template <int DREG, int PREC>
int launch_blocks(const float* x, const float* centers, long long n, int d, int k, int blocks,
                  long long rows_per_block, float* ws_sums, int* ws_counts, double* ws_cost,
                  size_t smem, cudaStream_t stream) {
  auto kernel = assign_stats_blocks<DREG, PREC>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, BLOCK, smem, stream>>>(x, centers, n, d, k, rows_per_block, ws_sums,
                                          ws_counts, ws_cost);
  return (int)cudaGetLastError();
}

template <int PREC>
int launch_width(int dreg, const float* x, const float* centers, long long n, int d, int k,
                 int blocks, long long rpb, float* ws_sums, int* ws_counts, double* ws_cost,
                 size_t smem, cudaStream_t st) {
  switch (dreg) {
    case 16:
      return launch_blocks<16, PREC>(x, centers, n, d, k, blocks, rpb, ws_sums, ws_counts, ws_cost, smem, st);
    case 32:
      return launch_blocks<32, PREC>(x, centers, n, d, k, blocks, rpb, ws_sums, ws_counts, ws_cost, smem, st);
    case 64:
      return launch_blocks<64, PREC>(x, centers, n, d, k, blocks, rpb, ws_sums, ws_counts, ws_cost, smem, st);
    default:
      return launch_blocks<0, PREC>(x, centers, n, d, k, blocks, rpb, ws_sums, ws_counts, ws_cost, smem, st);
  }
}

}  // namespace

extern "C" long long kmeans_assign_stats_smem_bytes(int d, int k) {
  return (long long)smem_bytes(d, k);
}

extern "C" int kmeans_assign_stats(const float* x, const float* centers, long long n, int d,
                                   int k, int prec, int blocks, long long rows_per_block,
                                   float* ws_sums, int* ws_counts, double* ws_cost, float* sums,
                                   long long* counts, float* cost, float* c2, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const size_t smem = smem_bytes(d, k);
  if (smem > MAX_SMEM || d < 1 || k < 1 || blocks < 1) return (int)cudaErrorInvalidValue;
  const int dreg = register_width(d);
  int err;
  if (prec == kmeans::PREC_HIGHEST)
    err = launch_width<kmeans::PREC_HIGHEST>(dreg, x, centers, n, d, k, blocks, rows_per_block, ws_sums, ws_counts, ws_cost, smem, stream);
  else if (prec == kmeans::PREC_HIGH)
    err = launch_width<kmeans::PREC_HIGH>(dreg, x, centers, n, d, k, blocks, rows_per_block, ws_sums, ws_counts, ws_cost, smem, stream);
  else if (prec == kmeans::PREC_DEFAULT)
    err = launch_width<kmeans::PREC_DEFAULT>(dreg, x, centers, n, d, k, blocks, rows_per_block, ws_sums, ws_counts, ws_cost, smem, stream);
  else
    return (int)cudaErrorInvalidValue;
  if (err != 0) return err;
  return kmeans::launch_reduce(ws_sums, ws_counts, ws_cost, centers, blocks, k, d, sums, counts, cost,
                       c2, stream);
}
