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
// Bound: at the main path's 20M x 16, k = 16 it is the one read of x,
// 1.28 GB at 3.35 TB/s = 0.38 ms; its 2.n.k.d = 10 GFLOP take 0.15 ms at
// 67 TFLOP/s. So x is read once, coalesced, and ahead of use, and every
// other step reads shared memory and registers only:
//
//   assign_packed_blocks<DG, PREC, VEC>  a grid of (SMs x resident blocks),
//       each walking a contiguous chunk of rows in sub-tiles. Each
//       warp works alone on its own sub-tiles (w, w + WARPS, ...) with its
//       own stages, masks and sums, so the loop has no block barrier: one
//       warp's copies, scores and sums overlap the others'.
//     - Copy: a sub-tile of consecutive rows is one contiguous span of x.
//       It goes by cp.async into the warp's ring of STAGES stages in shared
//       memory, so the next sub-tile is in flight while one is scored. VEC
//       copies 16-byte chunks (d % 4 == 0 and x 16-byte aligned, chosen by
//       the launcher); otherwise 4-byte elements. A staged row's stride is
//       odd in units of the load (chunks for VEC, floats otherwise), so the
//       eight lanes of a 128-bit shared-load phase, or the 32 of a scalar
//       one, hit distinct banks.
//     - Score: lane l scores rows l (and l + 32 at dg = 16, where two rows
//       share each load of a center: a sub-tile is 64 rows there, 32
//       elsewhere), held in registers, against DG center slots in shared
//       memory with center_dot's chain (center_dots) and score() of
//       kmeans_common.cuh, so labels (lowest index on ties) and c2 are
//       bitwise K2's. Slots past k score the finite sentinel 2^125 (never
//       +inf: the "high" split of inf is NaN).
//     - Group: __match_any_sync on the labels gives, per cluster and 32
//       rows, the mask of the rows with that label (the lowest lane of a
//       group writes it). No sort, no atomics.
//     - Sums: each lane owns fixed (cluster, 4-feature chunk) sums of its
//       warp: it walks the set bits of its cluster's mask in row order,
//       adding the staged rows (one 128-bit load a chunk for VEC) into
//       registers, then adds the sub-tile's partial to its own slots in
//       shared memory once: no read-modify-write a row and no second read
//       of x. The first lane of a cluster adds its masks' counts. At the
//       end the warps' sums are added in warp order into the block's
//       [S, k, d] partial, counts likewise; the cost is a double per
//       thread, summed by a fixed shuffle tree and then warp by warp.
//   What is left above the bound is the sums walk: a lane's loop over its
//   cluster's set bits runs as long as the warp's largest cluster, one
//   dependent shared load a row; scoring alone overlaps the copy.
//   reduce_partials  (kmeans_common.cuh) sums the partials in block order.
// Bitwise repeatable; counts equal K2's, sums and cost within rounding.
//
// C interface (ctypes): kmeans_assign_packed launches both kernels on
// `stream` and returns cudaGetLastError(); kmeans_assign_packed_threads is
// a block's threads at group width dg;
// kmeans_assign_packed_blocks_per_sm its resident blocks per SM.

#include "kmeans_common.cuh"

namespace {

using namespace kmeans;

constexpr float UNUSED_SCORE = 4.2535295865117308e37f;  // 2^125
constexpr int STAGES = 2;
// Warps of a block at each group width.
constexpr int WARPS_16 = 16;
constexpr int WARPS_32 = 8;
constexpr int WARPS_64 = 4;
// Rows a lane scores at dg = 16, where two rows share each center load
// ("high", whose rows take twice the registers, scores one).
constexpr int ROWS_16 = 2;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src));
  }
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int DG, int PREC>
struct Geometry {
  static constexpr int WARPS = DG == 16 ? WARPS_16 : DG == 32 ? WARPS_32 : WARPS_64;
  static constexpr int THREADS = WARPS * 32;
  static constexpr int CHUNKS = DG / 4;                       // 4-feature chunks of a row slot
  static constexpr int LPC = DG == 16 ? 2 : 1;                // lanes sharing a cluster's sums
  static constexpr int CPL = DG == 64 ? 2 : 1;                // clusters a lane sums
  static constexpr int LANE_CHUNKS = CHUNKS / LPC;            // chunks of a cluster a lane sums
  static constexpr int GROUP = LANE_CHUNKS < 4 ? LANE_CHUNKS : 4;  // chunks a walk adds
  static constexpr int UNROLL = DG * DG <= 1024 ? DG : 2;
  static constexpr int ROWS = DG == 16 && PREC != PREC_HIGH ? ROWS_16 : 1;  // rows a lane scores
  static constexpr int SUB = 32 * ROWS;                        // rows of a sub-tile
  // A warp's stage: SUB rows of at most DG/4 + 1 chunks (VEC) or DG + 1 floats.
  static constexpr int STAGE_FLOATS = SUB * (DG + 4);
  // Its ring, its sums [DG][DG], masks [ROWS][DG] and counts [DG].
  static constexpr int WARP_FLOATS = STAGES * STAGE_FLOATS + DG * DG + (ROWS + 1) * DG;
  static constexpr size_t SMEM = 4 * ((size_t)2 * DG * DG + DG + (size_t)WARPS * WARP_FLOATS);
  static_assert(CPL * 32 / LPC == DG, "every cluster slot has its lanes");
};

// Row `row` of a stage as the mode's parts, zero past d; returns ||x||^2 of
// the unrounded values (load_row's arithmetic, from shared memory).
template <int DG, int PREC, bool VEC>
__device__ __forceinline__ float stage_row(const float* __restrict__ st, int row, int stride,
                                           int d, float (&xh)[DG], float (&xl)[DG]) {
  float v[DG];
  if constexpr (VEC) {
    const float4* r4 = reinterpret_cast<const float4*>(st) + row * stride;
#pragma unroll
    for (int q = 0; q < DG / 4; ++q) {
      const float4 c = 4 * q < d ? r4[q] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      v[4 * q + 0] = c.x;
      v[4 * q + 1] = c.y;
      v[4 * q + 2] = c.z;
      v[4 * q + 3] = c.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < DG; ++j) v[j] = j < d ? st[row * stride + j] : 0.0f;
  }
  float x2 = 0.0f;
#pragma unroll
  for (int j = 0; j < DG; ++j) {
    x2 = __fmaf_rn(v[j], v[j], x2);
    split<PREC>(v[j], xh[j], xl[j]);
  }
  return x2;
}

// Chunk q (features 4q .. 4q + 3, zero past d) of row `row` of a stage,
// as the values the row adds to its cluster's sums.
template <int PREC, bool VEC>
__device__ __forceinline__ float4 stage_chunk(const float* __restrict__ st, int row, int stride,
                                              int q, int d) {
  float4 c;
  if constexpr (VEC) {
    c = reinterpret_cast<const float4*>(st)[row * stride + q];
  } else {
    const float* p = st + row * stride + 4 * q;
    c.x = 4 * q + 0 < d ? p[0] : 0.0f;
    c.y = 4 * q + 1 < d ? p[1] : 0.0f;
    c.z = 4 * q + 2 < d ? p[2] : 0.0f;
    c.w = 4 * q + 3 < d ? p[3] : 0.0f;
  }
  return make_float4(stat_value<PREC>(c.x), stat_value<PREC>(c.y), stat_value<PREC>(c.z),
                     stat_value<PREC>(c.w));
}

// Fixed-order sum of one double per thread over WARPS warps (any count):
// a shuffle tree in each warp, then the warps in order; returns the sum in
// thread 0.
template <int WARPS>
__device__ __forceinline__ double warps_sum(double* red, double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  double s = 0.0;
  if (threadIdx.x == 0)
    for (int w = 0; w < WARPS; ++w) s += red[w];
  return s;
}

// x.c of R rows in registers against one center row in shared memory:
// center_dot's feature order and chain, row for row, with each center
// chunk loaded once for the R rows.
template <int DIM, int PREC, int R>
__device__ __forceinline__ void center_dots(const float (&xh)[R][DIM], const float (&xl)[R][DIM],
                                            const float* __restrict__ ch,
                                            const float* __restrict__ cl, float (&acc)[R]) {
  const float4* h4 = reinterpret_cast<const float4*>(ch);
  const float4* l4 = reinterpret_cast<const float4*>(cl);
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.0f;
#pragma unroll
  for (int q = 0; q < DIM / 4; ++q) {
    const float4 h = h4[q];
    const float4 l = PREC == PREC_HIGH ? l4[q] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      acc[r] = dot_step<PREC>(acc[r], xh[r][4 * q + 0], xl[r][4 * q + 0], h.x, l.x);
      acc[r] = dot_step<PREC>(acc[r], xh[r][4 * q + 1], xl[r][4 * q + 1], h.y, l.y);
      acc[r] = dot_step<PREC>(acc[r], xh[r][4 * q + 2], xl[r][4 * q + 2], h.z, l.z);
      acc[r] = dot_step<PREC>(acc[r], xh[r][4 * q + 3], xl[r][4 * q + 3], h.w, l.w);
    }
  }
}

// One warp issues the copies of rows [0, rows) of a sub-tile starting at
// `src` into stage `st`: `units` copy units a row (16-byte chunks for VEC,
// floats otherwise) at `stride` units. Rows of at most 32 units: lane l
// copies unit l % units of rows l / units, + per_pass, ...; longer rows
// (floats past 32): lane l copies units l, l + 32, ... of each row.
// Adjacent lanes read adjacent addresses.
template <bool VEC>
__device__ __forceinline__ void copy_rows(float* __restrict__ st, const float* __restrict__ src,
                                          int rows, int units, int stride, int per_pass,
                                          int my_row, int my_unit) {
  constexpr int W = VEC ? 4 : 1;  // floats a unit
  if (units > 32) {
    for (int r = 0; r < rows; ++r)
      for (int u = my_unit; u < units; u += 32)
        cp_async<4 * W>(st + (r * stride + u) * W, src + ((long long)r * units + u) * W);
    return;
  }
  if (my_row >= per_pass) return;
  for (int r = my_row; r < rows; r += per_pass)
    cp_async<4 * W>(st + (r * stride + my_unit) * W, src + ((long long)r * units + my_unit) * W);
}

template <int DG, int PREC, bool VEC>
__global__ void __launch_bounds__(Geometry<DG, PREC>::THREADS, 1)
assign_packed_blocks(const float* __restrict__ x, const float* __restrict__ centers, long long n,
                     int d, int k, long long rows_per_block, float* __restrict__ ws_sums,
                     int* __restrict__ ws_counts, double* __restrict__ ws_cost) {
  using G = Geometry<DG, PREC>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* c_hi = reinterpret_cast<float*>(smem);  // [DG][DG]
  float* c_lo = c_hi + DG * DG;                  // [DG][DG]
  float* c2s = c_lo + DG * DG;                   // [DG]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // Warp w's own region: its ring, then its sums [DG][DG], masks
  // [ROWS][DG] and counts [DG].
  auto sums_of = [&](int w) { return c2s + DG + w * G::WARP_FLOATS + STAGES * G::STAGE_FLOATS; };
  auto counts_of = [&](int w) { return reinterpret_cast<int*>(sums_of(w) + DG * DG + G::ROWS * DG); };
  float* ring = c2s + DG + warp * G::WARP_FLOATS;  // [STAGES][STAGE_FLOATS]
  float* sums = sums_of(warp);
  unsigned* masks = reinterpret_cast<unsigned*>(sums + DG * DG);
  int* cnt = counts_of(warp);

  // Row layout in a stage: `units` copy units a row at an odd `stride`.
  const int units = VEC ? d / 4 : d;
  const int stride = units | 1;
  const int per_pass = 32 / units;  // 0 for rows of more than 32 units
  const int my_row = units > 32 ? 0 : lane / units;
  const int my_unit = lane - my_row * units;

  // The block's rows [row0, row1) in SUB-row sub-tiles; warp w takes
  // sub-tiles w, w + WARPS, ...
  const long long row0 = (long long)blockIdx.x * rows_per_block;
  const long long row1 = row0 + rows_per_block < n ? row0 + rows_per_block : n;
  const int subtiles = row1 > row0 ? (int)((row1 - row0 + G::SUB - 1) / G::SUB) : 0;
  const int mine = subtiles > warp ? (subtiles - warp + G::WARPS - 1) / G::WARPS : 0;
  auto first_row = [&](int i) -> long long {
    return row0 + (long long)G::SUB * (warp + (long long)i * G::WARPS);
  };
  auto rows_of = [&](int i) -> int {
    const long long left = row1 - first_row(i);
    return left < G::SUB ? (int)left : G::SUB;
  };

  // Start this warp's first copies before the centers are staged.
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < mine)
      copy_rows<VEC>(ring + s * G::STAGE_FLOATS, x + first_row(s) * d, rows_of(s), units, stride,
                     per_pass, my_row, my_unit);
    cp_async_commit();
  }

  for (int e = tid; e < DG * DG; e += G::THREADS) {
    const int c = e / DG;
    const int j = e % DG;
    split<PREC>(c < k && j < d ? centers[(long long)c * d + j] : 0.0f, c_hi[e], c_lo[e]);
  }
  for (int c = tid; c < DG; c += G::THREADS)
    c2s[c] = c < k ? center_norm(centers + (long long)c * d, d) : UNUSED_SCORE;
  for (int e = lane; e < DG * DG; e += 32) sums[e] = 0.0f;
  for (int c = lane; c < DG; c += 32) cnt[c] = 0;
  __syncthreads();  // the only block barrier before the end

  const int chunks = (d + 3) / 4;
  double cost = 0.0;
  for (int i = 0; i < mine; ++i) {
    cp_async_wait<STAGES - 2>();  // this lane's copies of sub-tile i have landed
    __syncwarp();                 // every lane's have; sub-tile i - 1 is finished
    {
      const int nxt = i + STAGES - 1;
      if (nxt < mine)
        copy_rows<VEC>(ring + (nxt % STAGES) * G::STAGE_FLOATS, x + first_row(nxt) * d,
                       rows_of(nxt), units, stride, per_pass, my_row, my_unit);
      cp_async_commit();
    }
    const float* st = ring + (i % STAGES) * G::STAGE_FLOATS;

    // Lane l scores rows l, l + 32, ... of the sub-tile; rows past the
    // end score stale stage values and are dropped.
    const int rows = rows_of(i);
    int label[G::ROWS];
    {
      float xh[G::ROWS][DG], xl[G::ROWS][DG], x2[G::ROWS], best[G::ROWS];
#pragma unroll
      for (int r = 0; r < G::ROWS; ++r) {
        x2[r] = stage_row<DG, PREC, VEC>(st, lane + 32 * r, stride, d, xh[r], xl[r]);
        best[r] = __int_as_float(0x7f800000);  // +inf
        label[r] = 0;  // every score NaN: the reference's argmin gives 0 too
      }
#pragma unroll (G::UNROLL)
      for (int c = 0; c < DG; ++c) {
        float xc[G::ROWS];
        center_dots<DG, PREC, G::ROWS>(xh, xl, c_hi + c * DG, c_lo + c * DG, xc);
#pragma unroll
        for (int r = 0; r < G::ROWS; ++r) {
          const float s = score(c2s[c], xc[r]);
          if (s < best[r]) {
            best[r] = s;
            label[r] = c;
          }
        }
      }
#pragma unroll
      for (int r = 0; r < G::ROWS; ++r) {
        if (lane + 32 * r < rows) {
          cost += (double)x2[r] + (double)best[r];
        } else {
          label[r] = -1;
        }
      }
    }

    // Per 32 rows and cluster, the mask of the rows with that label.
    for (int e = lane; e < G::ROWS * DG; e += 32) masks[e] = 0u;
    __syncwarp();
#pragma unroll
    for (int r = 0; r < G::ROWS; ++r) {
      const unsigned peers = __match_any_sync(0xffffffffu, label[r]);
      if (label[r] >= 0 && (peers & ((1u << lane) - 1u)) == 0u) masks[r * DG + label[r]] = peers;
    }
    __syncwarp();

    // Lane sums: clusters lane / LPC (+ 32 / LPC), chunks from q0, in
    // groups of GROUP chunks, rows in order; one update of its own slots.
#pragma unroll
    for (int a = 0; a < G::CPL; ++a) {
      const int c = lane / G::LPC + a * (32 / G::LPC);
      unsigned bits0[G::ROWS];
#pragma unroll
      for (int r = 0; r < G::ROWS; ++r) bits0[r] = masks[r * DG + c];
      if (lane % G::LPC == 0) {
        int got = 0;
#pragma unroll
        for (int r = 0; r < G::ROWS; ++r) got += __popc(bits0[r]);
        cnt[c] += got;
      }
#pragma unroll
      for (int g = 0; g < G::LANE_CHUNKS / G::GROUP; ++g) {
        const int q0 = (lane % G::LPC) * G::LANE_CHUNKS + g * G::GROUP;
        if (c >= k || q0 >= chunks) continue;
        float4 part[G::GROUP];
#pragma unroll
        for (int u = 0; u < G::GROUP; ++u) part[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
        for (int r = 0; r < G::ROWS; ++r) {
          for (unsigned bits = bits0[r]; bits; bits &= bits - 1u) {
            const int row = 32 * r + __ffs(bits) - 1;
#pragma unroll
            for (int u = 0; u < G::GROUP; ++u) {
              if (q0 + u < chunks) {
                const float4 v = stage_chunk<PREC, VEC>(st, row, stride, q0 + u, d);
                part[u].x += v.x;
                part[u].y += v.y;
                part[u].z += v.z;
                part[u].w += v.w;
              }
            }
          }
        }
#pragma unroll
        for (int u = 0; u < G::GROUP; ++u) {
          float4* own = reinterpret_cast<float4*>(sums + c * DG) + q0 + u;
          float4 s = *own;
          s.x += part[u].x;
          s.y += part[u].y;
          s.z += part[u].z;
          s.w += part[u].w;
          *own = s;
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // The block's partials: warps summed in order.
  float* out = ws_sums + (long long)blockIdx.x * k * d;
  for (int e = tid; e < k * d; e += G::THREADS) {
    const int c = e / d;
    const int j = e - c * d;
    float s = 0.0f;
    for (int w = 0; w < G::WARPS; ++w) s += sums_of(w)[c * DG + j];
    out[e] = s;
  }
  for (int c = tid; c < k; c += G::THREADS) {
    int s = 0;
    for (int w = 0; w < G::WARPS; ++w) s += counts_of(w)[c];
    ws_counts[(long long)blockIdx.x * k + c] = s;
  }
  __syncthreads();
  const double total = warps_sum<G::WARPS>(reinterpret_cast<double*>(c_hi), cost);  // centers unread now
  if (tid == 0) ws_cost[blockIdx.x] = total;
}

template <int DG, int PREC, bool VEC>
int launch_blocks(const float* x, const float* centers, long long n, int d, int k, int blocks,
                  long long rows_per_block, float* ws_sums, int* ws_counts, double* ws_cost,
                  cudaStream_t stream) {
  auto kernel = assign_packed_blocks<DG, PREC, VEC>;
  const size_t smem = Geometry<DG, PREC>::SMEM;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, Geometry<DG, PREC>::THREADS, smem, stream>>>(x, centers, n, d, k, rows_per_block,
                                                         ws_sums, ws_counts, ws_cost);
  return (int)cudaGetLastError();
}

template <int DG, bool VEC>
int launch_prec(int prec, const float* x, const float* centers, long long n, int d, int k,
                int blocks, long long rpb, float* ws_sums, int* ws_counts, double* ws_cost,
                cudaStream_t st) {
  if (prec == PREC_HIGHEST)
    return launch_blocks<DG, PREC_HIGHEST, VEC>(x, centers, n, d, k, blocks, rpb, ws_sums, ws_counts, ws_cost, st);
  if (prec == PREC_HIGH)
    return launch_blocks<DG, PREC_HIGH, VEC>(x, centers, n, d, k, blocks, rpb, ws_sums, ws_counts, ws_cost, st);
  if (prec == PREC_DEFAULT)
    return launch_blocks<DG, PREC_DEFAULT, VEC>(x, centers, n, d, k, blocks, rpb, ws_sums, ws_counts, ws_cost, st);
  return (int)cudaErrorInvalidValue;
}

template <int DG>
int launch_width(bool vec, int prec, const float* x, const float* centers, long long n, int d,
                 int k, int blocks, long long rpb, float* ws_sums, int* ws_counts,
                 double* ws_cost, cudaStream_t st) {
  if (vec) return launch_prec<DG, true>(prec, x, centers, n, d, k, blocks, rpb, ws_sums, ws_counts, ws_cost, st);
  return launch_prec<DG, false>(prec, x, centers, n, d, k, blocks, rpb, ws_sums, ws_counts, ws_cost, st);
}

// Resident blocks per SM of the instantiation at width DG, or minus the
// CUDA error.
template <int DG, int PREC, bool VEC>
int blocks_per_sm() {
  const void* kernel = (const void*)assign_packed_blocks<DG, PREC, VEC>;
  const size_t smem = Geometry<DG, PREC>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int got = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&got, kernel, Geometry<DG, PREC>::THREADS, smem);
  return err == cudaSuccess ? got : -(int)err;
}

template <int DG, bool VEC>
int blocks_per_sm_prec(int prec) {
  if (prec == PREC_HIGHEST) return blocks_per_sm<DG, PREC_HIGHEST, VEC>();
  if (prec == PREC_HIGH) return blocks_per_sm<DG, PREC_HIGH, VEC>();
  if (prec == PREC_DEFAULT) return blocks_per_sm<DG, PREC_DEFAULT, VEC>();
  return -(int)cudaErrorInvalidValue;
}

// The fewer of the two copy variants', so that an aligned and a
// misaligned x get the same block plan and the same sums.
template <int DG>
int blocks_per_sm_width(int prec) {
  const int vec = blocks_per_sm_prec<DG, true>(prec);
  const int scalar = blocks_per_sm_prec<DG, false>(prec);
  return vec < scalar ? vec : scalar;  // an error (negative) wins too
}

}  // namespace

// Threads per block at group width dg.
extern "C" int kmeans_assign_packed_threads(int dg) {
  return 32 * (dg == 16 ? WARPS_16 : dg == 32 ? WARPS_32 : WARPS_64);
}

// Resident blocks per SM on the current device at (dg, prec), the fewer
// of the aligned and misaligned variants', or minus the CUDA error.
extern "C" int kmeans_assign_packed_blocks_per_sm(int dg, int prec) {
  if (dg == 16) return blocks_per_sm_width<16>(prec);
  if (dg == 32) return blocks_per_sm_width<32>(prec);
  if (dg == 64) return blocks_per_sm_width<64>(prec);
  return -(int)cudaErrorInvalidValue;
}

extern "C" int kmeans_assign_packed(const float* x, const float* centers, long long n, int d,
                                    int k, int dg, int prec, int blocks, long long rows_per_block,
                                    float* ws_sums, int* ws_counts, double* ws_cost, float* sums,
                                    long long* counts, float* cost, float* c2, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (d < 1 || k < 1 || d > dg || k > dg || blocks < 1) return (int)cudaErrorInvalidValue;
  // 16-byte copies need every row 16-byte aligned: d % 4 == 0 and x aligned.
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  int err;
  if (dg == 16)
    err = launch_width<16>(vec, prec, x, centers, n, d, k, blocks, rows_per_block, ws_sums, ws_counts, ws_cost, stream);
  else if (dg == 32)
    err = launch_width<32>(vec, prec, x, centers, n, d, k, blocks, rows_per_block, ws_sums, ws_counts, ws_cost, stream);
  else if (dg == 64)
    err = launch_width<64>(vec, prec, x, centers, n, d, k, blocks, rows_per_block, ws_sums, ws_counts, ws_cost, stream);
  else
    return (int)cudaErrorInvalidValue;
  if (err != 0) return err;
  return kmeans::launch_reduce(ws_sums, ws_counts, ws_cost, centers, blocks, k, d, sums, counts, cost,
                               c2, stream);
}
