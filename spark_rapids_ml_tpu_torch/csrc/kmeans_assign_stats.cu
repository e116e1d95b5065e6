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
// run in no order, so each block here walks a contiguous chunk of rows
// into its own [k, d] partial, and reduce_partials (kmeans_common.cuh)
// sums the partials in block order. No atomics anywhere: bitwise
// repeatable. The ragged edge is masked, so x is never padded.
//
// Bound: 2.n.k.d operations on n.d.4 bytes. At the main path's 20M x 16,
// k = 100, highest, that is 64 GFLOP, 0.96 ms at 67 TFLOP/s fp32 against
// 0.38 ms to read 1.28 GB: bound by operations, all of them fp32 FMAs on
// the CUDA cores (the labels and c2 are held bitwise to K3's, which
// scores through the same center_dot chain, so no tensor-core route). An
// FMA takes an issue slot like any other instruction, so the design
// spends as few other instructions per FMA as it can. Two variants:
//
//   assign_stats_warps<DREG, PREC, VEC>  for d <= 64 (DREG = 16/32/64)
//       whenever WARPS_MIN warps fit the block's shared memory (warps in
//       multiples of 4, so each of the SM's schedulers has as many). Each
//       warp works alone on its own sub-tiles (w, w + warps, ...) of SUB
//       = 32.ROWS rows, with no block barrier in the row loop:
//     - Copy: a sub-tile is one contiguous span of x. The warp copies it
//       by cp.async into its own stage in shared memory (K3's copy: 16-
//       byte chunks when d % 4 == 0 and x is 16-byte aligned, 4-byte
//       elements otherwise; odd row strides, so a phase of lanes reading
//       their own rows hits distinct banks). Once the rows are in
//       registers the next sub-tile's copy goes out, behind the scores.
//     - Score: lane l holds rows l, l + 32, ... (ROWS of them) in
//       registers and scores them against every center with
//       center_dots: center_dot's FMA chain in feature order, row for
//       row, so labels and c2 are bitwise K3's, with each 128-bit
//       broadcast load of a center chunk shared by the ROWS rows. Where
//       no row's ||x||^2 and no c2 reaches 2^124, 2 x.c cannot overflow
//       and score()'s c2 - 2 x.c is the same bits in one FFMA. At DREG =
//       16, ROWS = 4: a (row, center) pair costs ~22 instructions for its
//       16 FMAs (the score, compare and two selects, and a share of the
//       center loads, are the rest).
//     - Counts: per 32 rows, __match_any_sync on the labels; the lowest
//       lane of each label adds the group's size to the warp's counts.
//     - Sums: 16 rows at a time go from registers into a transpose buffer;
//       then lane j owns feature j (and j + 32), and the rows are added in
//       pairs, in row order, into the warp's private [k + 1, DREG] sums at
//       their labels (lanes past d and rows past the end add into padding
//       and row k). At DREG = 16 each half-warp takes one row of a pair.
//       A few instructions a row, whether the labels are random or sorted;
//       no lane writes a slot another lane reads.
//     At block end the warps' sums and counts are added in warp order;
//     the cost is a double per lane, summed by a shuffle tree and then
//     warp by warp.
//   assign_stats_blocks<DREG, PREC>  every other (d, k) fused_feasible
//       admits (d > 64, or k.d too large for WARPS_MIN warps' sums):
//       256-row tiles, a thread a row, the row in registers (d <= 64) or
//       read from cache (d > 64); the tile's rows are grouped by label
//       with a stable counting sort (warp __match_any_sync ranks, per-
//       warp counts, a warp scan for the offsets), and each (cluster,
//       feature) sum is owned by one thread, which adds its cluster's rows
//       in row order. Its shared memory (smem_bytes) is the feasibility
//       rule, so every shape either variant takes is admitted.
// Both run one wave: the launcher's caller sizes the grid from
// kmeans_assign_stats_blocks_per_sm (the CUDA occupancy API).
//
// C interface (ctypes): kmeans_assign_stats launches the variant for (d,
// k, prec) and reduce_partials on `stream` and returns cudaGetLastError();
// kmeans_assign_stats_smem_bytes is the sort variant's shared memory (the
// feasibility rule), kmeans_assign_stats_warps the warps of a warp-variant
// block (0 when the sort variant runs), kmeans_assign_stats_blocks_per_sm
// the resident blocks per SM of the variant that runs.

#include <type_traits>

#include "kmeans_common.cuh"

namespace {

using namespace kmeans;

constexpr size_t MAX_SMEM = 232448;  // 227 KB, a Hopper block's most

// The sort variant: threads a block.
constexpr int BLOCK = 256;
constexpr int NW = BLOCK / 32;

// The warp variant: rows a lane scores at each register width ("high",
// whose rows take twice the registers, scores fewer), and the warps of a
// block: as many as shared memory holds, in multiples of 4, up to
// WARPS_MAX, or WARPS_MAX_WIDE where a lane's rows take 128 registers or
// more (a 256-thread block leaves each thread 255); below WARPS_MIN the
// sort variant runs.
constexpr int ROWS_16 = 4;
constexpr int ROWS_16_HIGH = 2;
constexpr int ROWS_32 = 2;
constexpr int ROWS_32_HIGH = 1;
constexpr int ROWS_64 = 1;
constexpr int WARPS_MAX = 12;
constexpr int WARPS_MAX_WIDE = 8;
constexpr int WARPS_MIN = 4;
constexpr int RED_BYTES = 128;  // the cost's per-warp doubles, 16 at most
// Below this, a row's ||x||^2 and a center's c2 keep 2 x.c (in any mode's
// parts, rounding included) far from overflow.
constexpr float NORM_LIMIT = 2.1267647932558654e37f;  // 2^124

int register_width(int d) { return d <= 16 ? 16 : d <= 32 ? 32 : d <= 64 ? 64 : 0; }

__host__ __device__ constexpr int round4(int v) { return (v + 3) & ~3; }

size_t smem_bytes(int d, int k) {
  const size_t ds = register_width(d) ? register_width(d) : d;
  return sizeof(double) * BLOCK                       // cost tree
         + 4 * (2 * (size_t)k * ds + k + (size_t)k * d)  // c_hi, c_lo, c2, block sums
         + 4 * ((size_t)k * (NW + 2) + 1 + BLOCK);       // counts, warp counts, offsets, order
}

__host__ __device__ constexpr int warp_rows(int dreg, int prec) {
  return dreg == 16 ? (prec == PREC_HIGH ? ROWS_16_HIGH : ROWS_16)
         : dreg == 32 ? (prec == PREC_HIGH ? ROWS_32_HIGH : ROWS_32)
                      : ROWS_64;
}

__host__ __device__ constexpr int warp_max(int dreg, int prec) {
  return warp_rows(dreg, prec) * dreg * (prec == PREC_HIGH ? 2 : 1) >= 128 ? WARPS_MAX_WIDE
                                                                            : WARPS_MAX;
}

// Shared memory of the warp variant: the block's part (cost doubles, the
// centers' parts, c2) and each warp's (its stage of SUB rows and its
// transpose buffer of 16, each row at most DREG + 4 floats, its [k + 1,
// DREG] sums and its counts), all 16-byte aligned.
size_t warp_fixed_bytes(int dreg, int prec, int k) {
  return RED_BYTES + 4 * ((size_t)(prec == PREC_HIGH ? 2 : 1) * k * dreg + round4(k));
}

size_t warp_bytes(int dreg, int prec, int d, int k) {
  const size_t rows = 32 * warp_rows(dreg, prec) + 16;  // the stage and the transpose buffer
  return 4 * (rows * (dreg + 4) + (size_t)(k + 1) * dreg + round4(k));
}

// Warps of a warp-variant block at (d, k, prec), or 0 for the sort variant.
int warp_count(int d, int k, int prec) {
  const int dreg = register_width(d);
  if (dreg == 0) return 0;
  const size_t fixed = warp_fixed_bytes(dreg, prec, k);
  if (fixed >= MAX_SMEM) return 0;
  size_t w = (MAX_SMEM - fixed) / warp_bytes(dreg, prec, d, k);
  if (w > (size_t)warp_max(dreg, prec)) w = warp_max(dreg, prec);
  w -= w % 4;  // the same number of warps on each of the SM's four schedulers
  return w >= (size_t)WARPS_MIN ? (int)w : 0;
}

size_t warp_smem(int d, int k, int prec, int warps) {
  const int dreg = register_width(d);
  return warp_fixed_bytes(dreg, prec, k) + (size_t)warps * warp_bytes(dreg, prec, d, k);
}

// --- the warp variant -------------------------------------------------------

template <int DREG, int PREC>
struct WarpGeometry {
  static constexpr int ROWS = warp_rows(DREG, PREC);
  static constexpr int SUB = 32 * ROWS;                 // rows of a sub-tile
  static constexpr int STAGE_FLOATS = SUB * (DREG + 4);  // at most DREG/4 + 1 chunks a row
  static constexpr int THREADS = 32 * warp_max(DREG, PREC);
};

// The cp.async copy and stage reads below are K3's (kmeans_assign_packed.cu).
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

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

// One warp issues the copies of rows [0, rows) starting at `src` into the
// stage `st`: `units` copy units a row (16-byte chunks for VEC, floats
// otherwise) at `stride` units. Rows of at most 32 units: lane l copies
// unit l % units of rows l / units, + per_pass, ...; longer rows: lane l
// copies units l, l + 32, ... of each row. Adjacent lanes read adjacent
// addresses.
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

// Row `row` of a stage as the mode's parts, zero past d; returns ||x||^2
// of the unrounded values (load_row's arithmetic, from shared memory).
template <int DIM, int PREC, bool VEC>
__device__ __forceinline__ float stage_row(const float* __restrict__ st, int row, int stride,
                                           int d, float (&xh)[DIM], float (&xl)[DIM]) {
  float v[DIM];
  if constexpr (VEC) {
    const float4* r4 = reinterpret_cast<const float4*>(st) + row * stride;
#pragma unroll
    for (int q = 0; q < DIM / 4; ++q) {
      const float4 c = 4 * q < d ? r4[q] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      v[4 * q + 0] = c.x;
      v[4 * q + 1] = c.y;
      v[4 * q + 2] = c.z;
      v[4 * q + 3] = c.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < DIM; ++j) v[j] = j < d ? st[row * stride + j] : 0.0f;
  }
  float x2 = 0.0f;
#pragma unroll
  for (int j = 0; j < DIM; ++j) {
    x2 = __fmaf_rn(v[j], v[j], x2);
    split<PREC>(v[j], xh[j], xl[j]);
  }
  return x2;
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

// Adds 16 rows into a warp's sums, which are [k + 1][DREG] (row k takes
// what no cluster owns: rows past the end of a sub-tile carry label k, and
// lanes past d add into columns past d). The rows are in the warp's
// transpose buffer t, TS floats apart, as the values they add; lane
// base + s holds row s's label. Rows go in pairs, in row order. At DREG =
// 16 half-warp h adds row 2p + h, lane j its feature j; wider, lane j adds
// features j (and j + 32) of both rows. Two rows of one label make one
// update (the first row's lanes add both, the second's go to row k), so
// the two updates of a pair share no address outside row k.
template <int DREG>
__device__ __forceinline__ void add_rows(float* sums, const float* t, int label, int base, int k,
                                         int lane) {
  constexpr int TS = DREG + 4;
  if constexpr (DREG == 16) {
    // Each lane works out where its row goes: its label's offset, or row k
    // when it is the second row of a pair (lanes 2m, 2m + 1) whose first
    // shares its label, with the sign bit set when it is that first row
    // (it adds both).
    const bool same = __shfl_xor_sync(0xffffffffu, label, 1) == label;
    const int where = (lane & 1) && same ? k : label;
    const int packed = where * DREG | ((lane & 1) == 0 && same ? int(0x80000000u) : 0);
    const int h = lane >> 4;
    float* sj = sums + (lane & 15);
    const float* tj = t + h * TS + (lane & 15);
    float v[8];
#pragma unroll
    for (int p = 0; p < 8; ++p) v[p] = tj[2 * p * TS];
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      const int mine = __shfl_sync(0xffffffffu, packed, base + 2 * p + h);
      const float v_other = __shfl_xor_sync(0xffffffffu, v[p], 16);
      sj[mine & 0x7fffffff] += mine < 0 ? v[p] + v_other : v[p];
    }
  } else {
#pragma unroll 4
    for (int p = 0; p < 8; ++p) {
      const int l0 = __shfl_sync(0xffffffffu, label, base + 2 * p);
      const int l1 = __shfl_sync(0xffffffffu, label, base + 2 * p + 1);
      const bool same = l0 == l1;
      float* s0 = sums + l0 * DREG + lane;
      float* s1 = sums + (same ? k : l1) * DREG + lane;
      const float* t0 = t + 2 * p * TS + lane;
#pragma unroll
      for (int f = 0; f < DREG / 32; ++f) {
        const float v0 = t0[32 * f];
        const float v1 = t0[TS + 32 * f];
        const float o0 = s0[32 * f];
        const float o1 = s1[32 * f];
        s0[32 * f] = o0 + (same ? v0 + v1 : v0);
        s1[32 * f] = o1 + v1;
      }
    }
  }
}

template <int DREG, int PREC, bool VEC>
__global__ void __launch_bounds__(WarpGeometry<DREG, PREC>::THREADS, 1)
assign_stats_warps(const float* __restrict__ x, const float* __restrict__ centers, long long n,
                   int d, int k, long long rows_per_block, float* __restrict__ ws_sums,
                   int* __restrict__ ws_counts, double* __restrict__ ws_cost) {
  using G = WarpGeometry<DREG, PREC>;
  constexpr int TS = DREG + 4;  // floats between rows of the transpose buffer
  extern __shared__ __align__(16) unsigned char smem[];
  double* red = reinterpret_cast<double*>(smem);              // [warps]
  float* c_hi = reinterpret_cast<float*>(smem + RED_BYTES);   // [k][DREG]
  float* c_lo = PREC == PREC_HIGH ? c_hi + k * DREG : c_hi;   // [k][DREG], "high" only
  float* c2s = c_hi + (PREC == PREC_HIGH ? 2 : 1) * k * DREG;  // [k]
  // Warp w's region: its stage, its sums [k + 1][DREG], its counts [k]
  // and its transpose buffer [16][TS].
  const int sums_at = G::STAGE_FLOATS;
  const int counts_at = sums_at + (k + 1) * DREG;
  const int t_at = counts_at + round4(k);
  const int region = t_at + 16 * TS;
  float* regions = c2s + round4(k);

  const int warps = blockDim.x >> 5;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  float* stage = regions + warp * region;
  float* t = stage + t_at;
  float* sums = stage + sums_at;
  int* cnt = reinterpret_cast<int*>(stage + counts_at);

  // Row layout in the stage: `units` copy units a row at an odd `stride`.
  const int units = VEC ? d / 4 : d;
  const int stride = units | 1;
  const int per_pass = 32 / units;  // 0 for rows of more than 32 units
  const int my_row = units > 32 ? 0 : lane / units;
  const int my_unit = lane - my_row * units;

  // The block's rows [row0, row1) in SUB-row sub-tiles; warp w takes
  // sub-tiles w, w + warps, ...
  const long long row0 = (long long)blockIdx.x * rows_per_block;
  const long long row1 = row0 + rows_per_block < n ? row0 + rows_per_block : n;
  const long long subtiles = row1 > row0 ? (row1 - row0 + G::SUB - 1) / G::SUB : 0;
  const int mine = subtiles > warp ? (int)((subtiles - warp + warps - 1) / warps) : 0;
  auto first_row = [&](int i) -> long long {
    return row0 + (long long)G::SUB * (warp + (long long)i * warps);
  };
  auto rows_of = [&](int i) -> int {
    const long long left = row1 - first_row(i);
    return left < G::SUB ? (int)left : G::SUB;
  };
  auto copy = [&](int i) {
    if (i < mine)
      copy_rows<VEC>(stage, x + first_row(i) * d, rows_of(i), units, stride, per_pass, my_row,
                     my_unit);
    cp_async_commit();
  };

  copy(0);  // this warp's first copy goes out before the centers are staged

  for (int e = tid; e < k * DREG; e += blockDim.x) {
    const int c = e / DREG;
    const int j = e - c * DREG;
    float hi, lo;
    split<PREC>(j < d ? centers[(long long)c * d + j] : 0.0f, hi, lo);
    c_hi[e] = hi;
    if (PREC == PREC_HIGH) c_lo[e] = lo;
  }
  bool centers_in_range = true;
  for (int c = tid; c < k; c += blockDim.x) {
    c2s[c] = center_norm(centers + (long long)c * d, d);
    centers_in_range = centers_in_range && c2s[c] < NORM_LIMIT;
  }
  for (int e = lane; e < (k + 1) * DREG; e += 32) sums[e] = 0.0f;
  for (int c = lane; c < k; c += 32) cnt[c] = 0;
  // The only block barrier before the end.
  centers_in_range = __syncthreads_and(centers_in_range);

  double cost = 0.0;
  for (int i = 0; i < mine; ++i) {
    cp_async_wait_all();  // this lane's copies of sub-tile i have landed
    __syncwarp();         // and every lane's
    const int rows = rows_of(i);

    // Lane l scores rows l, l + 32, ...; rows past the end score stale
    // stage values and are dropped.
    int label[G::ROWS];
    float xh[G::ROWS][DREG], xl[G::ROWS][DREG], x2[G::ROWS], best[G::ROWS];
#pragma unroll
    for (int r = 0; r < G::ROWS; ++r) {
      x2[r] = stage_row<DREG, PREC, VEC>(stage, lane + 32 * r, stride, d, xh[r], xl[r]);
      best[r] = __int_as_float(0x7f800000);  // +inf
      label[r] = 0;  // every score NaN: the reference's argmin gives 0 too
    }
    __syncwarp();  // the stage is read: the next sub-tile's copy overlaps the scores
    copy(i + 1);

    // Every center against the rows. Where no row's ||x||^2 or center's c2
    // reaches NORM_LIMIT, 2 x.c cannot overflow, and c2 - 2 x.c is one FFMA
    // with score()'s bits; otherwise score() itself.
    auto scan = [&](auto fast) {
      auto one = [&](int c, float c2) {
        float xc[G::ROWS];
        center_dots<DREG, PREC, G::ROWS>(xh, xl, c_hi + c * DREG, c_lo + c * DREG, xc);
#pragma unroll
        for (int r = 0; r < G::ROWS; ++r) {
          const float s = decltype(fast)::value ? __fmaf_rn(-2.0f, xc[r], c2) : score(c2, xc[r]);
          if (s < best[r]) {
            best[r] = s;
            label[r] = c;
          }
        }
      };
      int c = 0;  // four centers a step, their c2 in one 128-bit load
#pragma unroll 1
      for (; c + 4 <= k; c += 4) {
        const float4 q2 = *reinterpret_cast<const float4*>(c2s + c);
        one(c, q2.x);
        one(c + 1, q2.y);
        one(c + 2, q2.z);
        one(c + 3, q2.w);
      }
#pragma unroll 1
      for (; c < k; ++c) one(c, c2s[c]);
    };
    bool rows_in_range = true;
#pragma unroll
    for (int r = 0; r < G::ROWS; ++r)
      rows_in_range = rows_in_range && (lane + 32 * r >= rows || x2[r] < NORM_LIMIT);
    if (__all_sync(0xffffffffu, rows_in_range) && centers_in_range)
      scan(std::true_type());
    else
      scan(std::false_type());

#pragma unroll
    for (int r = 0; r < G::ROWS; ++r) {
      const bool valid = lane + 32 * r < rows;
      if (valid) cost += (double)x2[r] + (double)best[r];
      // Counts: the lowest lane of each label in 32 rows adds their number.
      const unsigned peers = __match_any_sync(0xffffffffu, valid ? label[r] : -1);
      if (valid && (peers & ((1u << lane) - 1u)) == 0u) cnt[label[r]] += __popc(peers);
      // Sums: the 32 rows from registers, 16 at a time through the
      // transpose buffer.
#pragma unroll
      for (int base = 0; base < 32; base += 16) {
        if (32 * r + base < rows) {
          if (lane - base >= 0 && lane - base < 16) {
            float4* row4 = reinterpret_cast<float4*>(t + (lane - base) * TS);
#pragma unroll
            for (int q = 0; q < DREG / 4; ++q) {
              const int j = 4 * q;
              row4[q] = PREC == PREC_HIGH
                            ? make_float4(xh[r][j] + xl[r][j], xh[r][j + 1] + xl[r][j + 1],
                                          xh[r][j + 2] + xl[r][j + 2], xh[r][j + 3] + xl[r][j + 3])
                            : make_float4(xh[r][j], xh[r][j + 1], xh[r][j + 2], xh[r][j + 3]);
            }
          }
          __syncwarp();
          add_rows<DREG>(sums, t, valid ? label[r] : k, base, k, lane);
          __syncwarp();
        }
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // The block's partials: warps summed in order.
  float* out = ws_sums + (long long)blockIdx.x * k * d;
  for (int e = tid; e < k * d; e += blockDim.x) {
    float s = 0.0f;
    const int c = e / d;
    for (int w = 0; w < warps; ++w) s += regions[w * region + sums_at + c * DREG + e - c * d];
    out[e] = s;
  }
  for (int c = tid; c < k; c += blockDim.x) {
    int s = 0;
    for (int w = 0; w < warps; ++w) s += reinterpret_cast<const int*>(regions + w * region + counts_at)[c];
    ws_counts[(long long)blockIdx.x * k + c] = s;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) cost += __shfl_down_sync(0xffffffffu, cost, o);
  if (lane == 0) red[warp] = cost;
  __syncthreads();
  if (tid == 0) {
    double total = 0.0;
    for (int w = 0; w < warps; ++w) total += red[w];
    ws_cost[blockIdx.x] = total;
  }
}

template <int DREG, int PREC, bool VEC>
int launch_warps(const float* x, const float* centers, long long n, int d, int k, int warps,
                 int blocks, long long rows_per_block, float* ws_sums, int* ws_counts,
                 double* ws_cost, cudaStream_t stream) {
  auto kernel = assign_stats_warps<DREG, PREC, VEC>;
  const size_t smem = warp_smem(d, k, PREC, warps);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, 32 * warps, smem, stream>>>(x, centers, n, d, k, rows_per_block, ws_sums,
                                               ws_counts, ws_cost);
  return (int)cudaGetLastError();
}

// Resident blocks per SM of a warp-variant instantiation, or minus the
// CUDA error.
template <int DREG, int PREC, bool VEC>
int warps_per_sm(int d, int k, int warps) {
  const void* kernel = (const void*)assign_stats_warps<DREG, PREC, VEC>;
  const size_t smem = warp_smem(d, k, PREC, warps);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int got = 0;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&got, kernel, 32 * warps, smem);
  return err == cudaSuccess ? got : -(int)err;
}

// --- the sort variant -------------------------------------------------------

template <int DREG, int PREC>
__global__ void __launch_bounds__(BLOCK, 1)
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
                  cudaStream_t stream) {
  auto kernel = assign_stats_blocks<DREG, PREC>;
  const size_t smem = smem_bytes(d, k);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, BLOCK, smem, stream>>>(x, centers, n, d, k, rows_per_block, ws_sums,
                                          ws_counts, ws_cost);
  return (int)cudaGetLastError();
}

template <int DREG, int PREC>
int blocks_per_sm(int d, int k) {
  const void* kernel = (const void*)assign_stats_blocks<DREG, PREC>;
  const size_t smem = smem_bytes(d, k);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int got = 0;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&got, kernel, BLOCK, smem);
  return err == cudaSuccess ? got : -(int)err;
}

// --- dispatch ---------------------------------------------------------------

// The launch, or the occupancy query, of the variant for (d, k, PREC).
// The warp variant's two copy routes share one block plan: the query
// returns the fewer of their resident blocks.
template <int PREC>
struct Dispatch {
  template <int DREG>
  static int warp_launch(bool vec, const float* x, const float* centers, long long n, int d, int k,
                         int warps, int blocks, long long rpb, float* ws_sums, int* ws_counts,
                         double* ws_cost, cudaStream_t st) {
    if (vec) return launch_warps<DREG, PREC, true>(x, centers, n, d, k, warps, blocks, rpb, ws_sums, ws_counts, ws_cost, st);
    return launch_warps<DREG, PREC, false>(x, centers, n, d, k, warps, blocks, rpb, ws_sums, ws_counts, ws_cost, st);
  }

  static int launch(const float* x, const float* centers, long long n, int d, int k, int blocks,
                    long long rpb, float* ws_sums, int* ws_counts, double* ws_cost,
                    cudaStream_t st) {
    const int warps = warp_count(d, k, PREC);
    if (warps > 0) {
      // 16-byte copies need every row 16-byte aligned: d % 4 == 0 and x aligned.
      const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
      switch (register_width(d)) {
        case 16: return warp_launch<16>(vec, x, centers, n, d, k, warps, blocks, rpb, ws_sums, ws_counts, ws_cost, st);
        case 32: return warp_launch<32>(vec, x, centers, n, d, k, warps, blocks, rpb, ws_sums, ws_counts, ws_cost, st);
        default: return warp_launch<64>(vec, x, centers, n, d, k, warps, blocks, rpb, ws_sums, ws_counts, ws_cost, st);
      }
    }
    switch (register_width(d)) {
      case 16: return launch_blocks<16, PREC>(x, centers, n, d, k, blocks, rpb, ws_sums, ws_counts, ws_cost, st);
      case 32: return launch_blocks<32, PREC>(x, centers, n, d, k, blocks, rpb, ws_sums, ws_counts, ws_cost, st);
      case 64: return launch_blocks<64, PREC>(x, centers, n, d, k, blocks, rpb, ws_sums, ws_counts, ws_cost, st);
      default: return launch_blocks<0, PREC>(x, centers, n, d, k, blocks, rpb, ws_sums, ws_counts, ws_cost, st);
    }
  }

  template <int DREG>
  static int warp_occupancy(int d, int k, int warps) {
    const int vec = warps_per_sm<DREG, PREC, true>(d, k, warps);
    const int scalar = warps_per_sm<DREG, PREC, false>(d, k, warps);
    return vec < scalar ? vec : scalar;  // an error (negative) wins too
  }

  static int occupancy(int d, int k) {
    const int warps = warp_count(d, k, PREC);
    if (warps > 0) {
      switch (register_width(d)) {
        case 16: return warp_occupancy<16>(d, k, warps);
        case 32: return warp_occupancy<32>(d, k, warps);
        default: return warp_occupancy<64>(d, k, warps);
      }
    }
    switch (register_width(d)) {
      case 16: return blocks_per_sm<16, PREC>(d, k);
      case 32: return blocks_per_sm<32, PREC>(d, k);
      case 64: return blocks_per_sm<64, PREC>(d, k);
      default: return blocks_per_sm<0, PREC>(d, k);
    }
  }
};

bool valid_prec(int prec) {
  return prec == PREC_HIGHEST || prec == PREC_HIGH || prec == PREC_DEFAULT;
}

}  // namespace

extern "C" long long kmeans_assign_stats_smem_bytes(int d, int k) {
  return (long long)smem_bytes(d, k);
}

// Warps of a warp-variant block at (d, k, prec); 0 when the sort variant
// runs; -1 for an unknown mode.
extern "C" int kmeans_assign_stats_warps(int d, int k, int prec) {
  if (!valid_prec(prec)) return -1;
  return d < 1 || k < 1 ? 0 : warp_count(d, k, prec);
}

// Resident blocks per SM on the current device of the variant that runs
// at (d, k, prec), or minus the CUDA error.
extern "C" int kmeans_assign_stats_blocks_per_sm(int d, int k, int prec) {
  if (d < 1 || k < 1 || smem_bytes(d, k) > MAX_SMEM) return -(int)cudaErrorInvalidValue;
  if (prec == PREC_HIGHEST) return Dispatch<PREC_HIGHEST>::occupancy(d, k);
  if (prec == PREC_HIGH) return Dispatch<PREC_HIGH>::occupancy(d, k);
  if (prec == PREC_DEFAULT) return Dispatch<PREC_DEFAULT>::occupancy(d, k);
  return -(int)cudaErrorInvalidValue;
}

extern "C" int kmeans_assign_stats(const float* x, const float* centers, long long n, int d,
                                   int k, int prec, int blocks, long long rows_per_block,
                                   float* ws_sums, int* ws_counts, double* ws_cost, float* sums,
                                   long long* counts, float* cost, float* c2, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (smem_bytes(d, k) > MAX_SMEM || d < 1 || k < 1 || blocks < 1) return (int)cudaErrorInvalidValue;
  int err;
  if (prec == PREC_HIGHEST)
    err = Dispatch<PREC_HIGHEST>::launch(x, centers, n, d, k, blocks, rows_per_block, ws_sums, ws_counts, ws_cost, stream);
  else if (prec == PREC_HIGH)
    err = Dispatch<PREC_HIGH>::launch(x, centers, n, d, k, blocks, rows_per_block, ws_sums, ws_counts, ws_cost, stream);
  else if (prec == PREC_DEFAULT)
    err = Dispatch<PREC_DEFAULT>::launch(x, centers, n, d, k, blocks, rows_per_block, ws_sums, ws_counts, ws_cost, stream);
  else
    return (int)cudaErrorInvalidValue;
  if (err != 0) return err;
  return kmeans::launch_reduce(ws_sums, ws_counts, ws_cost, centers, blocks, k, d, sums, counts, cost,
                               c2, stream);
}
