// Centered Gram kernel K1: C = (x - mean)^T (x - mean) for a row-major
// x (n, d), in the input type (float or double), on Hopper (sm_90a).
//
// Replaces the TPU kernel spark_rapids_ml_tpu/ops/pallas/covariance.py
// (centered_gram_pallas, body _cov_kernel). The TPU kernel keeps the whole
// (d, d) accumulator in VMEM and walks the rows in one sequential grid; at
// d = 1024 that accumulator is 4 MB, which no Hopper block can hold, and
// Hopper blocks run in no fixed order. So this kernel tiles the OUTPUT:
//
//   gram_tiles_*   one block per (upper-triangular 128x128 output tile,
//                  row chunk). The block walks its rows BK at a time through
//                  shared memory, the column means subtracted before any
//                  product (ragged rows and columns load as 0, so no
//                  padding of x is needed), and writes its partial tile to
//                  workspace[chunk].
//   reduce_mirror  sums the chunk partials of every element in a fixed
//                  order (chunk 0 first) and mirrors the upper triangle
//                  into the lower one. No atomics: the result is
//                  deterministic run to run and exactly symmetric.
//
// Bound: n * d * (d + 1) flops (the symmetric half, two per FMA) against
// n * d reads of x, so at the main path's d = 1024 it is bound by
// operations, not bytes: fp32 outside the tensor cores (the port's "f32" is
// IEEE fp32, TF32 off), and fp64 at the fp64 tensor-core (DMMA) rate.
//
// float: the classic SIMT SGEMM design. 256 threads, each with an 8x8
//   register tile split into two 4-wide strips 64 apart in rows and in
//   columns, so that each 16-byte shared-memory read is conflict-free and a
//   row step costs 4 such reads for 64 IEEE FMAs. The rows arrive by
//   cp.async in a ring of three buffers: while the block multiplies step
//   s, step s + 2 is in flight and each thread centres the values of step
//   s + 1 it copied, in shared memory: one __syncthreads() a step, and no
//   registers held for the copy, which keeps the 64 accumulators within
//   the 128 registers of two blocks an SM without spills. Centering stays
//   before the product: X^T X - n mu mu^T would cancel catastrophically.
// double: the fp64 tensor cores through Hopper's m16n8k4 fp64 mma.sync
//   (sm_90; nvcuda::wmma's double fragments are Ampere's m8n8k4 shape,
//   the slower of the two in this kernel): 16 warps, each owning a 32x32 patch
//   of the tile as 2x4 products of 16x8. fp64 MMA rounds like fp64 FMAs.
//   Each step's rows are loaded 16 bytes a thread into registers during
//   the previous step's products, centred there with the means from shared
//   memory, and stored to the second of two buffers. A tile T wide
//   does T/8 flops per byte of double panel it reads through L2, so the
//   fp64 peak (67 TFLOP/s) needs 8.4 TB/s of L2 reads at T = 64 and 4.2 at
//   T = 128: hence 128, like the float tile (T/4 flops a byte there).
//
// Each type has a vector variant (16-byte loads and stores) and a scalar
// one, compiled from the same template and chosen at launch: the scalar
// variant takes widths that are not a multiple of the vector and rows that
// are not 16-byte aligned. It is a code path of the kernel, not a fallback.
//
// C interface (bound with ctypes): centered_gram_f32 / centered_gram_f64
// launch both kernels on `stream` and return cudaGetLastError();
// centered_gram_blocks_per_sm gives the tile kernel's resident blocks per
// SM, which the wrapper's split plan fills in whole waves.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int F32_TILE = 128;                 // output tile edge, float
constexpr int F32_BK = 16;                    // rows per shared-memory step, float
constexpr int F32_THREADS = 256;              // 16 x 16 threads, 8x8 accumulators each
constexpr int F32_HALF = F32_TILE / 2;        // the two strips of a thread lie this far apart
constexpr int F32_VEC = 4;                    // floats per 16-byte load
constexpr int F32_STAGES = 3;                 // shared-memory buffers: multiply, centre, copy
constexpr int F32_LOADS = F32_BK * F32_TILE / F32_VEC / F32_THREADS;  // 16-byte loads per panel and thread

constexpr int F64_TILE = 128;                 // output tile edge, double
constexpr int F64_BK = 8;                     // rows per shared-memory step, double
constexpr int F64_WARP_TILE = 32;             // each warp's patch: 2 x 4 products of 16 x 8
constexpr int F64_MFRAGS = F64_WARP_TILE / 16;
constexpr int F64_NFRAGS = F64_WARP_TILE / 8;
constexpr int F64_WARPS_SIDE = F64_TILE / F64_WARP_TILE;
constexpr int F64_THREADS = 32 * F64_WARPS_SIDE * F64_WARPS_SIDE;
constexpr int F64_LD = F64_TILE + 4;          // shared row pitch in doubles
constexpr int F64_VEC = 2;                    // doubles per 16-byte load
constexpr int F64_LOADS = F64_BK * F64_TILE / F64_VEC / F64_THREADS;

static_assert(F32_LOADS >= 1 && F32_LOADS * F32_VEC * F32_THREADS == F32_BK * F32_TILE, "f32 loader");
static_assert(F32_TILE == 16 * 2 * 4, "f32: 16 threads x 2 strips x 4 per side");
static_assert(F64_LOADS >= 1 && F64_LOADS * F64_VEC * F64_THREADS == F64_BK * F64_TILE, "f64 loader");
static_assert(F64_BK % 4 == 0, "f64 steps hold whole k = 4 products");
static_assert(F64_THREADS >= 2 * F64_TILE && F32_THREADS >= 2 * F32_TILE, "one thread per mean");

// blockIdx.x enumerates the upper-triangular tile pairs (ti <= tj) row by
// row; row ti of the triangle holds tiles - ti pairs.
__device__ __forceinline__ void tile_pair(int p, int tiles, int& ti, int& tj) {
  ti = 0;
  while (p >= tiles - ti) {
    p -= tiles - ti;
    ++ti;
  }
  tj = ti + p;
}

// ---------------------------------------------------------------- float

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Copies BYTES (16 or 4) from global to shared memory without passing
// through registers; when !valid it writes zeros and reads nothing.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool valid) {
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
                 "r"(valid ? 16 : 0));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
                 "r"(valid ? 4 : 0));
  }
}

template <bool VEC>
__global__ void __launch_bounds__(F32_THREADS, 2)
gram_tiles_f32(const float* __restrict__ x, const float* __restrict__ mean, float* __restrict__ ws,
               int64_t n, int64_t d, int tiles, int64_t rows_per_split) {
  int ti, tj;
  tile_pair(blockIdx.x, tiles, ti, tj);
  const int64_t split = blockIdx.y;
  const int64_t row0 = split * rows_per_split;
  const int64_t row1 = row0 + rows_per_split < n ? row0 + rows_per_split : n;
  const int steps = row1 > row0 ? (int)((row1 - row0 + F32_BK - 1) / F32_BK) : 0;

  __shared__ __align__(16) float as[F32_STAGES][F32_BK][F32_TILE];
  __shared__ __align__(16) float bs[F32_STAGES][F32_BK][F32_TILE];

  // Loader: 32 threads cover one row of a panel, 4 columns each, walking
  // the chunk with one row pointer. cp.async lands the raw values in
  // shared memory; the thread that copied them centres them there, with
  // its 4 + 4 column means, a step before they are multiplied.
  const int tid = threadIdx.x;
  constexpr int ROWS_PER_PASS = F32_THREADS * F32_VEC / F32_TILE;
  const int lr = tid / (F32_TILE / F32_VEC);
  const int lc = (tid % (F32_TILE / F32_VEC)) * F32_VEC;
  const float* px = x + (row0 + lr) * d + (int64_t)ti * F32_TILE + lc;  // panel a; b lies db further
  const int64_t db = (int64_t)(tj - ti) * F32_TILE;
  const int rows = (int)(row1 - row0);
  const int64_t na = d - ((int64_t)ti * F32_TILE + lc);                  // columns left in panel a, b
  const int64_t nb = d - ((int64_t)tj * F32_TILE + lc);
  float4 ma, mb;
  ma.x = na > 0 ? mean[d - na] : 0.f;
  ma.y = na > 1 ? mean[d - na + 1] : 0.f;
  ma.z = na > 2 ? mean[d - na + 2] : 0.f;
  ma.w = na > 3 ? mean[d - na + 3] : 0.f;
  mb.x = nb > 0 ? mean[d - nb] : 0.f;
  mb.y = nb > 1 ? mean[d - nb + 1] : 0.f;
  mb.z = nb > 2 ? mean[d - nb + 2] : 0.f;
  mb.w = nb > 3 ? mean[d - nb + 3] : 0.f;

  // Step s's rows into stage s % F32_STAGES; ragged rows and columns land
  // as zeros. Always commits a group, empty past the last step.
  auto copy = [&](int step) {
    if (step < steps) {
      const int buf = step % F32_STAGES;
#pragma unroll
      for (int l = 0; l < F32_LOADS; ++l) {
        const int rr = lr + l * ROWS_PER_PASS;
        const bool ok = step * F32_BK + rr < rows;
        const float* p = ok ? px + ((int64_t)step * F32_BK + l * ROWS_PER_PASS) * d : x;
        if (VEC) {
          // d % 4 == 0, so a 4-column group lies wholly inside or outside.
          cp_async<16>(&as[buf][rr][lc], p, ok && na > 0);
          cp_async<16>(&bs[buf][rr][lc], ok ? p + db : x, ok && nb > 0);
        } else {
#pragma unroll
          for (int j = 0; j < F32_VEC; ++j) {
            cp_async<4>(&as[buf][rr][lc + j], ok ? p + j : x, ok && na > j);
            cp_async<4>(&bs[buf][rr][lc + j], ok ? p + db + j : x, ok && nb > j);
          }
        }
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  // Centres the thread's own values of a landed step; rows past the chunk
  // stay 0 (out-of-range columns hold x = mean = 0).
  auto centre = [&](int step) {
    if (step >= steps) return;
    const int buf = step % F32_STAGES;
#pragma unroll
    for (int l = 0; l < F32_LOADS; ++l) {
      const int rr = lr + l * ROWS_PER_PASS;
      if (step * F32_BK + rr < rows) {
        float4* va = reinterpret_cast<float4*>(&as[buf][rr][lc]);
        float4* vb = reinterpret_cast<float4*>(&bs[buf][rr][lc]);
        const float4 a = *va, b = *vb;
        *va = make_float4(a.x - ma.x, a.y - ma.y, a.z - ma.z, a.w - ma.w);
        *vb = make_float4(b.x - mb.x, b.y - mb.y, b.z - mb.z, b.w - mb.w);
      }
    }
  };

  // Thread (tx, ty) owns rows ty*4 + {0..3} and + 64, columns tx*4 + {0..3}
  // and + 64, of the output tile. A warp is 4 ty by 8 tx, so each of its
  // 16-byte shared reads pulls 64 (a) or 128 (b) contiguous bytes.
  const int ty = (tid / 64) * 4 + (tid % 32) / 8;
  const int tx = ((tid / 32) % 2) * 8 + tid % 8;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  auto product = [&](int buf, int k) {
    const float4 a0 = *reinterpret_cast<const float4*>(&as[buf][k][ty * 4]);
    const float4 a1 = *reinterpret_cast<const float4*>(&as[buf][k][ty * 4 + F32_HALF]);
    const float4 b0 = *reinterpret_cast<const float4*>(&bs[buf][k][tx * 4]);
    const float4 b1 = *reinterpret_cast<const float4*>(&bs[buf][k][tx * 4 + F32_HALF]);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = __fmaf_rn(a[i], b[j], acc[i][j]);
  };

  // Stage s is centred before the barrier that opens step s; step s + 2's
  // copy reuses the stage of step s - 1, which that barrier also closed.
  copy(0);
  copy(1);
  asm volatile("cp.async.wait_group 1;\n" ::);
  centre(0);
  __syncthreads();
  for (int s = 0; s < steps; ++s) {
    const int buf = s % F32_STAGES;
    asm volatile("cp.async.wait_group 0;\n" ::);  // step s + 1 has landed
    copy(s + 2);
#pragma unroll
    for (int k = 0; k < F32_BK / 2; ++k) product(buf, k);
    centre(s + 1);
#pragma unroll
    for (int k = F32_BK / 2; k < F32_BK; ++k) product(buf, k);
    __syncthreads();
  }

  float* out = ws + split * d * d;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t r = (int64_t)ti * F32_TILE + ty * 4 + (i / 4) * F32_HALF + (i % 4);
    if (r >= d) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t c = (int64_t)tj * F32_TILE + tx * 4 + h * F32_HALF;
      if (VEC) {
        if (c < d)
          *reinterpret_cast<float4*>(out + r * d + c) =
              make_float4(acc[i][h * 4], acc[i][h * 4 + 1], acc[i][h * 4 + 2], acc[i][h * 4 + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c + j < d) out[r * d + c + j] = acc[i][h * 4 + j];
      }
    }
  }
}

// --------------------------------------------------------------- double

// One m16n8k4 fp64 tensor-core product, C += A B, on one warp (sm_90).
// Fragments (PTX ISA, mma .f64; g = lane / 4, t = lane % 4): a[i] holds
// A(g + 8 i, t); b holds B(t, g); c[i] holds C(g + 8 (i / 2), 2 t + i % 2).
__device__ __forceinline__ void mma_f64(double c[4], const double a[2], double b) {
  asm volatile("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
               "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
               : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
               : "d"(a[0]), "d"(a[1]), "d"(b));
}

template <bool VEC>
__global__ void __launch_bounds__(F64_THREADS)
gram_tiles_f64(const double* __restrict__ x, const double* __restrict__ mean, double* __restrict__ ws,
               int64_t n, int64_t d, int tiles, int64_t rows_per_split) {
  int ti, tj;
  tile_pair(blockIdx.x, tiles, ti, tj);
  const int64_t split = blockIdx.y;
  const int64_t row0 = split * rows_per_split;
  const int64_t row1 = row0 + rows_per_split < n ? row0 + rows_per_split : n;
  const int steps = row1 > row0 ? (int)((row1 - row0 + F64_BK - 1) / F64_BK) : 0;

  // Panels stored k-major (one row of x per shared row): A(m, k) = as[k][m]
  // and B(k, n) = bs[k][n]. The pitch F64_LD = 4 mod 16 doubles puts the
  // 16 lanes of a half-warp's fragment load (4 rows t by 4 columns g) on
  // distinct banks.
  __shared__ __align__(16) double as[2][F64_BK][F64_LD];
  __shared__ __align__(16) double bs[2][F64_BK][F64_LD];
  __shared__ __align__(16) double ms[2][F64_TILE];

  const int tid = threadIdx.x;
  if (tid < 2 * F64_TILE) {
    const int64_t c = (int64_t)(tid < F64_TILE ? ti : tj) * F64_TILE + tid % F64_TILE;
    ms[tid / F64_TILE][tid % F64_TILE] = c < d ? mean[c] : 0.0;
  }
  constexpr int ROWS_PER_PASS = F64_THREADS * F64_VEC / F64_TILE;
  const int lr = tid / (F64_TILE / F64_VEC);
  const int lc = (tid % (F64_TILE / F64_VEC)) * F64_VEC;
  const double* px = x + (row0 + lr) * d + (int64_t)ti * F64_TILE + lc;
  const int64_t db = (int64_t)(tj - ti) * F64_TILE;
  const int64_t stride = F64_BK * d;
  int64_t rem = row1 - row0 - lr;
  const int64_t na = d - ((int64_t)ti * F64_TILE + lc);
  const int64_t nb = d - ((int64_t)tj * F64_TILE + lc);
  double2 ra[F64_LOADS], rb[F64_LOADS];
  bool ok[F64_LOADS];

  auto load = [&]() {
#pragma unroll
    for (int l = 0; l < F64_LOADS; ++l) {
      const double* p = px + (int64_t)l * ROWS_PER_PASS * d;
      ok[l] = rem > l * ROWS_PER_PASS;
      const double2 zero = make_double2(0.0, 0.0);
      if (VEC) {
        ra[l] = ok[l] && na > 0 ? __ldg(reinterpret_cast<const double2*>(p)) : zero;
        rb[l] = ok[l] && nb > 0 ? __ldg(reinterpret_cast<const double2*>(p + db)) : zero;
      } else {
        ra[l].x = ok[l] && na > 0 ? __ldg(p) : 0.0;
        ra[l].y = ok[l] && na > 1 ? __ldg(p + 1) : 0.0;
        rb[l].x = ok[l] && nb > 0 ? __ldg(p + db) : 0.0;
        rb[l].y = ok[l] && nb > 1 ? __ldg(p + db + 1) : 0.0;
      }
    }
    px += stride;
    rem -= F64_BK;
  };
  auto store = [&](int buf) {
    const double2 mua = *reinterpret_cast<const double2*>(&ms[0][lc]);
    const double2 mub = *reinterpret_cast<const double2*>(&ms[1][lc]);
#pragma unroll
    for (int l = 0; l < F64_LOADS; ++l) {
      const int rr = lr + l * ROWS_PER_PASS;
      const double2 zero = make_double2(0.0, 0.0);
      *reinterpret_cast<double2*>(&as[buf][rr][lc]) =
          ok[l] ? make_double2(ra[l].x - mua.x, ra[l].y - mua.y) : zero;
      *reinterpret_cast<double2*>(&bs[buf][rr][lc]) =
          ok[l] ? make_double2(rb[l].x - mub.x, rb[l].y - mub.y) : zero;
    }
  };

  const int warp = tid / 32;
  const int g = (tid % 32) / 4;
  const int t = tid % 4;
  const int wm = (warp / F64_WARPS_SIDE) * F64_WARP_TILE;  // the warp's patch, in tile coordinates
  const int wn = (warp % F64_WARPS_SIDE) * F64_WARP_TILE;
  double acc[F64_MFRAGS][F64_NFRAGS][4];
#pragma unroll
  for (int i = 0; i < F64_MFRAGS; ++i)
#pragma unroll
    for (int j = 0; j < F64_NFRAGS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0;

  if (steps > 0) load();
  __syncthreads();  // the means
  if (steps > 0) store(0);
  __syncthreads();
  for (int s = 0; s < steps; ++s) {
    const int buf = s & 1;
    const bool more = s + 1 < steps;
    if (more) load();
#pragma unroll
    for (int k = 0; k < F64_BK; k += 4) {
      double a[F64_MFRAGS][2];
      double b[F64_NFRAGS];
#pragma unroll
      for (int i = 0; i < F64_MFRAGS; ++i) {
        a[i][0] = as[buf][k + t][wm + 16 * i + g];
        a[i][1] = as[buf][k + t][wm + 16 * i + g + 8];
      }
#pragma unroll
      for (int j = 0; j < F64_NFRAGS; ++j) b[j] = bs[buf][k + t][wn + 8 * j + g];
#pragma unroll
      for (int i = 0; i < F64_MFRAGS; ++i)
#pragma unroll
        for (int j = 0; j < F64_NFRAGS; ++j) mma_f64(acc[i][j], a[i], b[j]);
    }
    if (more) store(buf ^ 1);
    __syncthreads();
  }

  double* out = ws + split * d * d;
#pragma unroll
  for (int i = 0; i < F64_MFRAGS; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t r = (int64_t)ti * F64_TILE + wm + 16 * i + g + 8 * h;
      if (r >= d) continue;
#pragma unroll
      for (int j = 0; j < F64_NFRAGS; ++j) {
        const int64_t c = (int64_t)tj * F64_TILE + wn + 8 * j + 2 * t;
        if (VEC) {
          if (c < d) *reinterpret_cast<double2*>(out + r * d + c) = make_double2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        } else {
          if (c < d) out[r * d + c] = acc[i][j][2 * h];
          if (c + 1 < d) out[r * d + c + 1] = acc[i][j][2 * h + 1];
        }
      }
    }
  }
}

// ---------------------------------------------------------------- both

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
int reduce(const T* ws, T* out, long long d, int splits, cudaStream_t stream) {
  const long long total = d * d;
  long long rblocks = (total + 255) / 256;
  if (rblocks > 4096) rblocks = 4096;
  reduce_mirror<T><<<(unsigned)rblocks, 256, 0, stream>>>(ws, out, d, splits);
  return (int)cudaGetLastError();
}

dim3 tile_grid(long long d, int tile, int splits, int* tiles) {
  *tiles = (int)((d + tile - 1) / tile);
  const long long pairs = (long long)*tiles * (*tiles + 1) / 2;
  return dim3((unsigned)pairs, (unsigned)splits);
}

}  // namespace

extern "C" int centered_gram_f32(const float* x, const float* mean, float* ws, float* out,
                                 long long n, long long d, int splits,
                                 long long rows_per_split, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  int tiles;
  const dim3 grid = tile_grid(d, F32_TILE, splits, &tiles);
  const bool vec = d % F32_VEC == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (vec)
    gram_tiles_f32<true><<<grid, F32_THREADS, 0, stream>>>(x, mean, ws, n, d, tiles, rows_per_split);
  else
    gram_tiles_f32<false><<<grid, F32_THREADS, 0, stream>>>(x, mean, ws, n, d, tiles, rows_per_split);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return reduce<float>(ws, out, d, splits, stream);
}

extern "C" int centered_gram_f64(const double* x, const double* mean, double* ws, double* out,
                                 long long n, long long d, int splits,
                                 long long rows_per_split, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  int tiles;
  const dim3 grid = tile_grid(d, F64_TILE, splits, &tiles);
  const bool vec = d % F64_VEC == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (vec)
    gram_tiles_f64<true><<<grid, F64_THREADS, 0, stream>>>(x, mean, ws, n, d, tiles, rows_per_split);
  else
    gram_tiles_f64<false><<<grid, F64_THREADS, 0, stream>>>(x, mean, ws, n, d, tiles, rows_per_split);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return reduce<double>(ws, out, d, splits, stream);
}

// Resident tile-kernel blocks per SM on the current device (the fewer of
// the two variants'), or minus the CUDA error.
extern "C" int centered_gram_blocks_per_sm(int f64) {
  int vec = 0, scalar = 0;
  cudaError_t err;
  if (f64) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&vec, gram_tiles_f64<true>, F64_THREADS, 0);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&scalar, gram_tiles_f64<false>, F64_THREADS, 0);
  } else {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&vec, gram_tiles_f32<true>, F32_THREADS, 0);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&scalar, gram_tiles_f32<false>, F32_THREADS, 0);
  }
  if (err != cudaSuccess) return -(int)err;
  return vec < scalar ? vec : scalar;
}
