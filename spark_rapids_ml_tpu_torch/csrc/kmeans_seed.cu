// Greedy k-means++ seeding, kernel K5, on Hopper (sm_90a): each step of
// the seeding in two launches, with the chosen index kept on the device.
//
// Replaces no TPU kernel: the JAX package seeds with plain jnp
// (spark_rapids_ml_tpu/ops/kmeans.py, kmeans_plusplus_init), and the
// port's plain version is the torch loop of ops/kmeans.py
// (kmeans_plusplus_loop), which the CPU runs and the tests hold K5
// against. Over row-major float32 x (n, d), the row weights w, the
// running squared distance md of each row to the centres chosen so far,
// and one vector u of n torch uniforms a step (drawn by the caller, in
// the loop's order), step i >= 1 is:
//   seed_select (K5a, one pass over the rows): md = min(md, D2(x, c[i-1]))
//       (md = D2(x, c[0]) at i = 1); the Gumbel score
//       log(w.md) - log(-log(max(u, FLT_MIN))), -inf where w = 0 or
//       md = 0; the t best scores (ties to the lower row). A slot left
//       at -inf takes the first centre's row (every slot when no score
//       is finite: all-duplicate rows). Step 0 draws the first centre,
//       the best of -log(-log u) over the rows of nonzero weight (row 0
//       when there is none).
//   seed_potentials (K5b, one pass over x): for each candidate j the
//       potential sum over rows of w.min(md, D2(x, cand_j)) in float64,
//       then the argmin (lowest slot on ties, as torch.argmin), whose row
//       becomes c[i].
// D2 is the sum over features of (x - c)^2 in fp32 FMAs, features in
// order (IEEE fp32, no TF32): both kernels run the same chain, so the md
// K5a keeps is the min K5b scored.
//
// Bound, at the main path's 20M x 16, k = 100 (t = 9): bytes. A step needs
// each row's x, w and u read and its md read and written once: 80 bytes
// a row, 1.6 GB, 0.48 ms at 3.35 TB/s. The 2.n.d.t operations of the
// candidates' D2 (5.8 GFLOP, FMAs on the CUDA cores) take 0.09 ms at 67
// TFLOP/s. This design moves more: K5b reads x, md and w and, where the
// caller passes d2s (it does when t + 1 < d, as here), writes each row's
// D2 to the t candidates; K5a then reads the chosen one's D2 (else it
// reads x again), md, w and u and writes md: 128 bytes a row a step (152
// without d2s), 2.56 GB, 0.76 ms. It spends nothing to save operations
// and everything to move each byte once a pass: a thread a
// row, the row in registers (16-byte loads where d % 4 == 0 and x is
// 16-byte aligned), the candidates in shared memory. Each block walks row
// tiles (block, block + grid, ...) and keeps per warp a top-t list, one
// entry a lane (a ballot finds the rows that beat the t-th entry, each
// enters by a shift across the lanes), or t float64 potentials a thread.
// The blocks' partials go to a small workspace; the last block to arrive
// (an integer arrival count, no float atomics) merges them in a fixed
// order, writes the step's candidates or centre, and resets the count.
// The result is a function of the partials' set (top-t) or of a fixed
// summation order (potentials), so every run gives the same bits, with
// or without d2s.
//
// C interface (ctypes): kmeans_seed_select and kmeans_seed_potentials
// launch one step's kernel on `stream` and return cudaGetLastError();
// kmeans_seed_blocks_per_sm is the resident blocks per SM of a kernel
// at (d, t).

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int D_MAX = 64;  // widest row a thread holds in registers
constexpr int T_MAX = 32;  // most candidates: one a lane of a warp
constexpr unsigned FULL = 0xffffffffu;
constexpr long long NO_ROW = 0x7fffffffffffffffLL;

// Device state of one seeding: the arrival count of the blocks of the
// running launch (the last block resets it to 0) and the slot K5b chose.
struct Control {
  unsigned arrivals;
  int best;
};

// (v, i) ranks above (hv, hi): the larger score, the lower row on ties.
__device__ __forceinline__ bool beats(float v, long long i, float hv, long long hi) {
  return v > hv || (v == hv && i < hi);
}

// A warp's t best (score, row), one entry a lane (lanes < t), best first;
// (-inf, NO_ROW) in a slot not filled yet. Every lane of the warp calls.
struct TopT {
  float v;
  long long i;
  float thr_v;  // the t-th entry, which a newcomer has to beat
  long long thr_i;

  __device__ __forceinline__ void reset() {
    v = thr_v = -INFINITY;
    i = thr_i = NO_ROW;
  }

  __device__ __forceinline__ void insert(float nv, long long ni, int lane, int t) {
    const unsigned beaten = __ballot_sync(FULL, lane < t && beats(nv, ni, v, i));
    if (beaten == 0) return;
    const int pos = __ffs(beaten) - 1;  // the list is sorted: lanes pos.. t-1 are beaten
    const float up_v = __shfl_up_sync(FULL, v, 1);
    const long long up_i = __shfl_up_sync(FULL, i, 1);
    if (lane > pos) {
      v = up_v;
      i = up_i;
    }
    if (lane == pos) {
      v = nv;
      i = ni;
    }
    thr_v = __shfl_sync(FULL, v, t - 1);
    thr_i = __shfl_sync(FULL, i, t - 1);
  }

  // Offers each lane's (sv, si), in lane order; a -inf score never enters.
  __device__ __forceinline__ void offer(float sv, long long si, int lane, int t) {
    unsigned want = __ballot_sync(FULL, sv > -INFINITY && beats(sv, si, thr_v, thr_i));
    while (want) {
      const int src = __ffs(want) - 1;
      want &= want - 1;
      insert(__shfl_sync(FULL, sv, src), __shfl_sync(FULL, si, src), lane, t);
    }
  }
};

// Row r of x into registers, zero past d.
template <int DREG>
__device__ __forceinline__ void load_row(const float* __restrict__ x, long long r, int d, bool vec,
                                         float (&xr)[DREG]) {
  const float* row = x + r * d;
  if (vec) {
    const float4* row4 = reinterpret_cast<const float4*>(row);
#pragma unroll
    for (int q = 0; q < DREG / 4; ++q) {
      const float4 v = 4 * q < d ? __ldg(row4 + q) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      xr[4 * q + 0] = v.x;
      xr[4 * q + 1] = v.y;
      xr[4 * q + 2] = v.z;
      xr[4 * q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < DREG; ++j) xr[j] = j < d ? __ldg(row + j) : 0.0f;
  }
}

// D2 of a row in registers to a centre in shared memory (DREG floats,
// zero past d, so the padding adds exact zeros), features in order.
template <int DREG>
__device__ __forceinline__ float dist2(const float (&xr)[DREG], const float* __restrict__ c) {
  float acc = 0.0f;
#pragma unroll
  for (int j = 0; j < DREG; ++j) {
    const float diff = xr[j] - c[j];
    acc = __fmaf_rn(diff, diff, acc);
  }
  return acc;
}

// Standard Gumbel noise from a uniform, as the torch loop computes it.
__device__ __forceinline__ float gumbel(float u) { return -logf(-logf(fmaxf(u, FLT_MIN))); }

// True in every thread of the block that arrives last; the caller's
// partials are written and fenced before.
__device__ __forceinline__ bool arrive_last(Control* ctl, bool* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) *flag = atomicAdd(&ctl->arrivals, 1u) == gridDim.x - 1;
  __syncthreads();
  if (*flag) __threadfence();
  return *flag;
}

// Warp 0 merges the block's warp lists (staged in lv/li) into its own.
__device__ __forceinline__ void merge_warps(TopT& top, float (*lv)[32], long long (*li)[32], int lane,
                                           int t) {
  for (int w = 1; w < WARPS; ++w)
    top.offer(lane < t ? lv[w][lane] : -INFINITY, li[w][lane], lane, t);
}

// K5a: one step's md update, scores and top t. Step 0 draws the first
// centre into centers[0] and rows[0]; step i >= 1 updates md against
// centers[i - 1] (or takes stored D2s at d2s[best], where given, from
// step 2) and writes the t candidates' rows to cand_idx and cand_rows.
template <int DREG>
__global__ void __launch_bounds__(THREADS)
seed_select(const float* __restrict__ x, const float* __restrict__ w, const float* __restrict__ u,
            float* __restrict__ md, const float* __restrict__ d2s, long long n, int d, int t,
            int step, bool vec, float* __restrict__ centers, long long* __restrict__ rows,
            float* __restrict__ cand_rows, long long* __restrict__ cand_idx,
            float* __restrict__ part_v, long long* __restrict__ part_i, Control* __restrict__ ctl) {
  __shared__ __align__(16) float c[DREG];
  __shared__ float lv[WARPS][32];
  __shared__ long long li[WARPS][32];
  __shared__ bool last;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (step > 0 && threadIdx.x < DREG)
    c[threadIdx.x] = (int)threadIdx.x < d ? centers[(long long)(step - 1) * d + threadIdx.x] : 0.0f;
  __syncthreads();
  const float* d2best = d2s != nullptr && step >= 2 ? d2s + (long long)ctl->best * n : nullptr;

  TopT top;
  top.reset();
  const long long tiles = (n + THREADS - 1) / THREADS;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long r = tile * THREADS + threadIdx.x;
    float s = -INFINITY;
    if (r < n) {
      const float wr = __ldg(w + r);
      const float ur = __ldg(u + r);
      if (step == 0) {
        s = wr > 0.0f ? gumbel(ur) : -INFINITY;
      } else {
        float m;
        if (d2best != nullptr) {
          m = __ldg(d2best + r);
        } else {
          float xr[DREG];
          load_row<DREG>(x, r, d, vec, xr);
          m = dist2<DREG>(xr, c);
        }
        if (step > 1) m = fminf(md[r], m);
        md[r] = m;
        s = wr > 0.0f && m > 0.0f ? logf(wr * m) + gumbel(ur) : -INFINITY;
      }
    }
    top.offer(s, r, lane, t);
  }

  lv[warp][lane] = top.v;
  li[warp][lane] = top.i;
  __syncthreads();
  if (warp == 0) {
    merge_warps(top, lv, li, lane, t);
    if (lane < t) {
      part_v[(long long)blockIdx.x * t + lane] = top.v;
      part_i[(long long)blockIdx.x * t + lane] = top.i;
    }
  }
  if (!arrive_last(ctl, &last)) return;

  // The last block: every block's t entries, a warp taking 32 at a time.
  top.reset();
  const int total = gridDim.x * t;
  for (int base = warp * 32; base < total; base += THREADS) {
    const int e = base + lane;
    const float v = e < total ? __ldcg(part_v + e) : -INFINITY;
    const long long i = e < total ? __ldcg(part_i + e) : NO_ROW;
    top.offer(v, i, lane, t);
  }
  __syncthreads();
  lv[warp][lane] = top.v;
  li[warp][lane] = top.i;
  __syncthreads();
  if (warp != 0) return;
  merge_warps(top, lv, li, lane, t);
  if (step == 0) {
    const long long first = __shfl_sync(FULL, top.v > -INFINITY ? top.i : 0LL, 0);
    if (lane == 0) rows[0] = first;
    for (int j = lane; j < d; j += 32) centers[j] = x[first * d + j];
  } else {
    const long long first = rows[0];
    const long long idx = top.v > -INFINITY ? top.i : first;
    if (lane < t) cand_idx[lane] = idx;
    for (int s = 0; s < t; ++s) {
      const long long row = __shfl_sync(FULL, idx, s);
      for (int j = lane; j < d; j += 32) cand_rows[s * d + j] = x[row * d + j];
    }
  }
  if (lane == 0) ctl->arrivals = 0;
}

// Fixed-order sum over the block of each thread's TP doubles (slots < t):
// a shuffle tree in each warp, then the warps in order; slot j's total in
// tot[j]. Ends with the block synchronised.
template <int TP>
__device__ __forceinline__ void block_sums(const double (&acc)[TP], double (*red)[TP], double* tot,
                                           int lane, int warp, int t) {
#pragma unroll
  for (int j = 0; j < TP; ++j) {
    double v = acc[j];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
    if (lane == 0) red[warp][j] = v;
  }
  __syncthreads();
  if ((int)threadIdx.x < t) {
    double s = 0.0;
    for (int v = 0; v < WARPS; ++v) s += red[v][threadIdx.x];
    tot[threadIdx.x] = s;
  }
  __syncthreads();
}

// K5b: the t candidates' potentials and the argmin, which becomes
// centers[step] and rows[step] (its slot in ctl->best). Where d2s is
// given, each row's D2 to candidate j goes to d2s[j * n + row].
template <int DREG, int TP>
__global__ void __launch_bounds__(THREADS)
seed_potentials(const float* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ md, float* __restrict__ d2s, long long n, int d, int t,
                int step, bool vec, const float* __restrict__ cand_rows,
                const long long* __restrict__ cand_idx, double* __restrict__ part,
                float* __restrict__ centers, long long* __restrict__ rows,
                Control* __restrict__ ctl) {
  __shared__ __align__(16) float cs[TP * DREG];
  __shared__ double red[WARPS][TP];
  __shared__ double tot[TP];
  __shared__ bool last;
  __shared__ int best;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int e = threadIdx.x; e < TP * DREG; e += THREADS) {
    const int s = e / DREG, j = e % DREG;
    cs[e] = s < t && j < d ? cand_rows[s * d + j] : 0.0f;
  }
  __syncthreads();

  double acc[TP];
#pragma unroll
  for (int j = 0; j < TP; ++j) acc[j] = 0.0;
  const long long tiles = (n + THREADS - 1) / THREADS;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long r = tile * THREADS + threadIdx.x;
    if (r < n) {
      float xr[DREG];
      load_row<DREG>(x, r, d, vec, xr);
      const float wr = __ldg(w + r);
      const float mr = __ldg(md + r);
#pragma unroll
      for (int j = 0; j < TP; ++j) {
        if (j < t) {
          const float d2 = dist2<DREG>(xr, cs + j * DREG);
          if (d2s != nullptr) d2s[(long long)j * n + r] = d2;
          acc[j] += (double)(fminf(mr, d2) * wr);
        }
      }
    }
  }
  block_sums<TP>(acc, red, tot, lane, warp, t);
  if ((int)threadIdx.x < t) part[(long long)blockIdx.x * t + threadIdx.x] = tot[threadIdx.x];
  if (!arrive_last(ctl, &last)) return;

  // The last block: blocks b, b + THREADS, ... a thread, in order, then
  // the same tree.
#pragma unroll
  for (int j = 0; j < TP; ++j) acc[j] = 0.0;
  for (int b = threadIdx.x; b < (int)gridDim.x; b += THREADS) {
#pragma unroll
    for (int j = 0; j < TP; ++j)
      if (j < t) acc[j] += __ldcg(part + (long long)b * t + j);
  }
  block_sums<TP>(acc, red, tot, lane, warp, t);
  if (threadIdx.x == 0) {
    int b = 0;
    for (int j = 1; j < t; ++j)
      if (tot[j] < tot[b]) b = j;
    best = b;
    ctl->best = b;
    rows[step] = cand_idx[b];
    ctl->arrivals = 0;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < d; j += THREADS)
    centers[(long long)step * d + j] = cand_rows[best * d + j];
}

int dreg_of(int d) { return d <= 4 ? 4 : d <= 8 ? 8 : d <= 16 ? 16 : d <= 32 ? 32 : 64; }
int tp_of(int t) { return t <= 4 ? 4 : t <= 8 ? 8 : t <= 16 ? 16 : 32; }

bool valid(long long n, int d, int t, int step) {
  return n >= 1 && d >= 1 && d <= D_MAX && t >= 1 && t <= T_MAX && step >= 0;
}

template <typename Kernel>
int occupancy(Kernel kernel) {
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, THREADS, 0);
  return err == cudaSuccess ? blocks : -(int)err;
}

template <int DREG>
int select_occupancy() {
  return occupancy(seed_select<DREG>);
}

template <int DREG>
int potentials_occupancy(int tp) {
  switch (tp) {
    case 4: return occupancy(seed_potentials<DREG, 4>);
    case 8: return occupancy(seed_potentials<DREG, 8>);
    case 16: return occupancy(seed_potentials<DREG, 16>);
    default: return occupancy(seed_potentials<DREG, 32>);
  }
}

template <int DREG, int TP>
void launch_potentials(int blocks, cudaStream_t stream, const float* x, const float* w,
                       const float* md, float* d2s, long long n, int d, int t, int step, bool vec,
                       const float* cand_rows, const long long* cand_idx, double* part,
                       float* centers, long long* rows, Control* ctl) {
  seed_potentials<DREG, TP><<<blocks, THREADS, 0, stream>>>(x, w, md, d2s, n, d, t, step, vec,
                                                           cand_rows, cand_idx, part, centers,
                                                           rows, ctl);
}

template <int DREG>
void potentials_tp(int blocks, cudaStream_t stream, const float* x, const float* w, const float* md,
                   float* d2s, long long n, int d, int t, int step, bool vec,
                   const float* cand_rows, const long long* cand_idx, double* part,
                   float* centers, long long* rows, Control* ctl) {
  switch (tp_of(t)) {
    case 4:
      launch_potentials<DREG, 4>(blocks, stream, x, w, md, d2s, n, d, t, step, vec, cand_rows,
                                 cand_idx, part, centers, rows, ctl);
      break;
    case 8:
      launch_potentials<DREG, 8>(blocks, stream, x, w, md, d2s, n, d, t, step, vec, cand_rows,
                                 cand_idx, part, centers, rows, ctl);
      break;
    case 16:
      launch_potentials<DREG, 16>(blocks, stream, x, w, md, d2s, n, d, t, step, vec, cand_rows,
                                  cand_idx, part, centers, rows, ctl);
      break;
    default:
      launch_potentials<DREG, 32>(blocks, stream, x, w, md, d2s, n, d, t, step, vec, cand_rows,
                                  cand_idx, part, centers, rows, ctl);
  }
}

bool vector_rows(const float* x, int d) { return d % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0; }

}  // namespace

// Resident blocks per SM on the current device of K5a (kernel 0) or K5b
// (kernel 1) at (d, t), or minus the CUDA error.
extern "C" int kmeans_seed_blocks_per_sm(int kernel, int d, int t) {
  if (!valid(1, d, t, 0) || (kernel != 0 && kernel != 1)) return -(int)cudaErrorInvalidValue;
  switch (dreg_of(d)) {
    case 4: return kernel == 0 ? select_occupancy<4>() : potentials_occupancy<4>(tp_of(t));
    case 8: return kernel == 0 ? select_occupancy<8>() : potentials_occupancy<8>(tp_of(t));
    case 16: return kernel == 0 ? select_occupancy<16>() : potentials_occupancy<16>(tp_of(t));
    case 32: return kernel == 0 ? select_occupancy<32>() : potentials_occupancy<32>(tp_of(t));
    default: return kernel == 0 ? select_occupancy<64>() : potentials_occupancy<64>(tp_of(t));
  }
}

// K5a of step `step` (t = 1 at step 0). x (n, d), w, u, md (n) float32;
// d2s null, or K5b's (t, n) D2s; centers (k, d), rows (k) int64;
// cand_rows (T_MAX, d), cand_idx (T_MAX); part_v, part_i (blocks, t);
// ctl a zeroed Control that the seeding's launches share.
extern "C" int kmeans_seed_select(const float* x, const float* w, const float* u, float* md,
                                  const float* d2s, long long n, int d, int t, int step,
                                  float* centers, long long* rows, float* cand_rows,
                                  long long* cand_idx, float* part_v, long long* part_i, void* ctl,
                                  int blocks, void* stream_ptr) {
  if (!valid(n, d, t, step) || blocks < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  Control* control = static_cast<Control*>(ctl);
  const bool vec = vector_rows(x, d);
  switch (dreg_of(d)) {
    case 4:
      seed_select<4><<<blocks, THREADS, 0, stream>>>(x, w, u, md, d2s, n, d, t, step, vec, centers,
                                                    rows, cand_rows, cand_idx, part_v, part_i,
                                                    control);
      break;
    case 8:
      seed_select<8><<<blocks, THREADS, 0, stream>>>(x, w, u, md, d2s, n, d, t, step, vec, centers,
                                                    rows, cand_rows, cand_idx, part_v, part_i,
                                                    control);
      break;
    case 16:
      seed_select<16><<<blocks, THREADS, 0, stream>>>(x, w, u, md, d2s, n, d, t, step, vec, centers,
                                                     rows, cand_rows, cand_idx, part_v, part_i,
                                                     control);
      break;
    case 32:
      seed_select<32><<<blocks, THREADS, 0, stream>>>(x, w, u, md, d2s, n, d, t, step, vec, centers,
                                                     rows, cand_rows, cand_idx, part_v, part_i,
                                                     control);
      break;
    default:
      seed_select<64><<<blocks, THREADS, 0, stream>>>(x, w, u, md, d2s, n, d, t, step, vec, centers,
                                                     rows, cand_rows, cand_idx, part_v, part_i,
                                                     control);
  }
  return (int)cudaGetLastError();
}

// K5b of step `step` >= 1: reads md after that step's K5a and its
// candidates; writes centers[step] and rows[step]. part (blocks, t)
// float64; d2s null, or (t, n) float32 to keep each row's D2s.
extern "C" int kmeans_seed_potentials(const float* x, const float* w, const float* md, float* d2s,
                                      long long n, int d, int t, int step, const float* cand_rows,
                                      const long long* cand_idx, double* part, float* centers,
                                      long long* rows, void* ctl, int blocks, void* stream_ptr) {
  if (!valid(n, d, t, step) || step < 1 || blocks < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  Control* control = static_cast<Control*>(ctl);
  const bool vec = vector_rows(x, d);
  switch (dreg_of(d)) {
    case 4:
      potentials_tp<4>(blocks, stream, x, w, md, d2s, n, d, t, step, vec, cand_rows, cand_idx, part,
                       centers, rows, control);
      break;
    case 8:
      potentials_tp<8>(blocks, stream, x, w, md, d2s, n, d, t, step, vec, cand_rows, cand_idx, part,
                       centers, rows, control);
      break;
    case 16:
      potentials_tp<16>(blocks, stream, x, w, md, d2s, n, d, t, step, vec, cand_rows, cand_idx,
                        part, centers, rows, control);
      break;
    case 32:
      potentials_tp<32>(blocks, stream, x, w, md, d2s, n, d, t, step, vec, cand_rows, cand_idx,
                        part, centers, rows, control);
      break;
    default:
      potentials_tp<64>(blocks, stream, x, w, md, d2s, n, d, t, step, vec, cand_rows, cand_idx,
                        part, centers, rows, control);
  }
  return (int)cudaGetLastError();
}
