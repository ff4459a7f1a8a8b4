// Banded-plane SOT kernels for Hopper (sm_90a): the same-grid W_p^p value
// (forward) and its cotangents (backward).
//
// Replaces the TPU kernels sot_tpu/ops/pallas/sot.py:_fwd_kernel (entry
// _pallas_fwd) and _bwd_kernel (entry _pallas_bwd).
//
// Per row, with alpha, beta [n] the clipped augmented CDFs, gamma_i =
// alpha_{i-1}, delta_j = beta_{j-1} (gamma_0 = delta_0 = 0) and the grid g [n]:
//
//   mu_ij = relu(min(alpha_i, beta_j) - max(gamma_i, delta_j))
//   W     = sum_ij mu_ij |g_j - g_i|^p                            (forward)
//
// and, for the row weight wbar, the plane convention of _bwd_kernel
// (sot.py:180-197), cell by cell:
//
//   m  = [min(alpha_i, beta_j) > max(gamma_i, delta_j)]
//   k  = (m * |g_j - g_i|^p) * wbar
//   wa = 1, 0.5, 0 for alpha_i <, ==, > beta_j
//   wc = 1, 0.5, 0 for gamma_i >, ==, < delta_j
//   db_j += k - k wa,  dd_j += k wc - k,  da_i += k wa,  dc_i -= k wc
//
// then the shift fold of sot.py:365-380: dbeta_j = db_j + dd_{j+1} and
// dalpha_i = da_i + dc_{i+1} (the terms past the last column are 0).
// |d|^p is d*d for p = 2, |d| for p = 1, |d|*|d|*|d| for p = 3 (the product
// PyTorch's pow takes for that exponent, so the plain version on the card
// rounds the same way) and powf otherwise.
//
// The tie weights are load-bearing: every real training row sits on the
// quantile cap's ties, where another valid subgradient trained worse
// (PERF.md, "The gradient-convention lesson"). So every cell that can be
// non-zero is evaluated with exactly these expressions on the raw values.
//
// Design. The TPU kernel gives each program 128 rows on the lanes, which
// must share one band of j-slabs per 8-row i-group (_band_limits, and the
// caller's row grouping by half-mass bin). Here one block owns one row: alpha,
// beta and the grid sit in shared memory (3 KB at n = 258, 12 KB at 1026) and
// each row gets its own exact band. With alpha nondecreasing, the cells of
// column j where mu can be > 0 are one contiguous i-range:
//
//   alpha_i > delta_j          <=>  i >= #{alpha <= delta_j}
//   beta_j > gamma_i (i >= 1)  <=>  i <= #{alpha < beta_j}
//
// found by two binary searches; the mirrored pass (one thread per i over j)
// uses the same searches in beta. Cells outside a range are exactly zero in
// every expression above, so skipping them changes no sum. Each block checks
// that its alpha (and, for the alpha pass, beta) is nondecreasing; a row that
// is not scans the whole plane for that pass, so the kernels equal their
// plain versions on any input.
//
// Sums: one thread per column (forward and beta pass) or per row element
// (alpha pass) sums its cells in increasing order in float64; the forward's
// block total is a fixed-order shuffle scan (scan.cuh). No atomics, so two
// runs agree bit for bit. Each cell's f32 product is rounded as in the plain
// version (__fmul_rn / __fsub_rn, no FMA contraction), and each output is
// rounded once to f32.
//
// Bound on the H100: bytes. Sorted rows visit O(n) cells each (two monotone
// staircases overlap in at most 2n - 1 cells, plus plateau cells): at
// SOT-2048's loss shape (1024 rows x 1026) the forward reads 8.4 MB (~2.5 us)
// and the backward also writes dbeta (12.6 MB, ~3.8 us); the work is ~2 x
// 1024 x 1026 binary searches of 11 steps and a few million cells of ~10
// operations, ~0.1 GFLOP.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "scan.cuh"

namespace {

constexpr int NT = 256;

__device__ __forceinline__ float dist_pow(float d, float p) {
  if (p == 2.f) return __fmul_rn(d, d);
  const float a = fabsf(d);
  if (p == 1.f) return a;
  if (p == 3.f) return __fmul_rn(__fmul_rn(a, a), a);
  return powf(a, p);
}

// #{k : a_k <= v} for nondecreasing a
__device__ __forceinline__ int count_le(const float* a, int n, float v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] <= v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// #{k : a_k < v} for nondecreasing a
__device__ __forceinline__ int count_lt(const float* a, int n, float v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Cells [lo, hi) of the other side that can overlap the interval
// (prev, cur] of this side; the whole range when ``other`` is not sorted.
__device__ __forceinline__ void band(const float* other, int n, float prev, float cur,
                                     bool full, int* lo, int* hi) {
  if (full) {
    *lo = 0;
    *hi = n;
    return;
  }
  *lo = count_le(other, n, prev);
  *hi = min(count_lt(other, n, cur) + 1, n);
}

// Loads one row's alpha, beta and the grid; returns whether alpha (bit 0) and
// beta (bit 1) fail to be nondecreasing. Every thread must make the call.
__device__ int load_row(const float* __restrict__ alpha, const float* __restrict__ beta,
                        const float* __restrict__ grid, float* al, float* be, float* g,
                        int n) {
  const size_t base = (size_t)blockIdx.x * n;
  for (int i = threadIdx.x; i < n; i += NT) {
    al[i] = alpha[base + i];
    be[i] = beta[base + i];
    g[i] = grid[i];
  }
  __syncthreads();
  int ua = 0, ub = 0;
  for (int i = threadIdx.x + 1; i < n; i += NT) {
    ua |= !(al[i] >= al[i - 1]);
    ub |= !(be[i] >= be[i - 1]);
  }
  const int fa = __syncthreads_or(ua);
  const int fb = __syncthreads_or(ub);
  return (fa ? 1 : 0) | (fb ? 2 : 0);
}

__global__ void __launch_bounds__(NT)
plane_fwd_kernel(const float* __restrict__ alpha, const float* __restrict__ beta,
                 const float* __restrict__ grid, float p, float* __restrict__ out, int n) {
  extern __shared__ float smem[];
  float* al = smem;    // [n]
  float* be = al + n;  // [n]
  float* g = be + n;   // [n]
  __shared__ double warp_buf[NT / 32];
  const bool full = load_row(alpha, beta, grid, al, be, g, n) & 1;

  double acc = 0.0;
  for (int j = threadIdx.x; j < n; j += NT) {
    const float b = be[j];
    const float d = j > 0 ? be[j - 1] : 0.f;
    const float gj = g[j];
    int lo, hi;
    band(al, n, d, b, full, &lo, &hi);
    for (int i = lo; i < hi; ++i) {
      const float a = al[i];
      const float c = i > 0 ? al[i - 1] : 0.f;
      const float diff = __fsub_rn(fminf(a, b), fmaxf(c, d));
      const float mu = diff > 0.f ? diff : 0.f;
      acc += (double)__fmul_rn(mu, dist_pow(__fsub_rn(gj, g[i]), p));
    }
  }
  double total;
  block_excl_scan<NT>(acc, warp_buf, &total);
  if (threadIdx.x == 0) out[blockIdx.x] = (float)total;
}

struct Cell {
  float k, wa, wc;
};

__device__ __forceinline__ Cell cell(float a, float c, float b, float d, float gi, float gj,
                                     float p, float w) {
  const float m = fminf(a, b) > fmaxf(c, d) ? 1.f : 0.f;
  const float k = __fmul_rn(__fmul_rn(m, dist_pow(__fsub_rn(gj, gi), p)), w);
  const float wa = a < b ? 1.f : (a == b ? 0.5f : 0.f);
  const float wc = c > d ? 1.f : (c == d ? 0.5f : 0.f);
  return {k, wa, wc};
}

__global__ void __launch_bounds__(NT)
plane_bwd_kernel(const float* __restrict__ alpha, const float* __restrict__ beta,
                 const float* __restrict__ grid, const float* __restrict__ wbar, float p,
                 float* __restrict__ da, float* __restrict__ db, int n) {
  extern __shared__ double dsmem[];
  double* own = dsmem;                                  // [n]: db_j, then da_i
  double* shifted = own + n;                            // [n + 1]: dd_j, then dc_i; [n] = 0
  float* al = reinterpret_cast<float*>(shifted + n + 1);  // [n]
  float* be = al + n;                                   // [n]
  float* g = be + n;                                    // [n]
  const int unsorted = load_row(alpha, beta, grid, al, be, g, n);
  const float w = wbar[blockIdx.x];
  const size_t base = (size_t)blockIdx.x * n;

  // beta pass: one thread per column j, its cells in increasing i
  for (int j = threadIdx.x; j < n; j += NT) {
    const float b = be[j];
    const float d = j > 0 ? be[j - 1] : 0.f;
    const float gj = g[j];
    int lo, hi;
    band(al, n, d, b, unsorted & 1, &lo, &hi);
    double sb = 0.0, sd = 0.0;
    for (int i = lo; i < hi; ++i) {
      const Cell e = cell(al[i], i > 0 ? al[i - 1] : 0.f, b, d, g[i], gj, p, w);
      sb += (double)__fsub_rn(e.k, __fmul_rn(e.k, e.wa));
      sd += (double)__fsub_rn(__fmul_rn(e.k, e.wc), e.k);
    }
    own[j] = sb;
    shifted[j] = sd;
  }
  if (threadIdx.x == 0) shifted[n] = 0.0;
  __syncthreads();
  for (int j = threadIdx.x; j < n; j += NT) db[base + j] = (float)(own[j] + shifted[j + 1]);
  if (da == nullptr) return;
  __syncthreads();

  // alpha pass: one thread per i, its cells in increasing j
  for (int i = threadIdx.x; i < n; i += NT) {
    const float a = al[i];
    const float c = i > 0 ? al[i - 1] : 0.f;
    const float gi = g[i];
    int lo, hi;
    band(be, n, c, a, unsorted & 2, &lo, &hi);
    double sa = 0.0, sc = 0.0;
    for (int j = lo; j < hi; ++j) {
      const Cell e = cell(a, c, be[j], j > 0 ? be[j - 1] : 0.f, gi, g[j], p, w);
      sa += (double)__fmul_rn(e.k, e.wa);
      sc -= (double)__fmul_rn(e.k, e.wc);
    }
    own[i] = sa;
    shifted[i] = sc;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += NT) da[base + i] = (float)(own[i] + shifted[i + 1]);
}

int set_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes));
}

}  // namespace

// alpha, beta [rows, n] f32 contiguous; grid [n] f32; out [rows] f32.
// Requires 1 <= n <= 8192 (checked by the Python wrapper). Returns
// cudaGetLastError() of the launch.
extern "C" int sot_plane_forward_f32(const float* alpha, const float* beta, const float* grid,
                                     float p, float* out, int rows, int n, void* stream) {
  const size_t shmem = 3 * (size_t)n * sizeof(float);
  const int err = set_smem((const void*)plane_fwd_kernel, shmem);
  if (err != 0) return err;
  plane_fwd_kernel<<<rows, NT, shmem, static_cast<cudaStream_t>(stream)>>>(alpha, beta, grid, p,
                                                                           out, n);
  return static_cast<int>(cudaGetLastError());
}

// alpha, beta [rows, n] f32 contiguous; grid [n] f32; wbar [rows] f32;
// db [rows, n] f32; da [rows, n] f32, or null to skip the alpha pass.
// Requires 1 <= n <= 8192 (checked by the Python wrapper). Returns
// cudaGetLastError() of the launch.
extern "C" int sot_plane_backward_f32(const float* alpha, const float* beta, const float* grid,
                                      const float* wbar, float p, float* da, float* db, int rows,
                                      int n, void* stream) {
  const size_t shmem = (2 * (size_t)n + 1) * sizeof(double) + 3 * (size_t)n * sizeof(float);
  const int err = set_smem((const void*)plane_bwd_kernel, shmem);
  if (err != 0) return err;
  plane_bwd_kernel<<<rows, NT, shmem, static_cast<cudaStream_t>(stream)>>>(alpha, beta, grid, wbar,
                                                                           p, da, db, n);
  return static_cast<int>(cudaGetLastError());
}
