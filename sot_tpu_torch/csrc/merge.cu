// SOT W2 coupling forward for Hopper (sm_90a).
//
// Replaces the TPU kernel sot_tpu/ops/pallas/merge.py:_fwd_kernel (entry
// _coupling_fwd_pallas).
//
//   S[r] = sum_{k,l} x_k x_l min(a[r,k], b[r,l])
//
// a, b [rows, m]: the per-row complements cap - alpha, cap - beta of two
// clipped CDFs, each nonincreasing and >= 0; x [m] >= 0 the grid deltas.
// The value is convention-free (any exact evaluation of the sum is right).
//
// Design. The TPU kernel merges the two sorted rows with a bitonic network
// and integrates prefix-sum products, because the TPU has no cheap gather
// and a 16 MB VMEM (hence its origin-encoded payloads and the shaved tail
// column). Here one block owns one row, whose b, prefix and suffix sums sit
// in shared memory (~20 KB at m = 1025), and each a_k finds its place in b by
// binary search: b is nonincreasing, so with p = #{l : b_l >= a_k}
//
//   sum_l x_l min(a_k, b_l) = a_k * PX[p] + SXB[p],
//   PX[p] = sum_{l < p} x_l,   SXB[p] = sum_{l >= p} x_l b_l.
//
// Every term is >= 0: the suffix is summed directly (never as a total minus
// a prefix), so nothing cancels. The whole m columns are covered, so the
// JAX wrapper's O(n) boundary terms for the shaved column are not needed.
// Scans, products and the final reduction are in float64, in a fixed order
// (deterministic, no atomics); the row sum is rounded once to f32.
//
// Bound on the H100: bytes. At SOT-2048's loss shape (1024 rows x 1025) the
// function reads 8.4 MB and writes 4 KB (~2.5 us); the work is 1024 x 1025
// binary searches of 11 steps plus two scans, ~0.03 GFLOP.

#include <cuda_runtime.h>
#include <stddef.h>

#include "scan.cuh"

namespace {

constexpr int NT = 256;
constexpr int NWARPS = NT / 32;

__global__ void __launch_bounds__(NT)
coupling_fwd_kernel(const float* __restrict__ a, const float* __restrict__ b,
                    const float* __restrict__ x, float* __restrict__ out, int m) {
  extern __shared__ double smem[];
  double* px = smem;             // [m + 1]
  double* sxb = px + (m + 1);    // [m + 1]
  float* bs = reinterpret_cast<float*>(sxb + (m + 1));  // [m]
  __shared__ double warp_buf[NWARPS];
  __shared__ double mirror[NT];

  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const float* a_r = a + (size_t)row * m;
  const float* b_r = b + (size_t)row * m;
  for (int l = tid; l < m; l += NT) bs[l] = b_r[l];
  __syncthreads();

  // each thread owns one contiguous chunk of columns
  const int chunk = (m + NT - 1) / NT;
  const int lo = min(tid * chunk, m);
  const int hi = min(lo + chunk, m);
  double sx = 0.0, sb = 0.0;
  for (int l = lo; l < hi; ++l) {
    sx += (double)x[l];
    sb += (double)x[l] * (double)bs[l];
  }
  double total;
  double run = block_excl_scan<NT>(sx, warp_buf, &total);
  for (int l = lo; l < hi; ++l) {
    px[l] = run;
    run += (double)x[l];
  }
  if (tid == 0) px[m] = total;

  // suffix of x*b after this thread's columns
  run = block_excl_suffix<NT>(sb, warp_buf, mirror);
  for (int l = hi - 1; l >= lo; --l) {
    run += (double)x[l] * (double)bs[l];
    sxb[l] = run;
  }
  if (tid == 0) sxb[m] = 0.0;
  __syncthreads();

  double acc = 0.0;
  for (int k = tid; k < m; k += NT) {
    const float ak = a_r[k];
    int l0 = 0, l1 = m;  // first l with bs[l] < ak
    while (l0 < l1) {
      const int mid = (l0 + l1) >> 1;
      if (bs[mid] >= ak) l0 = mid + 1; else l1 = mid;
    }
    acc += (double)x[k] * ((double)ak * px[l0] + sxb[l0]);
  }
  block_excl_scan<NT>(acc, warp_buf, &total);
  if (tid == 0) out[row] = (float)total;
}

// ---------------------------------------------------------------------------
// Coupling gradient (kernel B8). Replaces the TPU kernel
// sot_tpu/ops/pallas/merge.py:_grad_kernel (entry _coupling_grads_pallas).
//
//   dS/db_l = x_l * (sum_k x_k [a_k > b_l] + 1/2 sum_k x_k [a_k == b_l])
//   dS/da_k = x_k * (sum_l x_l [b_l > a_k] + 1/2 sum_l x_l [b_l == a_k])
//
// the min-halving subgradient (autograd of torch.minimum splits a tie 1/2,
// 1/2), which the TPU kernel realises as the mean of two bitonic merges with
// opposite tie directions and two stream compactions per side. Here a and b
// are each sorted already, so no merge is needed: with the float64 prefix
// sums PX[p] = sum_{k < p} x_k, a query v into the nonincreasing row s gives
// the strict and the tie-inclusive weights PX[#{s > v}] and PX[#{s >= v}] by
// two binary searches, and the result x * (strict + inclusive) / 2 is
// rounded once to f32. A row that is not nonincreasing is scanned whole
// (O(m^2), the same sums in the dense oracle's form); the rows of real SOT
// losses are sorted. Deterministic, no atomics.
//
// Bound on the H100: bytes. At SOT-2048's shape (1024 x 1025, db only) it
// reads a, b (8.4 MB) and writes db (4.2 MB): ~3.8 us; the work is two binary
// searches of 11 steps per element.

// #{k : s_k > v} (strict) or #{k : s_k >= v} for nonincreasing s
template <bool INCLUSIVE>
__device__ __forceinline__ int count_above(const float* s, int m, float v) {
  int lo = 0, hi = m;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const bool above = INCLUSIVE ? (s[mid] >= v) : (s[mid] > v);
    if (above) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// out_l = x_l * (PX[#{s > q_l}] + PX[#{s >= q_l}]) / 2 for every column l of
// one row; `full` scans s whole instead (s not sorted).
__device__ void side_grad(const float* s, const float* q, const float* __restrict__ x,
                          const double* px, float* __restrict__ out, int m, bool full) {
  for (int l = threadIdx.x; l < m; l += NT) {
    const float v = q[l];
    double strict, incl;
    if (full) {
      strict = 0.0;
      incl = 0.0;
      for (int k = 0; k < m; ++k) {
        const double xk = (double)x[k];
        if (s[k] > v) strict += xk;
        if (s[k] >= v) incl += xk;
      }
    } else {
      strict = px[count_above<false>(s, m, v)];
      incl = px[count_above<true>(s, m, v)];
    }
    out[l] = (float)((double)x[l] * (0.5 * (strict + incl)));
  }
}

__global__ void __launch_bounds__(NT)
coupling_grad_kernel(const float* __restrict__ a, const float* __restrict__ b,
                     const float* __restrict__ x, float* __restrict__ da,
                     float* __restrict__ db, int m) {
  extern __shared__ double smem[];
  double* px = smem;                                      // [m + 1]
  float* as = reinterpret_cast<float*>(px + (m + 1));     // [m]
  float* bs = as + m;                                     // [m]
  __shared__ double warp_buf[NWARPS];

  const int tid = threadIdx.x;
  const size_t base = (size_t)blockIdx.x * m;
  for (int l = tid; l < m; l += NT) {
    as[l] = a[base + l];
    bs[l] = b[base + l];
  }
  // each thread owns one contiguous chunk of columns of the x prefix
  const int chunk = (m + NT - 1) / NT;
  const int lo = min(tid * chunk, m);
  const int hi = min(lo + chunk, m);
  double sx = 0.0;
  for (int l = lo; l < hi; ++l) sx += (double)x[l];
  double total;
  double run = block_excl_scan<NT>(sx, warp_buf, &total);
  for (int l = lo; l < hi; ++l) {
    px[l] = run;
    run += (double)x[l];
  }
  if (tid == 0) px[m] = total;
  __syncthreads();

  int ua = 0, ub = 0;
  for (int l = tid + 1; l < m; l += NT) {
    ua |= !(as[l] <= as[l - 1]);
    ub |= !(bs[l] <= bs[l - 1]);
  }
  const bool a_unsorted = __syncthreads_or(ua) != 0;
  const bool b_unsorted = __syncthreads_or(ub) != 0;

  side_grad(as, bs, x, px, db + base, m, a_unsorted);
  if (da != nullptr) side_grad(bs, as, x, px, da + base, m, b_unsorted);
}

}  // namespace

// a, b [rows, m] f32 contiguous, nonincreasing rows >= 0; x [m] f32 >= 0;
// out [rows] f32. Requires 1 <= m <= 8192 (checked by the Python wrapper).
// Returns cudaGetLastError() of the launch.
extern "C" int coupling_forward_f32(const float* a, const float* b, const float* x,
                                    float* out, int rows, int m, void* stream) {
  const size_t shmem = 2 * (size_t)(m + 1) * sizeof(double) + (size_t)m * sizeof(float);
  if (shmem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        coupling_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  coupling_fwd_kernel<<<rows, NT, shmem, static_cast<cudaStream_t>(stream)>>>(a, b, x, out, m);
  return static_cast<int>(cudaGetLastError());
}

// a, b [rows, m] f32 contiguous; x [m] f32 >= 0; db [rows, m] f32 and da
// [rows, m] f32 or null (no alpha gradients). Requires 1 <= m <= 8192.
// Returns cudaGetLastError() of the launch.
extern "C" int coupling_grads_f32(const float* a, const float* b, const float* x, float* da,
                                  float* db, int rows, int m, void* stream) {
  const size_t shmem = (size_t)(m + 1) * sizeof(double) + 2 * (size_t)m * sizeof(float);
  if (shmem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        coupling_grad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  coupling_grad_kernel<<<rows, NT, shmem, static_cast<cudaStream_t>(stream)>>>(a, b, x, da, db,
                                                                              m);
  return static_cast<int>(cudaGetLastError());
}
