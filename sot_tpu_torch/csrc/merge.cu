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
