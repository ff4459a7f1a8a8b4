// Reference-convention SOT gradient (beta side) for Hopper (sm_90a).
//
// Replaces the TPU kernel sot_tpu/ops/pallas/refgrad.py:_refgrad_kernel
// (entry _refgrad_queries_pallas, caller ref_grad_beta).
//
// Computes exactly ref_grad_beta_xla (refgrad.py:154-177) over all n
// columns of one row, for the target-constant training case:
//
//   ne_i = [alpha_i > alpha_{i-1}] (alpha_{-1} = 0);  P^m_i = ne_i * g_i^m
//   for each query q = beta_j:
//     R_lt = #{i : alpha_i < q}, R_le = #{i : alpha_i <= q}, tie = [R_le > R_lt]
//     F_hi = P_{R_lt}, F_lo = P_{R_le} (P_n = 0)
//     inner1 = F_hi (1 - 0.5 tie) - [q == 0] P_0
//     inner2 = 0.5 (F_hi + F_lo - [q == 0] P_0) - 0.5 F_hi tie
//     t1 = comb(inner1, g_j), t2 = comb(inner2, g_{j+1}),
//     comb(Q, G) = Q2 - 2 G Q1 + (G G) Q0
//     db_j = wbar * (vne_j t1 - vne_{j+1} t2),  vne_j = [beta_j > beta_{j-1}]
//
// This convention is load-bearing: every real training row sits on the
// quantile-cap tie kinks, where another valid subgradient trained worse
// (PERF.md, "The gradient-convention lesson"). So the ranks compare the RAW
// alpha and beta values (a rounded complement can tie where the raw values
// do not), and every product and sum is rounded on its own
// (__fmul_rn / __fadd_rn / __fsub_rn: no FMA contraction), in the plain
// version's order, so the kernel reproduces ref_grad_beta_plain bit for bit
// whenever the inputs are the same.
//
// Design. The TPU kernel finds R_lt / R_le by two total-order bitonic
// merges, log-step fills and stream compactions, because the TPU has no
// cheap gather. Here one block owns one row: alpha, beta and the grid sit
// in shared memory (12 KB at n = 1026) and each query binary-searches alpha
// (11 steps) and reads its two payloads directly.
//
// Bound on the H100: bytes. At SOT-2048's loss shape (1024 rows x 1026) the
// function reads alpha and beta and writes db, 12.6 MB (~3.8 us); the
// searches are ~0.05 G integer operations.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int NT = 256;

struct Payload {
  float p0, p1, p2;
};

__device__ __forceinline__ Payload payload(const float* al, const float* g, int i, int n) {
  if (i >= n) return {0.f, 0.f, 0.f};
  const float prev = i > 0 ? al[i - 1] : 0.f;
  const float ne = al[i] > prev ? 1.f : 0.f;
  return {ne, __fmul_rn(ne, g[i]), __fmul_rn(ne, __fmul_rn(g[i], g[i]))};
}

// Q2 - 2 G Q1 + (G G) Q0, rounded as the plain version rounds it
__device__ __forceinline__ float combine(float q2, float q1, float q0, float G) {
  const float c = __fsub_rn(q2, __fmul_rn(__fmul_rn(2.f, G), q1));
  return __fadd_rn(c, __fmul_rn(__fmul_rn(G, G), q0));
}

__global__ void __launch_bounds__(NT)
refgrad_kernel(const float* __restrict__ alpha, const float* __restrict__ beta,
               const float* __restrict__ grid, const float* __restrict__ wbar,
               float* __restrict__ db, int n) {
  extern __shared__ float smem[];
  float* al = smem;       // [n]
  float* be = al + n;     // [n]
  float* g = be + n;      // [n]
  const int row = blockIdx.x;
  const size_t base = (size_t)row * n;
  for (int i = threadIdx.x; i < n; i += NT) {
    al[i] = alpha[base + i];
    be[i] = beta[base + i];
    g[i] = grid[i];
  }
  __syncthreads();

  const Payload first = payload(al, g, 0, n);
  const float w = wbar[row];
  for (int j = threadIdx.x; j < n; j += NT) {
    const float q = be[j];
    int lo = 0, hi = n;  // R_lt: first i with al[i] >= q
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (al[mid] < q) lo = mid + 1; else hi = mid;
    }
    const int r_lt = lo;
    hi = n;  // R_le: first i with al[i] > q
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (al[mid] <= q) lo = mid + 1; else hi = mid;
    }
    const int r_le = lo;
    const float tie = r_le > r_lt ? 1.f : 0.f;
    const float q_zero = q == 0.f ? 1.f : 0.f;
    const Payload fh = payload(al, g, r_lt, n);
    const Payload fl = payload(al, g, r_le, n);

    // inner1 = fh * (1 - 0.5 tie) - q_zero * p0
    const float keep = __fsub_rn(1.f, __fmul_rn(0.5f, tie));
    const float i1_0 = __fsub_rn(__fmul_rn(fh.p0, keep), __fmul_rn(q_zero, first.p0));
    const float i1_1 = __fsub_rn(__fmul_rn(fh.p1, keep), __fmul_rn(q_zero, first.p1));
    const float i1_2 = __fsub_rn(__fmul_rn(fh.p2, keep), __fmul_rn(q_zero, first.p2));
    // inner2 = 0.5 * (fh + fl - q_zero * p0) - 0.5 * fh * tie
    const float i2_0 = __fsub_rn(
        __fmul_rn(0.5f, __fsub_rn(__fadd_rn(fh.p0, fl.p0), __fmul_rn(q_zero, first.p0))),
        __fmul_rn(__fmul_rn(0.5f, fh.p0), tie));
    const float i2_1 = __fsub_rn(
        __fmul_rn(0.5f, __fsub_rn(__fadd_rn(fh.p1, fl.p1), __fmul_rn(q_zero, first.p1))),
        __fmul_rn(__fmul_rn(0.5f, fh.p1), tie));
    const float i2_2 = __fsub_rn(
        __fmul_rn(0.5f, __fsub_rn(__fadd_rn(fh.p2, fl.p2), __fmul_rn(q_zero, first.p2))),
        __fmul_rn(__fmul_rn(0.5f, fh.p2), tie));

    const float g_next = j + 1 < n ? g[j + 1] : g[n - 1];
    const float t1 = combine(i1_2, i1_1, i1_0, g[j]);
    const float t2 = combine(i2_2, i2_1, i2_0, g_next);
    const float vne = q > (j > 0 ? be[j - 1] : 0.f) ? 1.f : 0.f;
    const float vne_next = (j + 1 < n && be[j + 1] > q) ? 1.f : 0.f;
    const float d = __fsub_rn(__fmul_rn(vne, t1), __fmul_rn(vne_next, t2));
    db[base + j] = __fmul_rn(w, d);
  }
}

}  // namespace

// alpha, beta [rows, n] f32 contiguous (nondecreasing clipped CDFs with the
// tail lane); grid [n] f32; wbar [rows] f32; db [rows, n] f32.
// Requires 1 <= n <= 16384 (checked by the Python wrapper). Returns
// cudaGetLastError() of the launch.
extern "C" int refgrad_beta_f32(const float* alpha, const float* beta, const float* grid,
                                const float* wbar, float* db, int rows, int n, void* stream) {
  const size_t shmem = 3 * (size_t)n * sizeof(float);
  if (shmem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        refgrad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  refgrad_kernel<<<rows, NT, shmem, static_cast<cudaStream_t>(stream)>>>(alpha, beta, grid,
                                                                         wbar, db, n);
  return static_cast<int>(cudaGetLastError());
}
