// Reference-convention SOT gradient (beta side) for Hopper (sm_90a).
//
// Replaces the TPU kernel sot_tpu/ops/pallas/refgrad.py:_refgrad_kernel
// (entry _refgrad_queries_pallas, caller ref_grad_beta).
//
// Computes ref_grad_beta_xla (refgrad.py:154-177) over all n
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
// version's order. alpha must be nondecreasing, as it must for
// torch.searchsorted in the plain version; beta may be in any order.
//
// Design. The TPU kernel finds R_lt / R_le by two total-order bitonic
// merges, log-step fills and stream compactions, because the TPU has no
// cheap gather. Here a block of NT = 256 threads owns one row, which
// cp.async brings into shared memory; thread r takes the columns j = r,
// r + NT, ..., so a warp works on 32 neighbouring columns (alike in what
// they need) and stores them coalesced:
//   1. a column whose vne_j and vne_{j+1} are both 0 gets a zero: w (0 t1 -
//      0 t2), which the plain version may sign otherwise (~73% of the
//      columns of the smoke's real SOT-2048 rows);
//   2. on the others a binary search of alpha gives R_lt; R_le is R_lt but
//      on a tie (alpha_{R_lt} == q), where a second search goes on past it;
//   3. only the t of each flag that is 1 is computed (the other's product
//      with 0 is a zero, which changes the difference only where both are
//      zeros), and without a tie and with q != 0 (most columns) inner1 =
//      inner2 = F_hi to the last bit wherever they are not zeros, so the t
//      is comb(F_hi, G) directly.
// So every result that is not a zero is the plain version's bit for bit,
// and the two are equal under ==. One barrier and no lists: walking a merge
// path of the two rows (of their runs of equal values or of their
// elements) spends more on building the runs' lists or on warps whose lanes
// part at every step than it saves on the searches (PERF.md §6). 8.3 KB
// of shared memory at n = 1026 and at most 32 registers
// (__launch_bounds__), so the 1024 blocks of a SOT-2048 batch run as one
// wave, 8 to an SM, 64 warps each.
//
// Bound on the H100: bytes. At SOT-2048's loss shape (1024 rows x 1026) the
// function reads alpha and beta and writes db, 12.6 MB (~3.8 us); the
// closed form is ~45 operations per column that needs it.

#include <cuda_runtime.h>
#include <stddef.h>

#include "rows.cuh"

namespace {

constexpr int NT = 256;  // threads of a block, which owns one row

struct Payload {
  float p0, p1, p2;
};

__device__ __forceinline__ Payload payload(const float* al, const float* __restrict__ g, int i,
                                           int n) {
  if (i >= n) return {0.f, 0.f, 0.f};
  const float prev = i > 0 ? al[i - 1] : 0.f;
  const float ne = al[i] > prev ? 1.f : 0.f;
  const float gi = __ldg(g + i);
  return {ne, __fmul_rn(ne, gi), __fmul_rn(ne, __fmul_rn(gi, gi))};
}

// Q2 - 2 G Q1 + (G G) Q0, rounded as the plain version rounds it
__device__ __forceinline__ float combine(float q2, float q1, float q0, float G) {
  const float c = __fsub_rn(q2, __fmul_rn(__fmul_rn(2.f, G), q1));
  return __fadd_rn(c, __fmul_rn(__fmul_rn(G, G), q0));
}

__global__ void __launch_bounds__(NT, 8)
refgrad_kernel(const float* __restrict__ alpha, const float* __restrict__ beta,
               const float* __restrict__ grid, const float* __restrict__ wbar,
               float* __restrict__ db, int n) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const size_t base = (size_t)blockIdx.x * n;
  const float* al = copy_slot<NT>(alpha + base, smem, n);
  const float* be = copy_slot<NT>(beta + base, smem + slot_floats(n), n);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  const Payload first = payload(al, grid, 0, n);
  const float w = wbar[blockIdx.x];
  float* out = db + base;
  for (int j = threadIdx.x; j < n; j += NT) {
    const float q = be[j];
    const bool vne = q > (j > 0 ? be[j - 1] : 0.f);
    const bool vne_next = j + 1 < n && be[j + 1] > q;
    if (!vne && !vne_next) {  // w (0 t1 - 0 t2): a zero
      out[j] = 0.f;
    } else {
      int lo = 0, hi = n;  // R_lt: first i with al[i] >= q
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (al[mid] < q) lo = mid + 1; else hi = mid;
      }
      const int r_lt = lo;
      if (lo < n && al[lo] == q) {  // a tie: R_le, the first i with al[i] > q, lies past it
        hi = n;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (al[mid] <= q) lo = mid + 1; else hi = mid;
        }
      }
      const int r_le = lo;
      const float tie = r_le > r_lt ? 1.f : 0.f;
      const float q_zero = q == 0.f ? 1.f : 0.f;
      const Payload fh = payload(al, grid, r_lt, n);

      // d = vne t1 - vne_next t2, each t where its flag is 1
      float t1 = 0.f, t2 = 0.f;
      if (r_le == r_lt && q != 0.f) {  // inner1 = inner2 = fh
        if (vne) t1 = combine(fh.p2, fh.p1, fh.p0, __ldg(grid + j));
        if (vne_next) t2 = combine(fh.p2, fh.p1, fh.p0, __ldg(grid + j + 1));
      } else {
        if (vne) {
          // inner1 = fh * (1 - 0.5 tie) - q_zero * p0
          const float keep = __fsub_rn(1.f, __fmul_rn(0.5f, tie));
          const float i1_0 = __fsub_rn(__fmul_rn(fh.p0, keep), __fmul_rn(q_zero, first.p0));
          const float i1_1 = __fsub_rn(__fmul_rn(fh.p1, keep), __fmul_rn(q_zero, first.p1));
          const float i1_2 = __fsub_rn(__fmul_rn(fh.p2, keep), __fmul_rn(q_zero, first.p2));
          t1 = combine(i1_2, i1_1, i1_0, __ldg(grid + j));
        }
        if (vne_next) {
          // inner2 = 0.5 * (fh + fl - q_zero * p0) - 0.5 * fh * tie
          const Payload fl = r_le == r_lt ? fh : payload(al, grid, r_le, n);
          const float i2_0 = __fsub_rn(
              __fmul_rn(0.5f, __fsub_rn(__fadd_rn(fh.p0, fl.p0), __fmul_rn(q_zero, first.p0))),
              __fmul_rn(__fmul_rn(0.5f, fh.p0), tie));
          const float i2_1 = __fsub_rn(
              __fmul_rn(0.5f, __fsub_rn(__fadd_rn(fh.p1, fl.p1), __fmul_rn(q_zero, first.p1))),
              __fmul_rn(__fmul_rn(0.5f, fh.p1), tie));
          const float i2_2 = __fsub_rn(
              __fmul_rn(0.5f, __fsub_rn(__fadd_rn(fh.p2, fl.p2), __fmul_rn(q_zero, first.p2))),
              __fmul_rn(__fmul_rn(0.5f, fh.p2), tie));
          t2 = combine(i2_2, i2_1, i2_0, __ldg(grid + j + 1));
        }
      }
      const float d = vne ? (vne_next ? __fsub_rn(t1, t2) : t1) : -t2;
      out[j] = __fmul_rn(w, d);
    }
  }
}

}  // namespace

// alpha, beta [rows, n] f32 contiguous (nondecreasing clipped CDFs with the
// tail lane; beta may be in any order); grid [n] f32; wbar [rows] f32;
// db [rows, n] f32. Requires 1 <= n <= 16384 (checked by the Python
// wrapper). Returns cudaGetLastError() of the launch.
extern "C" int refgrad_beta_f32(const float* alpha, const float* beta, const float* grid,
                                const float* wbar, float* db, int rows, int n, void* stream) {
  const size_t shmem = 2 * (size_t)slot_floats(n) * sizeof(float);
  if (shmem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        refgrad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  refgrad_kernel<<<rows, NT, shmem, static_cast<cudaStream_t>(stream)>>>(alpha, beta, grid,
                                                                         wbar, db, n);
  return static_cast<int>(cudaGetLastError());
}
