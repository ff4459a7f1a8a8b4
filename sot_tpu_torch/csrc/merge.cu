// SOT W2 coupling value and gradient for Hopper (sm_90a).
//
// The value (kernel B4) replaces the TPU kernel
// sot_tpu/ops/pallas/merge.py:_fwd_kernel (entry _coupling_fwd_pallas):
//
//   S[r] = sum_{k,l} x_k x_l min(a[r,k], b[r,l])
//
// a, b [rows, m]: the per-row complements cap - alpha, cap - beta of two
// clipped CDFs, each nonincreasing and >= 0; x [m] >= 0 the grid deltas.
// The value is convention-free (any exact evaluation of the sum is right).
//
// Design. Each pair (k, l) is counted once, at its smaller value: with the
// float64 prefix PX[p] = sum_{l < p} x_l and both rows nonincreasing,
//
//   S = sum_k x_k a_k PX[#{l : b_l >= a_k}] + sum_l x_l b_l PX[#{k : a_k > b_l}],
//
// a sum of terms >= 0 (nothing cancels, no suffix sum), and both counts are
// the cursor of one merge of the two rows in nonincreasing order (b first on
// a tie): taking a_k after q elements of b adds x_k a_k PX[q], taking b_l
// after p of a adds x_l b_l PX[p]. A block of WT = 128 threads owns one row:
//   1. cp.async brings the row's a and b into shared memory;
//   2. row_prologue (rows.cuh, shared with the gradient) checks that both
//      rows are nonincreasing, reads x through L1 into shared memory in
//      float64 and writes PX;
//   3. thread r owns the positions [r L, (r + 1) L) of the rows' merge path,
//      L = ceil(2 m / WT): one co-rank binary search finds its first, then
//      each step takes one element and adds its term; the next decision
//      waits on one shared load.
// Every row costs the same: the walk is over elements, not over the runs of
// equal values, whose lists cost more to build than they save (PERF.md §6).
// Each thread adds its terms in path order in float64, the lanes by a
// shfl_down tree, the warps in order; the row sum is rounded once to f32.
// Fixed orders and no atomics: two launches agree bit for bit. A row that
// is not nonincreasing on either side (or holds a NaN) is summed over all
// m x m pairs, a column of a per thread, so the kernel is right for any
// order. 24.7 KB of shared memory at m = 1025 and at most 64 registers
// (__launch_bounds__), so the 1024 blocks of a SOT-2048 batch run as one
// wave, 8 to an SM.
//
// Bound on the H100: bytes. At SOT-2048's loss shape (1024 rows x 1025) the
// function reads 8.4 MB and writes 4 KB (~2.5 us); the terms are ~4 float64
// operations per element, ~0.01 GFLOP.

#include <cuda_runtime.h>
#include <stddef.h>

#include "rows.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WT = 128;  // threads of a coupling-value block, which walks one row
constexpr int WWARPS = WT / 32;

// Dynamic shared memory of a coupling-value block: a and b in slots, then x
// [m] and PX [m + 1] in float64. 196,648 bytes at m = 8192.
__host__ __device__ __forceinline__ size_t fwd_smem_bytes(int m) {
  return 2 * (size_t)slot_floats(m) * sizeof(float) + (size_t)(2 * m + 1) * sizeof(double);
}

// a's element goes before b's on the merge path where a > b (b first on a tie)
struct AFirst {
  __device__ __forceinline__ bool operator()(float a, float b) const { return a > b; }
};

__global__ void __launch_bounds__(WT, 8)
coupling_fwd_kernel(const float* __restrict__ a, const float* __restrict__ b,
                    const float* __restrict__ x, float* __restrict__ out, int m) {
  extern __shared__ float4 smem4[];
  __shared__ double warp_sum[WWARPS];
  float* smem = reinterpret_cast<float*>(smem4);
  const int S = slot_floats(m);
  const size_t base = (size_t)blockIdx.x * m;
  const float* as = copy_slot<WT>(a + base, smem, m);
  const float* bs = copy_slot<WT>(b + base, smem + S, m);
  double* xd = reinterpret_cast<double*>(smem + 2 * S);  // x in float64
  double* px = xd + m;
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool full = row_prologue<WT, true>(as, bs, x, xd, px, m) != 0;

  double acc = 0.0;
  if (full) {
    for (int k = threadIdx.x; k < m; k += WT) {
      const float ak = as[k];
      double inner = 0.0;
      for (int l = 0; l < m; ++l) inner += xd[l] * (double)fminf(ak, bs[l]);
      acc += xd[k] * inner;
    }
  } else {
    const int npos = 2 * m;
    const int len = (npos + WT - 1) / WT;
    const int k0 = min((int)threadIdx.x * len, npos), k1 = min(k0 + len, npos);
    if (k0 < k1) {
      // p elements of a and q of b taken; b's slot read as the list after a's
      int p = corank(as, m, m, (int)(bs - as), k0, AFirst()), q = k0 - p;
      float va = as[p], vb = bs[q];  // p, q <= m: within the slots
      for (int k = k0; k < k1; ++k) {
        const bool ta = q == m || (p < m && va > vb);
        const int own = ta ? p : q;
        acc += xd[own] * (double)(ta ? va : vb) * px[ta ? q : p];
        p += ta;
        q += !ta;
        const float nv = ta ? as[p] : bs[q];
        va = ta ? nv : va;
        vb = ta ? vb : nv;
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(FULL, acc, o);
  if (lane == 0) warp_sum[warp] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    double total = warp_sum[0];
#pragma unroll
    for (int w = 1; w < WWARPS; ++w) total += warp_sum[w];
    out[blockIdx.x] = (float)total;
  }
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
// PX[p] = sum_{k < p} x_k, a query v into the nonincreasing row s has the
// strict and the tie-inclusive weights PX[#{s > v}] and PX[#{s >= v}], and
// the result x * (strict + inclusive) / 2 is rounded once to f32.
//
// Design. A block of GT = 128 threads owns one row: cp.async brings a and b
// into shared memory and row_prologue (rows.cuh, shared with the value)
// checks both rows and writes PX. Warp w takes the 32-column chunks w, w +
// 4, w + 8, ... of the row (its columns, in that order; every warp gets a
// share of the row's start and of its tail) and
//   1. marks its heads, its first column and each column whose query
//      differs from that of the column before it among its columns, and
//      compacts their queries in order into its slice of shared memory: the
//      equal queries of a sorted row are neighbours, so each distinct value
//      has one head (a real SOT row has few: the zeros past the quantile
//      cap and the flat CDF stretches repeat one value over many columns);
//   2. searches once per head, a lane to a head: a binary search of s gives
//      the strict count, and only where s[strict] == v (a tie) does a
//      second search go on past the tied run for the inclusive one (none
//      where the tie runs to the row's end, as the zeros do); the head
//      keeps its weight (PX[strict] + PX[inclusive]) / 2 in float64;
//   3. writes each column, x times its head's weight, coalesced.
// So a row takes one search per distinct value of each warp's columns and
// a second per tie. A side whose s is not nonincreasing (never on a real
// loss) scans s whole per column, the same sums in the dense oracle's form,
// so the kernel is right for any order. Fixed orders and no atomics: two
// launches agree bit for bit. 25.7 KB of shared memory at m = 1025 and at
// most 64 registers (__launch_bounds__), so the 1024 blocks of a SOT-2048
// batch run as one wave, 8 to an SM.
//
// Bound on the H100: bytes. At SOT-2048's shape (1024 x 1025, db only) it
// reads a, b (8.4 MB) and writes db (4.2 MB): ~3.8 us; the searches are
// ~11 steps per distinct query.

constexpr int GT = 128;  // threads of a coupling-gradient block, which owns one row
constexpr int GWARPS = GT / 32;

// Dynamic shared memory of a coupling-gradient block: a and b in slots, PX
// [m + 1] in float64, then the heads' values, 32 ceil(m / GT) float64 for
// each warp. 196,648 bytes at m = 8192.
__host__ __device__ __forceinline__ size_t grad_smem_bytes(int m) {
  return 2 * (size_t)slot_floats(m) * sizeof(float) + (size_t)(m + 1) * sizeof(double) +
         (size_t)GT * ((m + GT - 1) / GT) * sizeof(double);
}

// out_l = x_l * (PX[#{s > q_l}] + PX[#{s >= q_l}]) / 2 for the columns l of
// this warp (steps 1-3 above, in the warp's slice `heads`); `full` scans s
// whole instead (s not sorted), block-strided.
__device__ void side_grad(const float* s, const float* q, const float* __restrict__ x,
                          const double* px, double* heads, float* __restrict__ out, int m,
                          bool full) {
  if (full) {
    for (int l = threadIdx.x; l < m; l += GT) {
      const float v = q[l];
      double strict = 0.0, incl = 0.0;
      for (int k = 0; k < m; ++k) {
        const double xk = (double)__ldg(x + k);
        if (s[k] > v) strict += xk;
        if (s[k] >= v) incl += xk;
      }
      out[l] = (float)((double)__ldg(x + l) * (0.5 * (strict + incl)));
    }
    return;
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int chunks = (m + GT - 1) / GT;
  double* own = heads + warp * 32 * chunks;
  const unsigned upto = FULL >> (31 - lane);  // this lane and the ones below it
  // 1. the heads' queries, compacted in column order
  int nh = 0;
  for (int c = 0; c < chunks; ++c) {
    const int l = (warp + GWARPS * c) * 32 + lane;
    // the column before l among the warp's: l - 1, or its previous chunk's last
    const int prev = lane > 0 ? l - 1 : l - 32 * GWARPS + 31;
    const bool head = l < m && ((c == 0 && lane == 0) || q[l] != q[prev]);
    const unsigned mask = __ballot_sync(FULL, head);
    if (head) own[nh + __popc(mask & upto) - 1] = (double)q[l];
    nh += __popc(mask);
  }
  __syncwarp();
  // 2. a search per head, a second one only past a tie
  for (int h = lane; h < nh; h += 32) {
    const float v = (float)own[h];
    int lo = 0, hi = m;  // #{s > v}: the first k with !(s_k > v)
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (s[mid] > v) lo = mid + 1; else hi = mid;
    }
    const int strict = lo;
    if (lo < m && s[lo] == v) {  // a tie: #{s >= v} lies past the tied run
      if (s[m - 1] == v) {
        lo = m;
      } else {
        ++lo;
        hi = m - 1;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (s[mid] >= v) lo = mid + 1; else hi = mid;
        }
      }
    }
    own[h] = 0.5 * (px[strict] + px[lo]);  // the head's weight
  }
  __syncwarp();
  // 3. each column from its head's weight (its head: the last one at or
  // before it among the warp's columns)
  nh = 0;
  for (int c = 0; c < chunks; ++c) {
    const int l = (warp + GWARPS * c) * 32 + lane;
    const int prev = lane > 0 ? l - 1 : l - 32 * GWARPS + 31;
    const bool head = l < m && ((c == 0 && lane == 0) || q[l] != q[prev]);
    const unsigned mask = __ballot_sync(FULL, head);
    if (l < m) out[l] = (float)((double)__ldg(x + l) * own[nh + __popc(mask & upto) - 1]);
    nh += __popc(mask);
  }
}

__global__ void __launch_bounds__(GT, 8)
coupling_grad_kernel(const float* __restrict__ a, const float* __restrict__ b,
                     const float* __restrict__ x, float* __restrict__ da,
                     float* __restrict__ db, int m) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int S = slot_floats(m);
  const size_t base = (size_t)blockIdx.x * m;
  const float* as = copy_slot<GT>(a + base, smem, m);
  const float* bs = copy_slot<GT>(b + base, smem + S, m);
  double* px = reinterpret_cast<double*>(smem + 2 * S);
  double* heads = px + m + 1;
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  const int unsorted = row_prologue<GT, false>(as, bs, x, nullptr, px, m);
  side_grad(as, bs, x, px, heads, db + base, m, unsorted & 1);
  if (da != nullptr) {
    __syncwarp();  // the warp's slice of heads is used again
    side_grad(bs, as, x, px, heads, da + base, m, unsorted & 2);
  }
}

}  // namespace

// a, b [rows, m] f32 contiguous (nonincreasing rows >= 0 on the fast path;
// any order is summed right); x [m] f32 >= 0; out [rows] f32. Requires
// 1 <= m <= 8192 (checked by the Python wrapper). Returns
// cudaGetLastError() of the launch.
extern "C" int coupling_forward_f32(const float* a, const float* b, const float* x,
                                    float* out, int rows, int m, void* stream) {
  const size_t shmem = fwd_smem_bytes(m);
  if (shmem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        coupling_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  coupling_fwd_kernel<<<rows, WT, shmem, static_cast<cudaStream_t>(stream)>>>(a, b, x, out, m);
  return static_cast<int>(cudaGetLastError());
}

// a, b [rows, m] f32 contiguous; x [m] f32 >= 0; db [rows, m] f32 and da
// [rows, m] f32 or null (no alpha gradients). Requires 1 <= m <= 8192.
// Returns cudaGetLastError() of the launch.
extern "C" int coupling_grads_f32(const float* a, const float* b, const float* x, float* da,
                                  float* db, int rows, int m, void* stream) {
  const size_t shmem = grad_smem_bytes(m);
  if (shmem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        coupling_grad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  coupling_grad_kernel<<<rows, GT, shmem, static_cast<cudaStream_t>(stream)>>>(a, b, x, da, db, m);
  return static_cast<int>(cudaGetLastError());
}
