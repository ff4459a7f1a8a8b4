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
//   2. one pass over each thread's contiguous chunk checks that both rows
//      are nonincreasing and reads x through L1 into shared memory in
//      float64 (every block reads x: through L2 alone, all at once, the
//      blocks queue for its few lines), summing it; a scan gives each
//      chunk's x prefix, and a second pass writes PX;
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
#include "scan.cuh"

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
  __shared__ int warp_flag[WWARPS];
  __shared__ double warp_x[WWARPS], warp_sum[WWARPS];
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
  const int chunk = (m + WT - 1) / WT;
  const int e0 = min((int)threadIdx.x * chunk, m), e1 = min(e0 + chunk, m);
  bool bad = false;
  double sx = 0.0;
  {
    float pa = e0 > 0 ? as[e0 - 1] : 0.f, pb = e0 > 0 ? bs[e0 - 1] : 0.f;
    for (int e = e0; e < e1; ++e) {
      const float ae = as[e], be = bs[e];
      // not nonincreasing, or a NaN (element 0 against itself)
      bad |= !(ae <= (e > 0 ? pa : ae)) || !(be <= (e > 0 ? pb : be));
      const double xe = (double)__ldg(x + e);
      xd[e] = xe;
      sx += xe;
      pa = ae;
      pb = be;
    }
  }
  double xincl = sx;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const double u = __shfl_up_sync(FULL, xincl, d);
    if (lane >= d) xincl += u;
  }
  const unsigned any = __any_sync(FULL, bad);
  if (lane == 31) {
    warp_flag[warp] = any ? 1 : 0;
    warp_x[warp] = xincl;
  }
  __syncthreads();
  int f = 0;
  double xbefore = 0.0;
#pragma unroll
  for (int w = 0; w < WWARPS; ++w) {
    f |= warp_flag[w];
    if (w < warp) xbefore += warp_x[w];
  }
  const bool full = f != 0;
  if (!full) {
    double run = xbefore + (xincl - sx);  // PX at e0
    for (int e = e0; e < e1; ++e) {
      px[e] = run;
      run += xd[e];
    }
    if (e0 < e1 && e1 == m) px[m] = run;
  }
  __syncthreads();

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

constexpr int NT = 256;  // threads of a coupling-gradient block, which owns one row
constexpr int NWARPS = NT / 32;

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
