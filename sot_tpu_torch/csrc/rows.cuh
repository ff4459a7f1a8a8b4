// Pieces shared by the SOT kernels that give one block one row
// (csrc/plane.cu, csrc/merge.cu's coupling value and gradient,
// csrc/refgrad.cu): the row's copy into shared memory, the co-rank search
// of a merge path, and the coupling kernels' prologue (sortedness and the
// float64 prefix of the grid deltas).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// Floats of one shared-memory slot: n values placed so that the first
// 16-byte aligned element of the source lands on a 16-byte aligned address.
__host__ __device__ __forceinline__ int slot_floats(int n) { return (n + 7) & ~3; }

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Starts the copy of src[0, n) into the slot by the NT threads of the block:
// 16-byte cp.async where the source is aligned, 4-byte ones for the head and
// the tail. Returns the slot's element 0. The caller waits
// (cp.async.wait_all) and syncs.
template <int NT>
__device__ __forceinline__ float* copy_slot(const float* __restrict__ src, float* slot, int n) {
  const int lead = (int)(((16u - ((unsigned)(uintptr_t)src & 15u)) & 15u) >> 2);
  float* dst = slot + ((4 - lead) & 3);
  const int h = min(n, lead);
  const int m = (n - h) >> 2;
  for (int e = threadIdx.x; e < h; e += NT)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst + e)),
                 "l"(src + e));
  for (int q = threadIdx.x; q < m; q += NT)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst + h + 4 * q)),
                 "l"(src + h + 4 * q));
  for (int e = h + 4 * m + threadIdx.x; e < n; e += NT)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst + e)),
                 "l"(src + e));
  return dst;
}

// The merge path of two lists held in one array, A's values at v[0, na) and
// B's at v[off, off + nb), where A's element p goes before B's element q iff
// before(v[p], v[off + q]) (the lists sorted so that this holds along each):
// the largest p in [max(0, k - nb), min(k, na)] with
// before(v[p - 1], v[off + k - p]), so that the path's first k elements are
// A's first p and B's first k - p.
template <class Before>
__device__ __forceinline__ int corank(const float* v, int na, int nb, int off, int k,
                                      Before before) {
  int lo = max(0, k - nb), hi = min(k, na);
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (before(v[mid - 1], v[off + k - mid])) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// The prologue of a coupling block (csrc/merge.cu, kernels 4 and 8) once
// the row's as and bs [m] are in shared memory: one pass of the NT threads,
// each over one contiguous chunk, checks that both rows are nonincreasing
// (a NaN counts as unsorted) and reads x [m] through L1 (every block reads
// x: through L2 alone, all at once, the blocks queue for its few lines),
// summing it in float64; a warp scan and the warps' totals give each
// chunk's start, and a second pass writes px[p] = sum_{l < p} x_l for p =
// 0..m. KEEP_X: x is also kept in xd in float64, and the second pass reads
// it there. Returns bit 0 set where as is not nonincreasing, bit 1 where bs
// is not. Every thread of the block makes the call; it ends in a barrier.
template <int NT, bool KEEP_X>
__device__ __forceinline__ int row_prologue(const float* as, const float* bs,
                                            const float* __restrict__ x, double* xd, double* px,
                                            int m) {
  constexpr int NWARPS = NT / 32;
  constexpr unsigned FULL = 0xffffffffu;
  __shared__ int warp_flags[NWARPS];
  __shared__ double warp_x[NWARPS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int chunk = (m + NT - 1) / NT;
  const int e0 = min((int)threadIdx.x * chunk, m), e1 = min(e0 + chunk, m);
  bool bad_a = false, bad_b = false;
  double sx = 0.0;
  {
    float pa = e0 > 0 ? as[e0 - 1] : 0.f, pb = e0 > 0 ? bs[e0 - 1] : 0.f;
    for (int e = e0; e < e1; ++e) {
      const float ae = as[e], be = bs[e];
      // not nonincreasing, or a NaN (element 0 against itself)
      bad_a |= !(ae <= (e > 0 ? pa : ae));
      bad_b |= !(be <= (e > 0 ? pb : be));
      const double xe = (double)__ldg(x + e);
      if (KEEP_X) xd[e] = xe;
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
  const unsigned any_a = __any_sync(FULL, bad_a), any_b = __any_sync(FULL, bad_b);
  if (lane == 31) {
    warp_flags[warp] = (any_a ? 1 : 0) | (any_b ? 2 : 0);
    warp_x[warp] = xincl;
  }
  __syncthreads();
  int flags = 0;
  double xbefore = 0.0;
#pragma unroll
  for (int w = 0; w < NWARPS; ++w) {
    flags |= warp_flags[w];
    if (w < warp) xbefore += warp_x[w];
  }
  double run = xbefore + (xincl - sx);  // px at e0
  for (int e = e0; e < e1; ++e) {
    px[e] = run;
    run += KEEP_X ? xd[e] : (double)__ldg(x + e);
  }
  if (e0 < e1 && e1 == m) px[m] = run;
  __syncthreads();
  return flags;
}
