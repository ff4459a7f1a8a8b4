// Pieces shared by the SOT kernels that give one block one row
// (csrc/plane.cu, csrc/merge.cu's coupling value, csrc/refgrad.cu): the
// row's copy into shared memory and the co-rank search of a merge path.

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
