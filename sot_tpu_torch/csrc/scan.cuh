// Block-wide float64 scans shared by csrc/synth.cu and csrc/merge.cu. Fixed
// orders (warp shuffles, then the warp totals) and no atomics, so two runs
// agree bit for bit. Every thread of the block must make the call.

#pragma once

#include <cuda_runtime.h>

// Exclusive prefix of v over the block's NT threads in thread order; with
// ``total``, also the block's total. warp_buf: NT / 32 doubles of shared
// memory.
template <int NT>
__device__ double block_excl_scan(double v, double* warp_buf, double* total = nullptr) {
  constexpr int NWARPS = NT / 32;
  constexpr unsigned FULL = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  double incl = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const double u = __shfl_up_sync(FULL, incl, d);
    if (lane >= d) incl += u;
  }
  double excl = __shfl_up_sync(FULL, incl, 1);
  if (lane == 0) excl = 0.0;
  if (lane == 31) warp_buf[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    double w = lane < NWARPS ? warp_buf[lane] : 0.0;
#pragma unroll
    for (int d = 1; d < NWARPS; d <<= 1) {
      const double u = __shfl_up_sync(FULL, w, d);
      if (lane >= d) w += u;
    }
    if (lane < NWARPS) warp_buf[lane] = w;
  }
  __syncthreads();
  const double out = warp > 0 ? warp_buf[warp - 1] + excl : excl;
  if (total != nullptr) *total = warp_buf[NWARPS - 1];
  __syncthreads();
  return out;
}

// Exclusive suffix of v over the block's threads (the sum over the threads
// after this one): the same scan over the mirrored thread order. mirror: NT
// doubles of shared memory.
template <int NT>
__device__ double block_excl_suffix(double v, double* warp_buf, double* mirror) {
  const int tid = threadIdx.x;
  mirror[tid] = v;
  __syncthreads();
  const double rev = block_excl_scan<NT>(mirror[NT - 1 - tid], warp_buf);
  mirror[NT - 1 - tid] = rev;
  __syncthreads();
  return mirror[tid];
}
