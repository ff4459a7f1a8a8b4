// Framed SGEMM tiles shared by csrc/cqt.cu (kernel B1, the CQT projection)
// and csrc/stft.cu (kernel B9, the STFT frontend), float32 on the CUDA cores:
//
//   out[b, f, n] = sum_{w < width} sig[b, f*hop + w] * basis[w, n]
//
// a GEMM of M = batch*n_frames rows, K = width and N = ldb columns whose A
// operand is the overlapping frames, read straight from the signal (never
// materialised). With MASK_END, samples at or past t_sig read as zero
// (pad_end framing); without it the caller has padded the signal.
//
// The tile is a plain shared-memory-tiled SIMT SGEMM: 128x128 block tile, 8x8
// outputs per thread, float4 shared loads laid out conflict-free, split over K
// (blockIdx.z) into partial tiles that reduce_splits sums in a fixed order,
// so results are deterministic (no atomics). f32 with f32 accumulation.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace framed {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 8;
constexpr int NT = 256;

// One block's partial tile: rows m0 = blockIdx.y*BM.., columns n0 =
// blockIdx.x*BN.., taps [blockIdx.z*k_split, +k_split) into partial[blockIdx.z].
// sig rows are t_sig samples apart.
template <bool MASK_END>
__device__ __forceinline__ void partial_tile(const float* __restrict__ sig,
                                             const float* __restrict__ basis,
                                             float* __restrict__ partial, int t_sig,
                                             int n_frames, int hop, int m_rows, int ldb,
                                             int k_split) {
  __shared__ __align__(16) float As[BK][BM];
  __shared__ __align__(16) float Bs[BK][BN];

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int k_begin = blockIdx.z * k_split;

  // A loader: one frame row, four consecutive taps per thread.
  const int a_row = tid >> 1;
  const int a_k = (tid & 1) * 4;
  const int m = m0 + a_row;
  const bool a_ok = m < m_rows;
  const float* a_src = sig;
  int a_left = 0;  // samples of the row from the frame's start to the signal's end
  if (a_ok) {
    const int b = m / n_frames;
    const int f = m - b * n_frames;
    a_src = sig + (size_t)b * t_sig + (size_t)f * hop;
    a_left = t_sig - f * hop;
  }
  // B loader: one basis row, one float4 per thread.
  const int b_k = tid >> 5;
  const int b_n = (tid & 31) * 4;
  const float* b_src = basis + n0 + b_n;

  // Each thread owns rows {ty*4 + i, 64 + ty*4 + i} and columns
  // {tx*4 + j, 64 + tx*4 + j}: a quarter-warp's float4 reads of Bs then
  // cover 32 consecutive words (no bank conflicts).
  const int tx = tid & 15;
  const int ty = tid >> 4;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = k_begin; k0 < k_begin + k_split; k0 += BK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = k0 + a_k + i;
      const bool ok = MASK_END ? (a_ok && k < a_left) : a_ok;
      As[a_k + i][a_row] = ok ? a_src[k] : 0.f;
    }
    *reinterpret_cast<float4*>(&Bs[b_k][b_n]) =
        *reinterpret_cast<const float4*>(b_src + (size_t)(k0 + b_k) * ldb);
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* dst = partial + (size_t)blockIdx.z * m_rows * ldb;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4));
    if (row >= m_rows) continue;
    float* out_row = dst + (size_t)row * ldb + n0;
    *reinterpret_cast<float4*>(out_row + tx * 4) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(out_row + 64 + tx * 4) =
        make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
}

// out[m, n] = sum over splits s = 0, 1, ... of partial[s, m, n], n < n_out,
// for the element of this thread.
__device__ __forceinline__ void reduce_splits(const float* __restrict__ partial,
                                              float* __restrict__ out, int m_rows, int ldb,
                                              int n_out, int splits) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= m_rows * n_out) return;
  const int row = idx / n_out;
  const int col = idx - row * n_out;
  const size_t stride = (size_t)m_rows * ldb;
  const float* src = partial + (size_t)row * ldb + col;
  float acc = 0.f;
  for (int s = 0; s < splits; ++s) acc += src[s * stride];
  out[idx] = acc;
}

}  // namespace framed
