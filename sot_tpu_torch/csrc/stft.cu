// STFT frontend for Hopper (sm_90a): pad_end framing + window + real-DFT
// projection, float32 on the CUDA cores (kernel B9).
//
// Replaces the TPU kernel sot_tpu/ops/pallas/stft.py:_frontend_kernel (entry
// _project_pallas).
//
//   proj[b, c, n] = sum_{t < n_fft} audio[b, c*hop + t] * Mw[t, n]
//
// with audio [batch, T], zeros past T (tf-style pad_end framing: C = T / hop
// frames when hop divides T), and Mw [n_fft, ldb] the real-DFT basis [cos |
// -sin] with the window folded in (in f32, as the JAX package folds it),
// columns 2*(n_fft/2 + 1)..ldb-1 zero.
//
// Design. The TPU kernel builds each row tile's frames in VMEM from hop-sized
// chunks with static rolls (no gathers) and runs one MXU matmul per K tile.
// Here the frames are the A operand of a tiled SIMT SGEMM that reads them
// straight from the audio, masking the pad_end samples to zero, so no frame
// matrix is written (q = n_fft / hop times the audio): the tiles of
// csrc/framed_gemm.cuh, which the CQT projection shares. Split over K when the
// output tiles alone would not fill the SMs, with a fixed-order reduction
// (deterministic, no atomics). f32 with f32 accumulation (JAX: HIGHEST).
//
// Bound on the H100: bytes. The function is an rfft of each windowed frame,
// O(n log n): at the loss STFT of SOT-2048 (2048/256, 64 clips, 1024 frames)
// ~60 MFLOP against ~9.4 MB of audio read and spectra written, ~0.003 ms.
// This kernel does the dense DFT product instead (1024 rows x 2048 taps x
// 2050 columns = 8.6 GFLOP, 0.128 ms at the FP32 peak), as the TPU kernel
// does, so it stays far from that bound by construction; cuFFT computes the
// same spectra. This kernel exists because the gated path runs it.

#include <cuda_runtime.h>
#include <stddef.h>

#include "framed_gemm.cuh"

namespace {

using framed::BM;
using framed::BN;
using framed::NT;

__global__ void __launch_bounds__(NT)
stft_frontend_partial_kernel(const float* __restrict__ audio, const float* __restrict__ basis,
                             float* __restrict__ partial, int t, int n_frames, int hop,
                             int m_rows, int ldb, int k_split) {
  framed::partial_tile<true>(audio, basis, partial, t, n_frames, hop, m_rows, ldb, k_split);
}

__global__ void stft_frontend_reduce_kernel(const float* __restrict__ partial,
                                            float* __restrict__ out, int m_rows, int ldb,
                                            int n_out, int splits) {
  framed::reduce_splits(partial, out, m_rows, ldb, n_out, splits);
}

}  // namespace

// audio [batch, t] f32; basis [n_fft, ldb] f32 (ldb % 128 == 0, n_fft % (8 *
// splits) == 0); partial [splits, batch*n_frames, ldb] scratch; out [batch,
// n_frames, n_out]. Launches on `stream`; returns cudaGetLastError() of the
// launches.
extern "C" int stft_frontend_f32(const float* audio, const float* basis, float* partial,
                                 float* out, int batch, int t, int n_frames, int hop,
                                 int n_fft, int ldb, int n_out, int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m_rows = batch * n_frames;
  const int k_split = n_fft / splits;
  dim3 grid(ldb / BN, (m_rows + BM - 1) / BM, splits);
  stft_frontend_partial_kernel<<<grid, NT, 0, s>>>(audio, basis, partial, t, n_frames, hop,
                                                   m_rows, ldb, k_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int total = m_rows * n_out;
  stft_frontend_reduce_kernel<<<(total + 255) / 256, 256, 0, s>>>(partial, out, m_rows, ldb,
                                                                   n_out, splits);
  return static_cast<int>(cudaGetLastError());
}
