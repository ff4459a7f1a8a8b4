// CQT projection for Hopper (sm_90a), float32 on the CUDA cores.
//
// Replaces the TPU kernel sot_tpu/ops/pallas/cqt.py:_cqt_slab_kernel.
//
//   proj[b, f, n] = sum_{w < width} xpad[b, f*hop + w] * bank[w, n]
//
// A GEMM of M = batch*n_frames rows, K = width (32768) and N = 2*n_bins (570)
// whose A operand is the overlapping analysis windows. A is never
// materialised: each block reads its window rows straight from the padded
// signal (hop 256 against a 32768-sample window, so a frame matrix would be
// 128x the signal, the 64 MB gather the TPU kernel was written to avoid).
//
// Bound on the H100: operations. The function needs only the bank's non-zero
// support (14.1% of its entries): 2*M*nnz = 5.4 GFLOP per 64-clip request
// against ~22 MB, far above the FP32 ridge. This kernel computes the dense
// product, 2*M*K*N = 38.2 GFLOP against ~86 MB of operands (the bank is
// 74.7 MB in f32). The design is a plain shared-memory-tiled SIMT
// SGEMM (128x128 block tile, 8x8 outputs per thread, float4 shared loads laid
// out conflict-free), with split-K so that 8x5 output tiles still fill 132
// SMs. The splits write partial tiles to a scratch buffer and a second kernel
// sums them in a fixed order, so results are deterministic (no atomics). The
// tiles are csrc/framed_gemm.cuh's, which the STFT frontend (stft.cu) shares.
// Arithmetic is f32 with f32 accumulation, matching the reference's CPU path.
// Later work: TF32/bf16 tensor cores (needs a training verdict for bf16),
// and skipping the bank's zero support (only 14.1% of it is non-zero).

#include <cuda_runtime.h>
#include <stddef.h>

#include "framed_gemm.cuh"

namespace {

using framed::BK;
using framed::BM;
using framed::BN;
using framed::NT;

// The windows of the padded signal (no end mask: the caller pads).
__global__ void __launch_bounds__(NT)
cqt_partial_kernel(const float* __restrict__ xpad, const float* __restrict__ bank,
                   float* __restrict__ partial, int t_pad, int n_frames, int hop,
                   int m_rows, int ldb, int k_split) {
  framed::partial_tile<false>(xpad, bank, partial, t_pad, n_frames, hop, m_rows, ldb,
                              k_split);
}

// out[m, n] = sum over splits s = 0, 1, ... of partial[s, m, n], n < n_out.
__global__ void cqt_reduce_kernel(const float* __restrict__ partial, float* __restrict__ out,
                                  int m_rows, int ldb, int n_out, int splits) {
  framed::reduce_splits(partial, out, m_rows, ldb, n_out, splits);
}

}  // namespace

// xpad [batch, t_pad] f32; bank [width, ldb] f32 (ldb % 128 == 0, columns
// n_out..ldb-1 zero); partial [splits, batch*n_frames, ldb] scratch;
// out [batch, n_frames, n_out]. Launches on `stream`; returns
// cudaGetLastError() of the launches.
extern "C" int cqt_project_f32(const float* xpad, const float* bank, float* partial,
                               float* out, int batch, int t_pad, int n_frames, int hop,
                               int width, int ldb, int n_out, int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m_rows = batch * n_frames;
  const int k_split = width / splits;
  dim3 grid(ldb / BN, (m_rows + BM - 1) / BM, splits);
  cqt_partial_kernel<<<grid, NT, 0, s>>>(xpad, bank, partial, t_pad, n_frames, hop,
                                         m_rows, ldb, k_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int total = m_rows * n_out;
  cqt_reduce_kernel<<<(total + 255) / 256, 256, 0, s>>>(partial, out, m_rows, ldb, n_out,
                                                         splits);
  return static_cast<int>(cudaGetLastError());
}
