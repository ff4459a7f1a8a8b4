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
// sums them in a fixed order, so results are deterministic (no atomics).
// Arithmetic is f32 with f32 accumulation, matching the reference's CPU path.
// Later work: TF32/bf16 tensor cores (needs a training verdict for bf16),
// and skipping the bank's zero support (only 14.1% of it is non-zero).

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 8;
constexpr int NT = 256;

__global__ void __launch_bounds__(NT)
cqt_partial_kernel(const float* __restrict__ xpad, const float* __restrict__ bank,
                   float* __restrict__ partial, int t_pad, int n_frames, int hop,
                   int m_rows, int ldb, int k_split) {
  __shared__ __align__(16) float As[BK][BM];
  __shared__ __align__(16) float Bs[BK][BN];

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int k_begin = blockIdx.z * k_split;

  // A loader: one window row, four consecutive taps per thread.
  const int a_row = tid >> 1;
  const int a_k = (tid & 1) * 4;
  const int m = m0 + a_row;
  const bool a_ok = m < m_rows;
  const float* a_src = xpad;
  if (a_ok) {
    const int b = m / n_frames;
    const int f = m - b * n_frames;
    a_src = xpad + (size_t)b * t_pad + (size_t)f * hop;
  }
  // B loader: one bank row, one float4 per thread.
  const int b_k = tid >> 5;
  const int b_n = (tid & 31) * 4;
  const float* b_src = bank + n0 + b_n;

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
    for (int i = 0; i < 4; ++i) As[a_k + i][a_row] = a_ok ? a_src[k0 + a_k + i] : 0.f;
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

// out[m, n] = sum over splits s = 0, 1, ... of partial[s, m, n], n < n_out.
__global__ void cqt_reduce_kernel(const float* __restrict__ partial, float* __restrict__ out,
                                  int m_rows, int ldb, int n_out, int splits) {
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
