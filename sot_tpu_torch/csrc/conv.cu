// 'same' conv1d for the encoder's wide-kernel layers on Hopper (sm_90a):
// forward (kernel B10) and weight gradient (kernel B11), SIMT, NCW layout.
//
// Replaces the TPU kernels sot_tpu/ops/pallas/conv.py:_fwd_kernel (entry
// _conv_cmajor_fwd) and _dw_kernel (entry _conv_cmajor_dw).
//
//   y[b, co, w]   = sum_{ci, d} W[co, ci, d] x[b, ci, w + d - p]      (B10)
//   dW[co, ci, d] = sum_{b, w} dy[b, co, w] x[b, ci, w + d - p]       (B11)
//
// with p = (k - 1) / 2 and zeros outside [0, W). dx is B10 again on dy with the
// tap-flipped, (ci <-> co)-transposed weight, as the JAX package computes it.
// Both kernels read f32 and, with `round_bf16`, round every operand to bf16
// (nearest even) as they load it, as the TPU kernel casts inside the kernel;
// a product of two bf16 values is exact in f32 and the sums are f32.
//
// Design. The TPU kernel builds an im2col block with lane rolls and runs one
// MXU matmul per row tile. Here one block of B10 owns one row b, a group of
// CO_T output channels and a strip of bins: the row's input strip with its
// (k - 1)-bin halo and the group's weights sit in shared memory, and each
// thread computes one bin for the CO_T channels, reading each input value
// once per tap and the CO_T weights as broadcasts. B11 gives each thread one
// (co, ci) pair and its k taps: walking the bins of a row, it keeps the k
// input values of its window in registers, so each step reads one input and
// one dy value for k multiply-adds. Its blocks cover chunks of rows and
// write per-chunk partials, which a second kernel sums in a fixed order (the
// JAX package sums per-tile partials in XLA): deterministic, no atomics.
//
// Bound on the H100: at the prefilter's shape (1024 rows, 40 -> 40 channels,
// 285 bins, k = 15) each is 14.0 GFLOP; in f32 on the CUDA cores that is
// 0.209 ms, and the bytes (~93 MB read and written at f32) bound a bf16
// tensor-core version at ~0.028 ms. These SIMT kernels are a first, simple
// version; tensor cores (wgmma) are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int NT_DW = 256;   // threads of a B11 block: (co, ci) pairs

__device__ __forceinline__ float load_op(const float* p, bool round_bf16) {
  const float v = *p;
  return round_bf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

// B10: grid (rows, ceil(cout / CO_T), strips), blockDim = strip width.
// Shared: xs [cin][sw + k - 1] (the strip and its halo), ws [cin][k][CO_T].
template <int CO_T, int K>
__global__ void conv_fwd_kernel(const float* __restrict__ x, const float* __restrict__ wt,
                                float* __restrict__ y, int cin, int cout, int width,
                                int round_bf16) {
  extern __shared__ float smem[];
  const int sw = blockDim.x;
  const int span = sw + K - 1;
  float* xs = smem;               // [cin][span]
  float* ws = xs + cin * span;    // [cin][K][CO_T]
  constexpr int P = (K - 1) / 2;

  const int b = blockIdx.x;
  const int co0 = blockIdx.y * CO_T;
  const int w0 = blockIdx.z * sw;
  const bool rnd = round_bf16 != 0;
  const float* xb = x + (size_t)b * cin * width;

  for (int i = threadIdx.x; i < cin * span; i += sw) {
    const int ci = i / span;
    const int w = w0 + (i - ci * span) - P;
    xs[i] = (w >= 0 && w < width) ? load_op(xb + (size_t)ci * width + w, rnd) : 0.f;
  }
  for (int i = threadIdx.x; i < cin * K * CO_T; i += sw) {
    const int c = i % CO_T;
    const int cd = i / CO_T;  // ci * K + d
    const int co = co0 + c;
    ws[i] = co < cout ? load_op(wt + (size_t)co * cin * K + cd, rnd) : 0.f;
  }
  __syncthreads();

  const int w = w0 + threadIdx.x;
  if (w >= width) return;
  float acc[CO_T];
#pragma unroll
  for (int c = 0; c < CO_T; ++c) acc[c] = 0.f;
  for (int ci = 0; ci < cin; ++ci) {
    const float* xr = xs + ci * span + threadIdx.x;
    const float* wr = ws + ci * K * CO_T;
#pragma unroll
    for (int d = 0; d < K; ++d) {
      const float xv = xr[d];
#pragma unroll
      for (int c = 0; c < CO_T; ++c) acc[c] = fmaf(wr[d * CO_T + c], xv, acc[c]);
    }
  }
  float* yb = y + (size_t)b * cout * width + w;
#pragma unroll
  for (int c = 0; c < CO_T; ++c)
    if (co0 + c < cout) yb[(size_t)(co0 + c) * width] = acc[c];
}

// B11 partials: grid (ceil(cout * cin / NT_DW), chunks). Each thread owns the
// pair (co, ci) = divmod(pair, cin) and its K taps over the chunk's rows.
// Shared per row: xs [cin][width + K] (zero halo, and one zero more for the
// window's last refill), dys [cout][width].
template <int K>
__global__ void __launch_bounds__(NT_DW)
conv_dw_partial_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                       float* __restrict__ partial, int rows, int cin, int cout, int width,
                       int rows_per_chunk, int round_bf16) {
  extern __shared__ float smem[];
  constexpr int P = (K - 1) / 2;
  const int span = width + K;
  float* xs = smem;              // [cin][span]
  float* dys = xs + cin * span;  // [cout][width]
  const bool rnd = round_bf16 != 0;

  const int pair = blockIdx.x * NT_DW + threadIdx.x;
  const bool live = pair < cout * cin;
  const int co = live ? pair / cin : 0;
  const int ci = live ? pair - co * cin : 0;
  const int r0 = blockIdx.y * rows_per_chunk;
  const int r1 = min(r0 + rows_per_chunk, rows);

  float acc[K];
#pragma unroll
  for (int d = 0; d < K; ++d) acc[d] = 0.f;

  for (int r = r0; r < r1; ++r) {
    __syncthreads();  // the previous row's reads are done
    const float* xr = x + (size_t)r * cin * width;
    const float* dr = dy + (size_t)r * cout * width;
    for (int i = threadIdx.x; i < cin * span; i += NT_DW) {
      const int c = i / span;
      const int w = i - c * span - P;
      xs[i] = (w >= 0 && w < width) ? load_op(xr + (size_t)c * width + w, rnd) : 0.f;
    }
    for (int i = threadIdx.x; i < cout * width; i += NT_DW) dys[i] = load_op(dr + i, rnd);
    __syncthreads();
    if (!live) continue;

    // win[d] = x[ci, w + d - p] for the current bin w
    const float* xc = xs + ci * span;
    const float* dc = dys + co * width;
    float win[K];
#pragma unroll
    for (int d = 0; d < K; ++d) win[d] = xc[d];
    for (int w = 0; w < width; ++w) {
      const float g = dc[w];
#pragma unroll
      for (int d = 0; d < K; ++d) acc[d] = fmaf(g, win[d], acc[d]);
#pragma unroll
      for (int d = 0; d < K - 1; ++d) win[d] = win[d + 1];
      win[K - 1] = xc[w + K];  // at w = width - 1 the extra zero, not used
    }
  }
  if (!live) return;
  float* out = partial + (size_t)blockIdx.y * cout * cin * K + ((size_t)co * cin + ci) * K;
#pragma unroll
  for (int d = 0; d < K; ++d) out[d] = acc[d];
}

// dW[i] = sum over chunks s = 0, 1, ... of partial[s, i].
__global__ void conv_dw_reduce_kernel(const float* __restrict__ partial, float* __restrict__ dw,
                                      int n, int chunks) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float acc = 0.f;
  for (int s = 0; s < chunks; ++s) acc += partial[(size_t)s * n + i];
  dw[i] = acc;
}

int set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

template <int CO_T, int K>
int launch_fwd(const float* x, const float* wt, float* y, int rows, int cin, int cout,
               int width, int strip, int round_bf16, cudaStream_t s) {
  const size_t shmem = ((size_t)cin * (strip + K - 1) + (size_t)cin * K * CO_T) * sizeof(float);
  const int e = set_smem(reinterpret_cast<const void*>(conv_fwd_kernel<CO_T, K>), shmem);
  if (e) return e;
  dim3 grid(rows, (cout + CO_T - 1) / CO_T, (width + strip - 1) / strip);
  conv_fwd_kernel<CO_T, K><<<grid, strip, shmem, s>>>(x, wt, y, cin, cout, width, round_bf16);
  return static_cast<int>(cudaGetLastError());
}

template <int K>
int launch_dw(const float* x, const float* dy, float* partial, float* dw, int rows, int cin,
              int cout, int width, int rows_per_chunk, int round_bf16, cudaStream_t s) {
  const size_t shmem = ((size_t)cin * (width + K) + (size_t)cout * width) * sizeof(float);
  int e = set_smem(reinterpret_cast<const void*>(conv_dw_partial_kernel<K>), shmem);
  if (e) return e;
  const int chunks = (rows + rows_per_chunk - 1) / rows_per_chunk;
  dim3 grid((cout * cin + NT_DW - 1) / NT_DW, chunks);
  conv_dw_partial_kernel<K><<<grid, NT_DW, shmem, s>>>(x, dy, partial, rows, cin, cout, width,
                                                      rows_per_chunk, round_bf16);
  e = static_cast<int>(cudaGetLastError());
  if (e) return e;
  const int n = cout * cin * K;
  conv_dw_reduce_kernel<<<(n + 255) / 256, 256, 0, s>>>(partial, dw, n, chunks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define CONV_KS(X) X(1) X(3) X(5) X(7) X(9) X(11) X(13) X(15)

// x [rows, cin, width], wt [cout, cin, k], y [rows, cout, width], all f32
// contiguous; k odd, 1 <= k <= 15; strip = threads per block (a multiple of
// 32, <= 1024), covering the bins in ceil(width / strip) strips. Returns
// cudaGetLastError() of the launch.
extern "C" int conv1d_same_fwd_f32(const float* x, const float* wt, float* y, int rows, int cin,
                                   int cout, int width, int k, int strip, int round_bf16,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wide = cout >= 8;
#define CONV_FWD_CASE(KK)                                                                    \
  case KK:                                                                                   \
    return wide ? launch_fwd<8, KK>(x, wt, y, rows, cin, cout, width, strip, round_bf16, s)  \
                : launch_fwd<1, KK>(x, wt, y, rows, cin, cout, width, strip, round_bf16, s);
  switch (k) {
    CONV_KS(CONV_FWD_CASE)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef CONV_FWD_CASE
}

// x [rows, cin, width], dy [rows, cout, width], dw [cout, cin, k], all f32
// contiguous; partial [ceil(rows / rows_per_chunk), cout * cin * k] scratch.
// Returns cudaGetLastError() of the launches.
extern "C" int conv1d_same_dw_f32(const float* x, const float* dy, float* partial, float* dw,
                                  int rows, int cin, int cout, int width, int k,
                                  int rows_per_chunk, int round_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CONV_DW_CASE(KK) \
  case KK:               \
    return launch_dw<KK>(x, dy, partial, dw, rows, cin, cout, width, rows_per_chunk, round_bf16, s);
  switch (k) {
    CONV_KS(CONV_DW_CASE)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef CONV_DW_CASE
}
