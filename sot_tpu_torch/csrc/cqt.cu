// CQT projection for Hopper (sm_90a): the bank's non-zero support only, on
// the tensor cores at f32 accuracy (3xTF32).
//
// Replaces the TPU kernel sot_tpu/ops/pallas/cqt.py:_cqt_slab_kernel.
//
//   proj[b, f, n] = sum_{w < width} xpad[b, f*hop + w] * bank[w, n]
//
// A GEMM of M = batch*n_frames rows (the overlapping analysis windows), K =
// width (32768) and N = 2*n_bins (570) columns. Each bin's kernel is non-zero
// on one centred interval only (14.1% of the bank at SOT-2048), so the dense
// product (38.2 GFLOP per 64-clip request) is mostly zeros: 2*M*nnz = 5.4
// GFLOP.
//
// Bound on the H100: operations, 5.4 GFLOP at the 3xTF32 rate (495 / 3
// TFLOP/s), ~0.033 ms.
//
// Design.
//  * The tile plan (ops/kernels/cqt.py, built once per bank and device)
//    permutes the columns so that each tile of BN = 64 columns holds 32
//    bins in frequency order, re then im, reads each tile's K range [lo, hi)
//    from the bank's non-zero entries, and packs those rows of the tile's
//    columns contiguously, pre-split into TF32 high and low parts. It cuts
//    every (row tile, column tile) into work units of at most a fixed number
//    of taps, chosen so that the units fill the SMs: one block per unit.
//  * A (BM rows x BK taps) is read straight from the padded signal (no frame
//    matrix: hop 256 against a 32768-tap window would make it 128x the
//    signal), 4-byte cp.async per element because a row starts at any
//    sample, rows past M zero-filled; B (BK x BN, high and low) with 16-byte
//    cp.async. A STAGES-deep ring of shared-memory tiles, padded so that the
//    fragment loads hit 32 distinct banks.
//  * 8 warps, each a 32x32 output tile of mma.sync m16n8k8 .tf32. A is split
//    as it is read from shared memory: hi = a with its low 13 bits cleared,
//    lo = a - hi (exact), of which the tensor core reads the TF32 part (it
//    ignores an operand's low 13 bits); two integer/f32 operations, no
//    quarter-rate conversions. Each output takes lo*hi + hi*lo + hi*hi of a
//    stage (32 taps, 12 tensor-core products) into a zeroed fragment, which
//    is added to the f32 accumulator with an ordinary f32 add: the long sum
//    over K is rounded to nearest on the CUDA cores. The tensor core's own
//    accumulation is not f32's: run over a whole unit it is far less
//    accurate than the plain f32 product. The dropped lo*lo term and the
//    splits cost ~2^-21 of each product, an order below the f32 rounding of
//    the sums: f32 accuracy.
//  * Each unit writes its partial tile to a scratch of [units, BM, BN]; a
//    second kernel sums each output's units in their fixed order (no
//    atomics: deterministic) and undoes the column permutation.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;        // frames per block tile
constexpr int BN = 64;         // permuted columns per tile: 32 bins, re | im
constexpr int BK = 32;         // taps per pipeline stage
constexpr int STAGES = 3;
constexpr int NT = 256;        // 8 warps: 4 along the rows x 2 along the columns
constexpr int A_LD = BK + 4;   // fragment loads (4 g + t) hit 32 distinct banks
constexpr int B_LD = BN + 8;   // fragment loads (8 t + g) hit 32 distinct banks
constexpr int A_STAGE = BM * A_LD;
constexpr int B_STAGE = BK * B_LD;
constexpr int SMEM_BYTES = STAGES * (A_STAGE + 2 * B_STAGE) * 4 + BM * 4;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4 bytes, zero-filled when !valid (src is then not read)
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One work unit: rows [m0, m0 + BM) x one column tile x taps [k0, k0 +
// BK*steps), whose packed bank rows start at brow. unit = {m0, k0, steps, brow}.
__global__ void __launch_bounds__(NT, 2)
cqt_tile_kernel(const float* __restrict__ xpad, const float* __restrict__ b_hi,
                const float* __restrict__ b_lo, const int4* __restrict__ units,
                float* __restrict__ partial, int t_pad, int n_frames, int hop, int m_rows) {
  extern __shared__ __align__(16) float smem[];
  float* As = smem;                          // [STAGES][BM][A_LD]
  float* Bh = As + STAGES * A_STAGE;         // [STAGES][BK][B_LD]
  float* Bl = Bh + STAGES * B_STAGE;
  int* row_off = reinterpret_cast<int*>(Bl + STAGES * B_STAGE);  // [BM], -1 past M

  const int4 u = units[blockIdx.x];
  const int m0 = u.x, k0 = u.y, steps = u.z, brow0 = u.w;
  const int tid = threadIdx.x;
  if (tid < BM) {
    const int m = m0 + tid;
    int off = -1;
    if (m < m_rows) {
      const int b = m / n_frames;
      off = b * t_pad + (m - b * n_frames) * hop;
    }
    row_off[tid] = off;
  }
  __syncthreads();

  auto load_stage = [&](int stage, int step) {
    const int k = k0 + step * BK + (tid & 31);
    float* as = As + stage * A_STAGE + (tid & 31);
#pragma unroll
    for (int i = 0; i < BM / 8; ++i) {  // a warp reads 32 consecutive taps of one row
      const int r = (tid >> 5) + 8 * i;
      const int off = row_off[r];
      cp_async4(as + r * A_LD, xpad + (off < 0 ? 0 : off + k), off >= 0);
    }
    const int brow = brow0 + step * BK;
    float* bh = Bh + stage * B_STAGE;
    float* bl = Bl + stage * B_STAGE;
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // BK x BN floats = 512 chunks of 16 bytes
      const int c = tid + NT * i;
      const int kr = c >> 4, n4 = (c & 15) * 4;
      const size_t src = (size_t)(brow + kr) * BN + n4;
      cp_async16(bh + kr * B_LD + n4, b_hi + src);
      cp_async16(bl + kr * B_LD + n4, b_lo + src);
    }
  };

  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp & 3) * 32, wn = (warp >> 2) * 32;

  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load_stage(s, s);
    cp_async_commit();
  }

  for (int step = 0; step < steps; ++step) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int next = step + STAGES - 1;
    if (next < steps) load_stage(next % STAGES, next);
    cp_async_commit();

    const int stage = step % STAGES;
    const float* as = As + stage * A_STAGE;
    const float* bh = Bh + stage * B_STAGE;
    const float* bl = Bl + stage * B_STAGE;
    float part[2][4][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int q = 0; q < 4; ++q) part[mi][ni][q] = 0.f;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      // A fragments: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
      uint32_t ahi[2][4], alo[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float a = as[(wm + mi * 16 + g + (q & 1) * 8) * A_LD + kk + t + (q >> 1) * 4];
          ahi[mi][q] = __float_as_uint(a) & 0xffffe000u;
          alo[mi][q] = __float_as_uint(a - __uint_as_float(ahi[mi][q]));
        }
      // B fragments: b0 (k = t, n = g), b1 (k = t + 4, n = g)
      uint32_t bhi[4][2], blo[4][2];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int idx = (kk + t + q * 4) * B_LD + wn + ni * 8 + g;
          bhi[ni][q] = __float_as_uint(bh[idx]);
          blo[ni][q] = __float_as_uint(bl[idx]);
        }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          mma_tf32(part[mi][ni], alo[mi], bhi[ni][0], bhi[ni][1]);
          mma_tf32(part[mi][ni], ahi[mi], blo[ni][0], blo[ni][1]);
          mma_tf32(part[mi][ni], ahi[mi], bhi[ni][0], bhi[ni][1]);
        }
    }
    // the stage's sums join the running sums in an f32 add (rounded to nearest)
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mi][ni][q] += part[mi][ni][q];
  }
  cp_async_wait<0>();

  // C fragments: c0, c1 (g, 2t, 2t + 1), c2, c3 (g + 8, 2t, 2t + 1)
  float* dst = partial + (size_t)blockIdx.x * BM * BN;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int row = wm + mi * 16 + g, col = wn + ni * 8 + 2 * t;
      *reinterpret_cast<float2*>(dst + row * BN + col) =
          make_float2(acc[mi][ni][0], acc[mi][ni][1]);
      *reinterpret_cast<float2*>(dst + (row + 8) * BN + col) =
          make_float2(acc[mi][ni][2], acc[mi][ni][3]);
    }
}

// out[m, c] = sum over the units i = 0, 1, ... of (row tile of m, column
// tile of c) of their partial at (m, c's permuted column), in unit order.
// spans[rt * n_col_tiles + ct] = {first unit, count}; col_of_out[c] = the
// permuted column of output column c.
__global__ void cqt_reduce_kernel(const float* __restrict__ partial,
                                  const int2* __restrict__ spans,
                                  const int* __restrict__ col_of_out, float* __restrict__ out,
                                  int m_rows, int n_out, int n_col_tiles) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= m_rows * n_out) return;
  const int m = idx / n_out;
  const int p = col_of_out[idx - m * n_out];
  const int rt = m / BM;
  const int2 s = spans[rt * n_col_tiles + p / BN];
  const float* src = partial + ((size_t)s.x * BM + (m - rt * BM)) * BN + p % BN;
  float acc = 0.f;
  for (int i = 0; i < s.y; ++i) acc += src[(size_t)i * BM * BN];
  out[idx] = acc;
}

}  // namespace

// xpad [batch, t_pad] f32; b_hi, b_lo [packed rows, 64] f32 (16-byte
// aligned); units [n_units] int4; spans [row tiles x n_col_tiles] int2;
// col_of_out [n_out] int; partial [n_units, 128, 64] f32 scratch; out
// [batch*n_frames, n_out]. Launches on `stream`; returns cudaGetLastError()
// of the launches.
extern "C" int cqt_project_tf32x3(const float* xpad, const float* b_hi, const float* b_lo,
                                  const int* units, int n_units, const int* spans,
                                  const int* col_of_out, float* partial, float* out,
                                  int t_pad, int n_frames, int hop, int m_rows, int n_out,
                                  int n_col_tiles, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(cqt_tile_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_units > 0) {
    cqt_tile_kernel<<<n_units, NT, SMEM_BYTES, s>>>(xpad, b_hi, b_lo,
                                                    reinterpret_cast<const int4*>(units),
                                                    partial, t_pad, n_frames, hop, m_rows);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int total = m_rows * n_out;
  cqt_reduce_kernel<<<(total + 255) / 256, 256, 0, s>>>(
      partial, reinterpret_cast<const int2*>(spans), col_of_out, out, m_rows, n_out,
      n_col_tiles);
  return static_cast<int>(cudaGetLastError());
}
