// 'same' conv1d for the encoder's wide-kernel layers on Hopper (sm_90a):
// forward (kernel B10) and weight gradient (kernel B11) as implicit GEMMs on
// the tensor cores, NCW layout.
//
// Replaces the TPU kernels sot_tpu/ops/pallas/conv.py:_fwd_kernel (entry
// _conv_cmajor_fwd) and _dw_kernel (entry _conv_cmajor_dw).
//
//   y[b, co, w]   = sum_{ci, d} W[co, ci, d] x[b, ci, w + d - p]      (B10)
//   dW[co, ci, d] = sum_{b, w} dy[b, co, w] x[b, ci, w + d - p]       (B11)
//
// with p = (k - 1) / 2 and zeros outside [0, W). dx is B10 again on dy with the
// tap-flipped, (ci <-> co)-transposed weight, as the JAX package computes it.
// Both kernels read f32. With `round_bf16` every operand is rounded to bf16
// (nearest even) as it is staged, as the TPU kernel casts inside the kernel,
// and the products run on bf16 mma.sync m16n8k16 (a product of two bf16 values
// is exact in f32). Without it they run on TF32 mma.sync m16n8k8 with the
// 3xTF32 split (hi = v rounded to TF32, lo = v - hi rounded to TF32, and
// lo*hi + hi*lo + hi*hi; the dropped lo*lo and the roundings cost at most
// 2^-21 of a product): f32 accuracy, as kernel 1 (csrc/cqt.cu) computes it.
// The split rounds both parts to nearest: kernel 1's cleared bits (hi
// truncated, lo read truncated by the tensor core) cost up to 2^-20 of a
// product, which shows against float64 on a sum of 15 products (C_in = 1).
//
// Bound on the H100: at the prefilter's shape (1024 rows, 40 -> 40 channels,
// 285 bins, k = 15) each is 14.0 GFLOP: 0.014 ms on the bf16 tensor cores,
// 0.085 ms at the 3xTF32 rate, under the bytes (x and y or dy read or written
// once in f32, ~93 MB: 0.028 ms).
//
// Design. Each channel's k <= 15 taps are padded to TAPS = 16 with zero
// weights, so that one channel is one k16 step (bf16) or two k8 steps (TF32).
//  * B10: M = the bins of a row, N = C_out padded to n8 tiles, K = C_in x 16.
//    Persistent blocks (one per SM) walk over (row, strip of STRIP bins)
//    items. A block stages the weights once, in fragment order, and each
//    item's input strip with its halo arrives by 4-byte cp.async (a row
//    starts at any element) while the block computes the previous item. The
//    input operand is a Hankel matrix, A[m][d] = x[w0 + m + d - p]: staged as
//    bf16 pair words P[j] = (x[j], x[j+1]) every fragment register is one
//    aligned 32-bit load, whatever the parity of m + d, and the second and
//    third registers of a fragment are the same word. 9 warps each own two m16
//    tiles and every n8 tile. The output tile goes through shared memory so
//    that the stores along w are coalesced.
//  * B11: M = C_in x 16 (one m16 tile per input channel: its taps), N = C_out
//    padded to n8 tiles, K = the bins of every row. Split K: block s sums the
//    rows of chunk s (rows_per_chunk from the row count and the SM count),
//    keeps its [C_in x 16, C_out] partial in registers (8 warps, each 5 input
//    channels x every n8 tile) and writes it to a scratch; a second kernel
//    sums the chunks in a fixed order (deterministic, no atomics). x and dy
//    arrive as in B10, each row once per block; dy is staged in bf16 pairs
//    along w (rows padded so the pairs are aligned), x as the same Hankel
//    pair words.
//  * Accumulation: the tensor core's own accumulation is not f32's, so a
//    stage of products is computed into a zeroed fragment and added to the
//    f32 accumulators on the CUDA cores: in bf16 FWD_CH = 8 channels (B10,
//    128 products) or DW_STEPS = 6 k16 steps of bins (B11, 96), in 3xTF32
//    one channel (B10) or one k16 step (B11). Larger bf16 stages cost fewer
//    f32 adds; on the H100 the whole sum on the tensor core (40 channels / 18
//    steps) read above the plain f32 version's error against float64, 8 / 6
//    well below it (PERF.md, Findings). No atomics anywhere: two launches on the
//    same inputs are bit-equal.
//  * Shapes: odd k <= 15, 1 <= C_in, C_out <= MAX_CH, any width and row count.
//    The zero taps multiply real input values, so a non-finite input also
//    reaches the outputs within one tap of it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int TAPS = 16;               // taps per channel: k <= 15 and zero taps
constexpr int STRIP = 288;             // bins per work item: 18 m16 tiles
constexpr int SPAN = STRIP + TAPS;     // a strip's input with its halo
constexpr int MAX_CH = 40;
constexpr int FWD_WARPS = STRIP / 32;  // two m16 tiles each
constexpr int FWD_NT = FWD_WARPS * 32;
constexpr int DW_WARPS = 8;
constexpr int DW_NT = DW_WARPS * 32;
constexpr int DW_CI = MAX_CH / DW_WARPS;  // input channels (m16 tiles) per warp
constexpr int STAGE_LD = STRIP + 4;    // f32 rows read/written by fragments:
constexpr int DY_LD = STRIP + 4;       //   = 4 mod 32, so 8 g x 4 t hit 32 banks
constexpr int DYH_LD = 164;            // bf16 dy rows in pair words, = 4 mod 32
constexpr int FWD_CH = 8;              // bf16 channels per tensor-core stage (B10)
constexpr int DW_STEPS = 6;            // bf16 k16 steps of bins per stage (B11)

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4 bytes, zero-filled when !valid (src is then not read)
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// d += A B on bf16 m16n8k16 (f32 accumulator)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += A B on TF32 m16n8k8 (the tensor core reads each operand's TF32 part)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 values rounded to bf16 (nearest even), `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// f32 bits rounded to TF32 (10 explicit mantissa bits), to nearest with ties
// away from zero (cvt.rna.tf32.f32 in two integer operations)
__device__ __forceinline__ uint32_t tf32_rna(uint32_t bits) { return (bits + 0x1000u) & 0xffffe000u; }

// hi = tf32(v), lo = tf32(v - hi): hi + lo = v to 2^-23 relative
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(__float_as_uint(v));
  lo = tf32_rna(__float_as_uint(v - __uint_as_float(hi)));
}

// lo*hi + hi*lo + hi*hi of one k8 step into d
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ahi)[4],
                                           const uint32_t (&alo)[4], uint32_t bh0, uint32_t bh1,
                                           uint32_t bl0, uint32_t bl1) {
  mma_tf32(d, alo, bh0, bh1);
  mma_tf32(d, ahi, bl0, bl1);
  mma_tf32(d, ahi, bh0, bh1);
}

// The Hankel operand's A fragments of one m16 tile from a staged row `xr`
// (f32 values, the tile's base and the lane's g + t added): offsets 0, 4, 8,
// 12, 16, 20 split once; k8 step 0 is {0, 8, 4, 12}, step 1 {8, 16, 12, 20}.
__device__ __forceinline__ void hankel_tf32(const float* xr, uint32_t (&h0)[4], uint32_t (&l0)[4],
                                            uint32_t (&h1)[4], uint32_t (&l1)[4]) {
  uint32_t h[6], l[6];
#pragma unroll
  for (int o = 0; o < 6; ++o) split_tf32(xr[4 * o], h[o], l[o]);
  h0[0] = h[0]; h0[1] = h[2]; h0[2] = h[1]; h0[3] = h[3];
  l0[0] = l[0]; l0[1] = l[2]; l0[2] = l[1]; l0[3] = l[3];
  h1[0] = h[2]; h1[1] = h[4]; h1[2] = h[3]; h1[3] = h[5];
  l1[0] = l[2]; l1[1] = l[4]; l1[2] = l[3]; l1[3] = l[5];
}

// The same fragments in bf16 from pair words `pr` (base + g + 2t added):
// A[g][2t..], A[g+8][2t..], A[g][2t+8..], A[g+8][2t+8..].
__device__ __forceinline__ void hankel_bf16(const uint32_t* pr, uint32_t (&a)[4]) {
  a[0] = pr[0];
  a[1] = pr[8];
  a[2] = a[1];
  a[3] = pr[16];
}

// Stage one row's strip [w0 - pad, w0 - pad + SPAN) of every input channel
// into raw [cin][SPAN], zeros outside [0, width).
__device__ __forceinline__ void load_x_strip(float* raw, const float* xb, int cin, int width,
                                             int start, int tid, int nthreads) {
  for (int i = tid; i < cin * SPAN; i += nthreads) {
    const int ci = i / SPAN;
    const int w = start + (i - ci * SPAN);
    const bool ok = w >= 0 && w < width;
    cp_async4(raw + i, xb + (size_t)ci * width + (ok ? w : 0), ok);
  }
}

// raw [n][SPAN] f32 -> pair words [n][SPAN]: (x[j], x[j + 1]), the row's last
// paired with 0.
__device__ __forceinline__ void to_pairs(uint32_t* pw, const float* raw, int n, int tid,
                                         int nthreads) {
  for (int i = tid; i < n * SPAN; i += nthreads) {
    const int j = i % SPAN;
    pw[i] = pack_bf16(raw[i], j + 1 < SPAN ? raw[i + 1] : 0.f);
  }
}

__device__ __forceinline__ void copy4(float* dst, const float* src, int n, int tid,
                                      int nthreads) {
  for (int i = tid; i < n / 4; i += nthreads)
    reinterpret_cast<float4*>(dst)[i] = reinterpret_cast<const float4*>(src)[i];
}

// B10. Shared: the weights in fragment order (bf16: uint2 [cin][NT][32];
// f32: float4 [cin][NT][32]), raw [cin][SPAN] (cp.async target), work: the
// item's operand [cin][SPAN] (pair words or f32), then its output stage
// [NT * 8][STAGE_LD].
template <int NT, bool BF16>
__global__ void __launch_bounds__(FWD_NT, 1)
conv_fwd_mma_kernel(const float* __restrict__ x, const float* __restrict__ wt,
                    float* __restrict__ y, int rows, int cin, int cout, int width, int k,
                    int n_strips) {
  extern __shared__ __align__(16) float smem[];
  const int w_words = cin * NT * 32 * (BF16 ? 2 : 4);
  float* raw = smem + w_words;
  float* work = raw + cin * SPAN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int pad = (k - 1) / 2;
  const int n_items = rows * n_strips;

  auto load_item = [&](int item) {
    const int b = item / n_strips;
    const int w0 = (item - b * n_strips) * STRIP;
    load_x_strip(raw, x + (size_t)b * cin * width, cin, width, w0 - pad, tid, FWD_NT);
  };
  if (blockIdx.x < n_items) load_item(blockIdx.x);
  cp_async_commit();

  // the weights, once per block: W[co][ci][d] as B[k = d][n = co], zero for
  // co >= cout or d >= k
  auto wval = [&](int co, int ci, int d) {
    return co < cout && d < k ? wt[((size_t)co * cin + ci) * k + d] : 0.f;
  };
  for (int i = tid; i < cin * NT * 32; i += FWD_NT) {
    const int l = i & 31, cj = i >> 5;
    const int ci = cj / NT, co = 8 * (cj - ci * NT) + (l >> 2);
    if (BF16) {
      const int d = 2 * (l & 3);  // b0 b1 = taps 2t, 2t + 1; b2 b3 = 2t + 8, 2t + 9
      reinterpret_cast<uint2*>(smem)[i] =
          make_uint2(pack_bf16(wval(co, ci, d), wval(co, ci, d + 1)),
                     pack_bf16(wval(co, ci, d + 8), wval(co, ci, d + 9)));
    } else {
      const int d = l & 3;  // b0 b1 of k8 step 0 = taps t, t + 4; of step 1 t + 8, t + 12
      reinterpret_cast<float4*>(smem)[i] =
          make_float4(wval(co, ci, d), wval(co, ci, d + 4), wval(co, ci, d + 8),
                      wval(co, ci, d + 12));
    }
  }

  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    cp_async_wait_all();
    __syncthreads();  // raw holds this item; the last item's stage is stored
    if (BF16)
      to_pairs(reinterpret_cast<uint32_t*>(work), raw, cin, tid, FWD_NT);
    else
      copy4(work, raw, cin * SPAN, tid, FWD_NT);
    __syncthreads();
    if (item + gridDim.x < n_items) load_item(item + gridDim.x);
    cp_async_commit();

    const int b = item / n_strips;
    const int w0 = (item - b * n_strips) * STRIP;
    const int nbins = min(STRIP, width - w0);
    const int mb = warp * 32;  // this warp's m16 tiles: bins mb and mb + 16
    const bool live = mb < nbins;
    float acc[2][NT][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mt][j][q] = 0.f;

    if (live) {
      if (BF16) {
        for (int c0 = 0; c0 < cin; c0 += FWD_CH) {
          float d[2][NT][4];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int j = 0; j < NT; ++j)
#pragma unroll
              for (int q = 0; q < 4; ++q) d[mt][j][q] = 0.f;
          const int c1 = min(c0 + FWD_CH, cin);
          for (int ci = c0; ci < c1; ++ci) {
            const uint32_t* pr =
                reinterpret_cast<const uint32_t*>(work) + ci * SPAN + mb + g + 2 * t;
            uint32_t a[2][4];
            hankel_bf16(pr, a[0]);
            hankel_bf16(pr + 16, a[1]);
            const uint2* wf = reinterpret_cast<const uint2*>(smem) + ci * NT * 32 + lane;
#pragma unroll
            for (int j = 0; j < NT; ++j) {
              const uint2 bw = wf[j * 32];
#pragma unroll
              for (int mt = 0; mt < 2; ++mt) mma_bf16(d[mt][j], a[mt], bw.x, bw.y);
            }
          }
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int j = 0; j < NT; ++j)
#pragma unroll
              for (int q = 0; q < 4; ++q) acc[mt][j][q] += d[mt][j][q];
        }
      } else {
        for (int ci = 0; ci < cin; ++ci) {
          const float* xr = work + ci * SPAN + mb + g + t;
          uint32_t h0[2][4], l0[2][4], h1[2][4], l1[2][4];
          hankel_tf32(xr, h0[0], l0[0], h1[0], l1[0]);
          hankel_tf32(xr + 16, h0[1], l0[1], h1[1], l1[1]);
          const float4* wf = reinterpret_cast<const float4*>(smem) + ci * NT * 32 + lane;
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const float4 bw = wf[j * 32];
            uint32_t bh[4], bl[4];
            split_tf32(bw.x, bh[0], bl[0]);
            split_tf32(bw.y, bh[1], bl[1]);
            split_tf32(bw.z, bh[2], bl[2]);
            split_tf32(bw.w, bh[3], bl[3]);
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              float d[4] = {0.f, 0.f, 0.f, 0.f};
              mma_3xtf32(d, h0[mt], l0[mt], bh[0], bh[1], bl[0], bl[1]);
              mma_3xtf32(d, h1[mt], l1[mt], bh[2], bh[3], bl[2], bl[3]);
#pragma unroll
              for (int q = 0; q < 4; ++q) acc[mt][j][q] += d[q];
            }
          }
        }
      }
    }

    __syncthreads();  // every warp is done with the operand: work becomes the stage
    if (live) {
      // C fragments: c0 c1 (bin g, co 2t, 2t + 1), c2 c3 (bin g + 8)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            work[(8 * j + 2 * t + (q & 1)) * STAGE_LD + mb + 16 * mt + g + 8 * (q >> 1)] =
                acc[mt][j][q];
    }
    __syncthreads();
    float* yb = y + (size_t)b * cout * width + w0;
    for (int co = warp; co < cout; co += FWD_WARPS)
      for (int m = lane; m < nbins; m += 32) yb[(size_t)co * width + m] = work[co * STAGE_LD + m];
  }
  cp_async_wait_all();
}

// B11 partials: block s sums rows [s * rows_per_chunk, ...) into
// partial[s] [cout][cin][k]. Shared: raw x [cin][SPAN] and raw dy [NT * 8][STRIP]
// (cp.async targets), work x [cin][SPAN] (pair words or f32) and work dy
// (bf16 pair words [NT * 8][DYH_LD] or f32 [NT * 8][DY_LD]).
template <int NT, bool BF16>
__global__ void __launch_bounds__(DW_NT, 1)
conv_dw_mma_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                   float* __restrict__ partial, int rows, int cin, int cout, int width, int k,
                   int n_strips, int rows_per_chunk) {
  extern __shared__ __align__(16) float smem[];
  float* raw_x = smem;
  float* raw_dy = raw_x + cin * SPAN;
  float* work_x = raw_dy + NT * 8 * STRIP;
  float* work_dy = work_x + cin * SPAN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int pad = (k - 1) / 2;
  const int r0 = blockIdx.x * rows_per_chunk;
  const int n_items = min(rows_per_chunk, rows - r0) * n_strips;

  auto load_item = [&](int item) {
    const int b = r0 + item / n_strips;
    const int w0 = (item % n_strips) * STRIP;
    load_x_strip(raw_x, x + (size_t)b * cin * width, cin, width, w0 - pad, tid, DW_NT);
    const float* db = dy + (size_t)b * cout * width;
    for (int i = tid; i < NT * 8 * STRIP; i += DW_NT) {
      const int co = i / STRIP;
      const int w = w0 + (i - co * STRIP);
      const bool ok = co < cout && w < width;
      cp_async4(raw_dy + i, db + (ok ? (size_t)co * width + w : 0), ok);
    }
  };
  load_item(0);
  cp_async_commit();

  float acc[DW_CI][NT][4];
#pragma unroll
  for (int i = 0; i < DW_CI; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  for (int item = 0; item < n_items; ++item) {
    cp_async_wait_all();
    __syncthreads();  // raw holds this item; the last item's operands are read
    if (BF16) {
      to_pairs(reinterpret_cast<uint32_t*>(work_x), raw_x, cin, tid, DW_NT);
      uint32_t* dh = reinterpret_cast<uint32_t*>(work_dy);
      for (int i = tid; i < NT * 8 * (STRIP / 2); i += DW_NT) {
        const int co = i / (STRIP / 2), jj = i - co * (STRIP / 2);
        const float2 v = reinterpret_cast<const float2*>(raw_dy)[i];
        dh[co * DYH_LD + jj] = pack_bf16(v.x, v.y);
      }
    } else {
      copy4(work_x, raw_x, cin * SPAN, tid, DW_NT);
      for (int i = tid; i < NT * 8 * (STRIP / 4); i += DW_NT) {
        const int co = i / (STRIP / 4), j4 = i - co * (STRIP / 4);
        reinterpret_cast<float4*>(work_dy + co * DY_LD)[j4] =
            reinterpret_cast<const float4*>(raw_dy)[i];
      }
    }
    __syncthreads();
    if (item + 1 < n_items) load_item(item + 1);
    cp_async_commit();

    const int w0 = (item % n_strips) * STRIP;
    const int steps = (min(STRIP, width - w0) + 15) / 16;  // k16 steps of bins
    if (BF16) {
      for (int s0 = 0; s0 < steps; s0 += DW_STEPS) {
        // B: dy[co = 8j + g][kb + 2t ..] and [kb + 2t + 8 ..], one pair word each
        uint32_t bw[DW_STEPS][NT][2];
#pragma unroll
        for (int u = 0; u < DW_STEPS; ++u) {
          const uint32_t* dh =
              reinterpret_cast<const uint32_t*>(work_dy) + g * DYH_LD + 8 * (s0 + u) + t;
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            bw[u][j][0] = s0 + u < steps ? dh[8 * j * DYH_LD] : 0u;
            bw[u][j][1] = s0 + u < steps ? dh[8 * j * DYH_LD + 4] : 0u;
          }
        }
#pragma unroll
        for (int i = 0; i < DW_CI; ++i) {
          const int ci = warp + DW_WARPS * i;
          if (ci < cin) {
            float d[NT][4];
#pragma unroll
            for (int j = 0; j < NT; ++j)
#pragma unroll
              for (int q = 0; q < 4; ++q) d[j][q] = 0.f;
#pragma unroll
            for (int u = 0; u < DW_STEPS; ++u) {
              uint32_t a[4];
              hankel_bf16(reinterpret_cast<const uint32_t*>(work_x) + ci * SPAN +
                              16 * min(s0 + u, steps - 1) + g + 2 * t,
                          a);
#pragma unroll
              for (int j = 0; j < NT; ++j) mma_bf16(d[j], a, bw[u][j][0], bw[u][j][1]);
            }
#pragma unroll
            for (int j = 0; j < NT; ++j)
#pragma unroll
              for (int q = 0; q < 4; ++q) acc[i][j][q] += d[j][q];
          }
        }
      }
    } else {
      for (int s = 0; s < steps; ++s) {
        const int kb = 16 * s;
        // B of k8 step 0: dy[co][kb + t], [kb + t + 4]; step 1: kb + t + 8, + 12
        uint32_t bh[NT][4], bl[NT][4];
        const float* dr = work_dy + g * DY_LD + kb + t;
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) split_tf32(dr[8 * j * DY_LD + 4 * q], bh[j][q], bl[j][q]);
#pragma unroll
        for (int i = 0; i < DW_CI; ++i) {
          const int ci = warp + DW_WARPS * i;
          if (ci < cin) {
            uint32_t h0[4], l0[4], h1[4], l1[4];
            hankel_tf32(work_x + ci * SPAN + kb + g + t, h0, l0, h1, l1);
#pragma unroll
            for (int j = 0; j < NT; ++j) {
              float d[4] = {0.f, 0.f, 0.f, 0.f};
              mma_3xtf32(d, h0, l0, bh[j][0], bh[j][1], bl[j][0], bl[j][1]);
              mma_3xtf32(d, h1, l1, bh[j][2], bh[j][3], bl[j][2], bl[j][3]);
#pragma unroll
              for (int q = 0; q < 4; ++q) acc[i][j][q] += d[q];
            }
          }
        }
      }
    }
  }
  cp_async_wait_all();

  // C fragments: c0 c1 (tap g, co 2t, 2t + 1), c2 c3 (tap g + 8)
  float* out = partial + (size_t)blockIdx.x * cout * cin * k;
#pragma unroll
  for (int i = 0; i < DW_CI; ++i) {
    const int ci = warp + DW_WARPS * i;
    if (ci >= cin) continue;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int co = 8 * j + 2 * t + (q & 1), d = g + 8 * (q >> 1);
        if (co < cout && d < k) out[((size_t)co * cin + ci) * k + d] = acc[i][j][q];
      }
  }
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

size_t fwd_smem(int cin, int nt, bool bf16) {
  const size_t stage = (size_t)nt * 8 * STAGE_LD;
  const size_t operand = (size_t)cin * SPAN;
  return ((size_t)cin * nt * 32 * (bf16 ? 2 : 4) + operand + (operand > stage ? operand : stage)) *
         sizeof(float);
}

size_t dw_smem(int cin, int nt, bool bf16) {
  const size_t words = 2 * (size_t)cin * SPAN + (size_t)nt * 8 * STRIP +
                       (size_t)nt * 8 * (bf16 ? DYH_LD : DY_LD);
  return words * sizeof(float);
}

template <int NT, bool BF16>
int launch_fwd(const float* x, const float* wt, float* y, int rows, int cin, int cout, int width,
               int k, int n_blocks, cudaStream_t s) {
  const size_t bytes = fwd_smem(cin, NT, BF16);
  const int e = set_smem(reinterpret_cast<const void*>(conv_fwd_mma_kernel<NT, BF16>), bytes);
  if (e) return e;
  const int n_strips = (width + STRIP - 1) / STRIP;
  conv_fwd_mma_kernel<NT, BF16><<<n_blocks, FWD_NT, bytes, s>>>(x, wt, y, rows, cin, cout, width,
                                                                 k, n_strips);
  return static_cast<int>(cudaGetLastError());
}

template <int NT, bool BF16>
int launch_dw(const float* x, const float* dy, float* partial, float* dw, int rows, int cin,
              int cout, int width, int k, int rows_per_chunk, cudaStream_t s) {
  const size_t bytes = dw_smem(cin, NT, BF16);
  int e = set_smem(reinterpret_cast<const void*>(conv_dw_mma_kernel<NT, BF16>), bytes);
  if (e) return e;
  const int chunks = (rows + rows_per_chunk - 1) / rows_per_chunk;
  const int n_strips = (width + STRIP - 1) / STRIP;
  conv_dw_mma_kernel<NT, BF16><<<chunks, DW_NT, bytes, s>>>(x, dy, partial, rows, cin, cout,
                                                             width, k, n_strips, rows_per_chunk);
  e = static_cast<int>(cudaGetLastError());
  if (e) return e;
  const int n = cout * cin * k;
  conv_dw_reduce_kernel<<<(n + 255) / 256, 256, 0, s>>>(partial, dw, n, chunks);
  return static_cast<int>(cudaGetLastError());
}

bool shape_ok(int rows, int cin, int cout, int width, int k) {
  return rows > 0 && width > 0 && cin >= 1 && cin <= MAX_CH && cout >= 1 && cout <= MAX_CH &&
         k >= 1 && k < TAPS && k % 2 == 1;
}

}  // namespace

#define CONV_NTS(X) X(1) X(2) X(3) X(4) X(5)

// x [rows, cin, width], wt [cout, cin, k], y [rows, cout, width], all f32
// contiguous; k odd, 1 <= k <= 15; 1 <= cin, cout <= 40; n_blocks persistent
// blocks (at most rows * ceil(width / 288)). Returns cudaGetLastError() of the
// launch, or cudaErrorInvalidValue for a shape it does not take.
extern "C" int conv1d_same_fwd_f32(const float* x, const float* wt, float* y, int rows, int cin,
                                   int cout, int width, int k, int n_blocks, int round_bf16,
                                   void* stream) {
  if (!shape_ok(rows, cin, cout, width, k) || n_blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CONV_FWD_CASE(NT)                                                               \
  case NT:                                                                              \
    return round_bf16                                                                   \
               ? launch_fwd<NT, true>(x, wt, y, rows, cin, cout, width, k, n_blocks, s) \
               : launch_fwd<NT, false>(x, wt, y, rows, cin, cout, width, k, n_blocks, s);
  switch ((cout + 7) / 8) {
    CONV_NTS(CONV_FWD_CASE)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef CONV_FWD_CASE
}

// x [rows, cin, width], dy [rows, cout, width], dw [cout, cin, k], all f32
// contiguous; partial [ceil(rows / rows_per_chunk), cout * cin * k] scratch.
// Returns cudaGetLastError() of the launches, or cudaErrorInvalidValue for a
// shape it does not take.
extern "C" int conv1d_same_dw_f32(const float* x, const float* dy, float* partial, float* dw,
                                  int rows, int cin, int cout, int width, int k,
                                  int rows_per_chunk, int round_bf16, void* stream) {
  if (!shape_ok(rows, cin, cout, width, k) || rows_per_chunk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CONV_DW_CASE(NT)                                                                     \
  case NT:                                                                                   \
    return round_bf16 ? launch_dw<NT, true>(x, dy, partial, dw, rows, cin, cout, width, k,  \
                                            rows_per_chunk, s)                              \
                      : launch_dw<NT, false>(x, dy, partial, dw, rows, cin, cout, width, k, \
                                             rows_per_chunk, s);
  switch ((cout + 7) / 8) {
    CONV_NTS(CONV_DW_CASE)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef CONV_DW_CASE
}
