// 'same' conv1d for the encoder's wide-kernel layers in f32 on the CUDA cores
// (sm_90a): forward (also the input gradient) and weight gradient, NCW layout.
//
// Replaces no TPU kernel: the JAX package leaves these convolutions to XLA
// (sot_tpu/models/encoder.py, nn.Conv) unless its conv gate is on. The port
// ran them on cuDNN's f32 convolutions; these kernels take their place on the
// default route (models/encoder.py, F32Conv1d). They compute the layer's own
// arithmetic: f32 products by FFMA, summed in f32, only the order of the sums
// differs from cuDNN's.
//
//   y[b, co, w]   = sum_{ci, d} W[co, ci, d] x[b, ci, w + d - p]  (+ bias[co])
//   dW[co, ci, d] = sum_{b, w} dy[b, co, w] x[b, ci, w + d - p]
//
// with p = (k - 1) / 2 and zeros outside [0, width). The input gradient is the
// forward on dy with the weight tap-flipped and (ci <-> co)-transposed; the
// kernel reads that weight in place (`transposed`).
//
// Bound on the H100: at the prefilter's shape (1024 rows, 40 -> 40 channels,
// 285 bins, k = 15) each pass is 14.0 GFLOP: 0.209 ms at the FP32 FFMA peak
// (67 TFLOP/s), far above its bytes (~93 MB in f32, 0.028 ms). So the design
// is about issuing FFMA back to back, from as many warps on each of an SM's
// four schedulers.
//
// Design. A forward work item is one row's strip of STRIP = 288 bins (32
// lanes x PT = 9 positions); every odd k <= 15 is computed as KP = 15 centred
// taps, the others zero.
//  * Forward: a group of warps (one warp per CT output channels: CT = 10, or
//    1 for C_out <= 4; four warps at C_out = 40) owns an item; a block holds
//    `groups` groups that walk the items independently (named barriers), so
//    one group's staging overlaps another's FFMAs. The block stages the whole
//    weight once, as [ci][KP][C_out padded to CT], so a warp reads its CT
//    weights of a tap as broadcast float2 loads. A group stages its item's
//    input strip with its halo ([ci][303], 4-byte cp.async: a row starts at
//    any element). A lane keeps PT x CT sums in registers; per input channel
//    it loads the PT + 14 input values its window needs once (lanes 9 words
//    apart: no bank conflicts) and slides them across the 15 taps: 15 x PT x
//    CT FFMAs per 23 + 15 x CT / 2 shared loads. The 75 products of each
//    FWD_GROUP_CI = 5 input channels are summed apart and then added to the
//    output's sum (chains of 75, then 8 at C_in = 40: a sequential chain of
//    600 read ~4x cuDNN's error against float64 on the real dx). The sums go
//    through shared memory so that the stores along w are coalesced; the bias
//    is added there, in f32 after the sum, as nn.Conv1d adds it.
//  * Weight gradient: a work item is one row's strip of DSTRIP = 144 bins;
//    one block per SM sums a run of items, the next item's strips arriving by
//    cp.async while it computes the current one (two stages). A thread owns
//    CD = 5 output channels x 15 taps of one input channel (75 sums in
//    registers, 320 threads at 40 -> 40) and one slice of the item's
//    positions (all of them when C_in x ceil(C_out / CD) fills the block, 9
//    when C_in = 1). Per 9 positions it loads its input window (23 values)
//    once; per position its 5 dy values as 3 float2 broadcasts ([w][C_out]
//    in slots of 6, transposed as staged): 75 FFMAs per ~5.6 shared loads.
//    Each item's sums are added to the thread's own
//    running sums in shared memory: chains of at most 144 products, then one
//    term per item, which keeps the f32 error of a sum over 291,840 products
//    near cuDNN's. At the block's end its slices are added pairwise and its
//    sums written to a scratch in thread order (coalesced); a second kernel
//    sums the blocks of each output, 8 interleaved runs added pairwise.
//  * Shapes: odd k <= 15, 1 <= C_in, C_out <= MAX_CH, any width and row
//    count. The zero taps multiply real input values, so with k < 15 a
//    non-finite input also reaches the outputs within 7 bins of it.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int KP = 15;                 // taps: odd k <= 15, centred in KP
constexpr int HALO = (KP - 1) / 2;
constexpr int PT = 9;                  // output positions per lane
constexpr int STRIP = 32 * PT;         // bins per work item
constexpr int SPAN = STRIP + KP - 1;   // a strip's input with its halo
constexpr int XWIN = PT + KP - 1;      // a lane's input window
constexpr int XS = 303;                // staged input row stride: odd, >= SPAN
constexpr int DSTRIP = 16 * PT;        // weight gradient: bins per work item
constexpr int DXS = 159;               // its staged input row stride: odd, >= DSTRIP + 14
constexpr int CD = 5;                  // weight gradient: output channels per thread
constexpr int CDP = 6;                 // their slots in the staged dy
constexpr int MAX_CH = 40;
constexpr int MAX_GROUPS = 15;         // named barriers 1..15
constexpr int FWD10_THREADS = 256;     // CT = 10: two 4-warp groups
constexpr int FWD1_THREADS = 1024;
constexpr int DW_THREADS = 320;        // one block an SM, <= 168 registers a thread
constexpr int RED_RUNS = 8;            // the reduce's interleaved runs over blocks
constexpr int FWD_GROUP_CI = 5;        // forward: input channels summed apart, then added
constexpr int SMEM_MAX = 232448;       // a block's shared memory on the H100

__host__ __device__ __forceinline__ int round4(int n) { return (n + 3) & ~3; }
__host__ __device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4 bytes, zero-filled when !valid (src is then not read)
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// barrier `id` over the `n` threads of one group
__device__ __forceinline__ void group_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// Stage one row's strip [w0 - HALO, w0 - HALO + SPAN) of every input channel
// into xs [cin][XS], zeros outside [0, width).
__device__ __forceinline__ void stage_strip(float* xs, const float* xr, int cin, int width,
                                            int w0, int tid, int nthreads) {
  for (int ci = 0; ci < cin; ++ci)
    for (int j = tid; j < SPAN; j += nthreads) {
      const int p = w0 + j - HALO;
      const bool ok = p >= 0 && p < width;
      cp_async4(xs + ci * XS + j, xr + (size_t)ci * width + (ok ? p : 0), ok);
    }
}

// Forward. Shared: the weights [cin][KP][cp] (cp = C_out padded to CT), then
// per group a buffer holding the input strip [cin][XS] and, after the sums,
// the output strip [cp][STRIP].
template <int CT>
__global__ void __launch_bounds__(CT == 10 ? FWD10_THREADS : FWD1_THREADS, 1)
    conv_f32_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                        const float* __restrict__ bias, float* __restrict__ y, int rows, int cin,
                        int cout, int width, int k, int transposed, int n_strips, int groups) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int n_cg = (cout + CT - 1) / CT;
  const int cp = n_cg * CT;
  const int gt = 32 * n_cg;
  const int g = threadIdx.x / gt, lt = threadIdx.x - g * gt;
  const int cg = lt >> 5, lane = lt & 31;
  float* ws = smem;
  float* buf = smem + round4(cin * KP * cp) + g * round4(imax(cin * XS, cp * STRIP));

  const int off = (KP - k) / 2;
  for (int i = threadIdx.x; i < cin * KP * cp; i += blockDim.x) {
    const int co = i % cp, t = i / cp, d = t % KP, ci = t / KP, dk = d - off;
    float v = 0.f;
    if (co < cout && dk >= 0 && dk < k)
      v = transposed ? w[((size_t)ci * cout + co) * k + (k - 1 - dk)]
                     : w[((size_t)co * cin + ci) * k + dk];
    ws[i] = v;
  }
  __syncthreads();

  const int items = rows * n_strips;
  for (int item = blockIdx.x * groups + g; item < items; item += gridDim.x * groups) {
    const int r = item / n_strips, w0 = (item - r * n_strips) * STRIP;
    stage_strip(buf, x + (size_t)r * cin * width, cin, width, w0, lt, gt);
    cp_async_commit();
    cp_async_wait<0>();
    group_sync(g + 1, gt);

    float acc[PT][CT];
#pragma unroll
    for (int i = 0; i < PT; ++i)
#pragma unroll
      for (int c = 0; c < CT; ++c) acc[i][c] = 0.f;
    const float* xp = buf + lane * PT;
    const float* wp = ws + cg * CT;
    for (int c0 = 0; c0 < cin; c0 += FWD_GROUP_CI) {
      // FWD_GROUP_CI channels' products summed apart, then added
      float part[PT][CT];
#pragma unroll
      for (int i = 0; i < PT; ++i)
#pragma unroll
        for (int c = 0; c < CT; ++c) part[i][c] = 0.f;
      const int c1 = c0 + FWD_GROUP_CI < cin ? c0 + FWD_GROUP_CI : cin;
      for (int ci = c0; ci < c1; ++ci, xp += XS, wp += KP * cp) {
        float xv[XWIN];
#pragma unroll
        for (int j = 0; j < XWIN; ++j) xv[j] = xp[j];
#pragma unroll
        for (int d = 0; d < KP; ++d) {
          float wv[CT];
          if constexpr (CT == 10) {
#pragma unroll
            for (int c = 0; c < CT; c += 2) {
              const float2 v = *reinterpret_cast<const float2*>(wp + d * cp + c);
              wv[c] = v.x;
              wv[c + 1] = v.y;
            }
          } else {
            wv[0] = wp[d * cp];
          }
#pragma unroll
          for (int i = 0; i < PT; ++i)
#pragma unroll
            for (int c = 0; c < CT; ++c) part[i][c] = fmaf(xv[i + d], wv[c], part[i][c]);
        }
      }
#pragma unroll
      for (int i = 0; i < PT; ++i)
#pragma unroll
        for (int c = 0; c < CT; ++c) acc[i][c] += part[i][c];
    }
    group_sync(g + 1, gt);  // every lane has read the strip

#pragma unroll
    for (int i = 0; i < PT; ++i)
#pragma unroll
      for (int c = 0; c < CT; ++c) buf[(cg * CT + c) * STRIP + lane * PT + i] = acc[i][c];
    group_sync(g + 1, gt);
    const int n = width - w0 < STRIP ? width - w0 : STRIP;
    float* yr = y + (size_t)r * cout * width + w0;
    for (int co = 0; co < cout; ++co) {
      const float* src = buf + co * STRIP;
      float* dst = yr + (size_t)co * width;
      if (bias) {
        const float b = bias[co];
        for (int j = lt; j < n; j += gt) dst[j] = src[j] + b;
      } else {
        for (int j = lt; j < n; j += gt) dst[j] = src[j];
      }
    }
    group_sync(g + 1, gt);  // the buffer is free for the next item
  }
}

// Stage one item of the weight gradient, one row's DSTRIP bins from w0: the
// input strip into xs [cin][DXS], dy transposed into ds [DSTRIP][cps] (each
// thread's CD channels padded to CDP, so it reads them as float2 pairs),
// zeros past the row, past C_out and in the padding. A warp's lanes take 4
// slots x 8 bins of dy, so each channel's 8 bins are one 32-byte sector and
// the shared stores conflict at most 2-way.
__device__ __forceinline__ void stage_dw(float* xs, float* ds, const float* x, const float* dy,
                                         int item, int n_strips, int cin, int cout, int cps,
                                         int width, int tid, int nt) {
  const int r = item / n_strips, w0 = (item - r * n_strips) * DSTRIP;
  const float* xr = x + (size_t)r * cin * width;
  for (int ci = 0; ci < cin; ++ci)
    for (int j = tid; j < DSTRIP + KP - 1; j += nt) {
      const int p = w0 + j - HALO;
      const bool ok = p >= 0 && p < width;
      cp_async4(xs + ci * DXS + j, xr + (size_t)ci * width + (ok ? p : 0), ok);
    }
  const float* dr = dy + (size_t)r * cout * width;
  for (int e = tid; e < cps * DSTRIP; e += nt) {
    const int rest = e >> 5;
    const int slot = (rest / (DSTRIP / 8)) * 4 + (e & 3);
    const int j = (rest % (DSTRIP / 8)) * 8 + ((e >> 2) & 7);
    const int c = slot % CDP, co = (slot / CDP) * CD + c;
    const bool ok = c < CD && co < cout && w0 + j < width;
    cp_async4(ds + j * cps + slot, dr + (ok ? (size_t)co * width + w0 + j : 0), ok);
  }
  cp_async_commit();
}

// Weight gradient, first pass: block b sums items [b * per_block, (b + 1) *
// per_block). Shared: two stages of (xs [cin][DXS], ds [DSTRIP][cps]), then
// the block's sums [CD * KP][nt] in thread order. Thread tid = (slice * cin +
// ci) * n_cg + cg = slice * t1n + t1. partial [blocks][CD * KP][t1n].
__global__ void __launch_bounds__(DW_THREADS, 1)
    conv_f32_dw_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                       float* __restrict__ partial, int rows, int cin, int cout, int width,
                       int n_strips, int n_slices, int per_block) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int n_cg = (cout + CD - 1) / CD;
  const int cps = round4(n_cg * CDP);
  const int xsz = round4(cin * DXS), stage = xsz + DSTRIP * cps;
  const int nt = blockDim.x, tid = threadIdx.x;
  const int t1n = cin * n_cg;
  const int cg = tid % n_cg, t1 = tid % t1n, ci = t1 / n_cg, sl = tid / t1n;
  const int slice = DSTRIP / n_slices;
  float* sums = smem + 2 * stage;
  for (int i = tid; i < CD * KP * nt; i += nt) sums[i] = 0.f;

  const int first = blockIdx.x * per_block;
  const int last = min(rows * n_strips, first + per_block);
  stage_dw(smem, smem + xsz, x, dy, first, n_strips, cin, cout, cps, width, tid, nt);
  for (int item = first, buf = 0; item < last; ++item, buf ^= 1) {
    if (item + 1 < last) {
      float* other = smem + (buf ^ 1) * stage;
      stage_dw(other, other + xsz, x, dy, item + 1, n_strips, cin, cout, cps, width, tid, nt);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    float acc[CD][KP];
#pragma unroll
    for (int c = 0; c < CD; ++c)
#pragma unroll
      for (int d = 0; d < KP; ++d) acc[c][d] = 0.f;
    const float* xp = smem + buf * stage + ci * DXS + sl * slice;
    const float* dp = smem + buf * stage + xsz + sl * slice * cps + cg * CDP;
    for (int q = 0; q < slice; q += PT, xp += PT, dp += PT * cps) {
      float xv[XWIN];
#pragma unroll
      for (int j = 0; j < XWIN; ++j) xv[j] = xp[j];
#pragma unroll
      for (int i = 0; i < PT; ++i) {
        float dv[CDP];
#pragma unroll
        for (int c = 0; c < CDP; c += 2) {
          const float2 v = *reinterpret_cast<const float2*>(dp + i * cps + c);
          dv[c] = v.x;
          dv[c + 1] = v.y;
        }
#pragma unroll
        for (int d = 0; d < KP; ++d)
#pragma unroll
          for (int c = 0; c < CD; ++c) acc[c][d] = fmaf(dv[c], xv[i + d], acc[c][d]);
      }
    }
    // the item's sums onto the block's, each thread its own
#pragma unroll
    for (int c = 0; c < CD; ++c)
#pragma unroll
      for (int d = 0; d < KP; ++d) sums[(c * KP + d) * nt + tid] += acc[c][d];
    __syncthreads();  // this stage is free for the item after next
  }

  // the slices added pairwise, then the block's sums in thread order
  for (int h = n_slices / 2; h >= 1; h /= 2) {
    for (int i = tid; i < CD * KP * h * t1n; i += nt) {
      const int cd = i / (h * t1n), rest = i - cd * h * t1n;
      sums[cd * nt + rest] += sums[cd * nt + h * t1n + rest];
    }
    __syncthreads();
  }
  float* out = partial + (size_t)blockIdx.x * CD * KP * t1n;
  for (int i = tid; i < CD * KP * t1n; i += nt) out[i] = sums[(i / t1n) * nt + i % t1n];
}

// Weight gradient, second pass: 32 outputs a block, RED_RUNS lanes each;
// lane g sums blocks g, g + RED_RUNS, ... in order, and the runs are added
// pairwise.
__global__ void __launch_bounds__(32 * RED_RUNS)
    conv_f32_dw_reduce_kernel(const float* __restrict__ partial, float* __restrict__ dw, int cin,
                              int cout, int k, int blocks) {
  __shared__ float run[RED_RUNS][32];
  const int n_cg = (cout + CD - 1) / CD;
  const int t1n = cin * n_cg, n = CD * KP * t1n;
  const int j = threadIdx.x & 31, g = threadIdx.x >> 5;
  const int o = blockIdx.x * 32 + j;
  float s = 0.f;
  if (o < n)
    for (int b = g; b < blocks; b += RED_RUNS) s += partial[(size_t)b * n + o];
  run[g][j] = s;
  __syncthreads();
  for (int h = RED_RUNS / 2; h >= 1; h /= 2) {
    if (g < h) run[g][j] += run[g + h][j];
    __syncthreads();
  }
  if (g != 0 || o >= n) return;
  const int t1 = o % t1n, cd = o / t1n;
  const int co = (t1 % n_cg) * CD + cd / KP, ci = t1 / n_cg, dk = cd % KP - (KP - k) / 2;
  if (co < cout && dk >= 0 && dk < k) dw[((size_t)co * cin + ci) * k + dk] = run[0][j];
}

int set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

bool shape_ok(int rows, int cin, int cout, int width, int k) {
  return rows > 0 && width > 0 && cin >= 1 && cin <= MAX_CH && cout >= 1 && cout <= MAX_CH &&
         k >= 1 && k <= KP && k % 2 == 1;
}

template <int CT>
int launch_fwd(const float* x, const float* w, const float* bias, float* y, int rows, int cin,
               int cout, int width, int k, int transposed, int groups, int blocks,
               cudaStream_t s) {
  const int cp = (cout + CT - 1) / CT * CT;
  const int threads = groups * 32 * (cp / CT);
  const size_t bytes = sizeof(float) * (round4(cin * KP * cp) +
                                        (size_t)groups * round4(imax(cin * XS, cp * STRIP)));
  if (groups < 1 || groups > MAX_GROUPS || threads > (CT == 10 ? FWD10_THREADS : FWD1_THREADS) ||
      bytes > SMEM_MAX || blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int e = set_smem(reinterpret_cast<const void*>(conv_f32_fwd_kernel<CT>), bytes);
  if (e) return e;
  const int n_strips = (width + STRIP - 1) / STRIP;
  conv_f32_fwd_kernel<CT><<<blocks, threads, bytes, s>>>(x, w, bias, y, rows, cin, cout, width, k,
                                                         transposed, n_strips, groups);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [rows, cin, width] -> y [rows, cout, width], all f32 contiguous; w [cout,
// cin, k], or with `transposed` [cin, cout, k] read tap-flipped; bias [cout]
// or null. k odd, 1 <= k <= 15; 1 <= cin, cout <= 40; `groups` item groups a
// block (their shared memory and threads within the card's limits), `blocks`
// persistent blocks. Channels per warp: 10 for cout > 4, else 1. Returns
// cudaGetLastError() of the launch, or cudaErrorInvalidValue for a shape or
// plan it does not take.
extern "C" int conv1d_f32_fwd(const float* x, const float* w, const float* bias, float* y,
                              int rows, int cin, int cout, int width, int k, int transposed,
                              int groups, int blocks, void* stream) {
  if (!shape_ok(rows, cin, cout, width, k)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return cout > 4 ? launch_fwd<10>(x, w, bias, y, rows, cin, cout, width, k, transposed, groups,
                                   blocks, s)
                  : launch_fwd<1>(x, w, bias, y, rows, cin, cout, width, k, transposed, groups,
                                  blocks, s);
}

// x [rows, cin, width], dy [rows, cout, width] -> dw [cout, cin, k], all f32
// contiguous; n_slices (1, 2, 4, 8 or 16) slices of a 144-bin item, n_slices
// * cin * ceil(cout / 5) <= 320 threads a block; per_block items (rows x
// 144-bin strips) a block; partial [ceil(items / per_block), 75 * cin *
// ceil(cout / 5)] scratch. Returns cudaGetLastError() of the launches, or
// cudaErrorInvalidValue for a shape or plan it does not take.
extern "C" int conv1d_f32_dw(const float* x, const float* dy, float* partial, float* dw,
                             int rows, int cin, int cout, int width, int k, int n_slices,
                             int per_block, void* stream) {
  const int n_cg = (cout + CD - 1) / CD;
  const int threads = n_slices * cin * n_cg;
  if (!shape_ok(rows, cin, cout, width, k) || per_block < 1 || n_slices < 1 ||
      (DSTRIP / PT) % n_slices != 0 || threads > DW_THREADS)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t stage = round4(cin * DXS) + (size_t)DSTRIP * round4(n_cg * CDP);
  const size_t bytes = sizeof(float) * (2 * stage + (size_t)CD * KP * threads);
  if (bytes > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int e = set_smem(reinterpret_cast<const void*>(conv_f32_dw_kernel), bytes);
  if (e) return e;
  const int n_strips = (width + DSTRIP - 1) / DSTRIP;
  const int blocks = (rows * n_strips + per_block - 1) / per_block;
  conv_f32_dw_kernel<<<blocks, threads, bytes, s>>>(x, dy, partial, rows, cin, cout, width,
                                                    n_strips, n_slices, per_block);
  e = static_cast<int>(cudaGetLastError());
  if (e) return e;
  const int n = CD * KP * cin * n_cg;
  conv_f32_dw_reduce_kernel<<<(n + 31) / 32, 32 * RED_RUNS, 0, s>>>(partial, dw, cin, cout, k,
                                                                    blocks);
  return static_cast<int>(cudaGetLastError());
}
