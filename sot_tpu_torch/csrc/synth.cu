// Sinusoidal synth forward and backward for Hopper (sm_90a).
//
// Replaces the TPU kernels sot_tpu/ops/pallas/synth.py:_fwd_kernel and
// :_bwd_kernel (the backward's notes are above synth_bwd_kernel).
//
// Frame-rate controls -> audio, for amplitudes a[b, j, k] (already
// Nyquist-masked at frame rate) and harmonic frequencies f[b, j, k]:
//   env_f[t] = f_lo + frac[t] * (f_hi - f_lo)          (bilinear, exact taps)
//   env_a[t] = a[j+1] * w[r] + a[j] * w[hop + r]       (hann OLA, t = j*hop + r,
//                                                       a[F] = a[F-1])
//   env_a[t] = 0 where env_f[t] >= nyquist
//   phase[t] = sum_{s <= t} env_f[s] * (2*pi / sr)     (unwrapped)
//   audio[b, t] = sum_k env_a * sin(phase)             (f32, k = 0, 1, ... from +0)
//
// Bit-exact envelopes. Rounding differences of ~1e-6 in the envelopes,
// amplified over 4096 samples of phase, degraded two 25k-step training runs
// of the JAX package (PERF.md, "The synth-kernel lesson"). So the envelopes
// use the reference's expressions with every product and sum rounded on its
// own (__fmul_rn / __fadd_rn / __fsub_rn: nvcc would otherwise contract
// a*b + c into an FMA), and the bilinear fraction is a host-computed float64
// value rounded once to f32, passed as a table.
//
// Phase in float64, rounded once. The phase is not wrapped and reaches
// ~1.3e4 rad, where one f32 ulp is ~1e-3 rad; an f32 prefix drifts by
// several ulps over 4096 samples. The increments env_f * (2*pi/sr) are f32
// products as in the reference, summed in float64, each phase rounded once
// to f32: the plain version's float64 cumsum (ops/scan.py). That sum is
// exact in any order for the model's controls: every harmonic is >= ~30 Hz
// (the CQT's fmin), so each increment is >= 2^-7 rad and a multiple of
// 2^-30, and the partial sums stay below 2^18 (20 harmonics of the top f0
// over 8192 samples), which is 48 of float64's 53 bits. So the kernel may
// split the sum into segments and lanes and still give the plain version's
// phase bit for bit (tests/test_torch_synth_plan.py holds the split; below
// ~20 Hz the split is fp-close instead).
//
// sinf, never __sinf: the fast intrinsic's range reduction fails at these
// phases. The audio sum adds __fmul_rn(env_a, sinf(phase)) to an f32
// accumulator in k order from +0, the same bits as a per-sinusoid product
// summed afterwards. Where env_f >= nyquist the product is +-0, and adding
// +-0 leaves an accumulator that started at +0 unchanged, so the sine is
// skipped there (the phase still counts).
//
// Bound on the H100: operations. Inputs are ~0.2 MB and the output 1 MB; the
// work is 64*20*4096 = 5.24 M lanes*samples of f-envelope arithmetic at the
// serving shape, the float64 prefix up to each lane's last sample below
// Nyquist, and a full-range sinf with its a-envelope and product only at the
// samples below Nyquist (about half of them for the smoke's controls).
//
// Design. Two launches, each with one block per (clip, 512-sample segment)
// and two warps per 128-sample chunk of it; a lane owns a run of 4
// consecutive samples (16-byte loads and stores, coalesced), reads its
// samples' tables (lo, frac, the OLA frame and window taps) once into
// registers and reuses them for every harmonic; a clip's frame controls sit
// in shared memory, read by broadcast. The 512 blocks of 8 warps at the
// serving shape are resident at once (one wave: 64 registers a thread).
//  1. synth_phase_totals_kernel: the float64 total of each chunk's
//     increments for every (clip, harmonic, chunk), [B, K, T/128] (only
//     env_f is needed); four harmonics' lane sums at a time are added
//     through shared memory, which takes fewer shuffles than a butterfly.
//  2. synth_fwd_kernel: the block first gathers each harmonic's phase carry
//     into its chunks (the earlier chunks' totals; one cp.async round trip
//     brings them and the frame controls into shared memory); then a
//     chunk's two warps take the even and the odd harmonics: each scans its
//     lanes' runs in float64 (shuffles within groups of 8 lanes, the groups
//     through shared memory), skips a harmonic whose 128 samples are all at
//     or above Nyquist, and leaves env_a * sin(phase) in shared memory (+0
//     where the sample is masked); the chunk's threads then add the terms
//     to f32 accumulators in k order and store the audio once. No
//     [B, K, T] tensor, no atomics.
//
// Measured with in-kernel clocks on an H100 (PERF.md): per block, the
// prologue's round trip to memory and the main loop's sinf and float64
// chains; the blocks whose clips keep most harmonics below Nyquist set the
// span.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int CHUNK = 128;                // samples per warp: 4 per lane
constexpr int FWD_CHUNKS = 4;             // chunks per forward block (a segment)
constexpr int FWD_NW = 2 * FWD_CHUNKS;    // two warps per chunk share its harmonics
constexpr int FWD_NT = 32 * FWD_NW;
constexpr int FWD_BLOCKS_PER_SM = 4;      // 64 registers a thread: 528 blocks in one wave
constexpr int KT_MAX = 32;                // harmonics per shared-memory tile
constexpr int BWD_MAX_NT = 512;
constexpr int MAX_FRAMES = 128;
constexpr unsigned FULL = 0xffffffffu;

// One lane's four samples t0..t0+3: the tables, read once per thread.
struct Taps {
  int lo[4];      // bilinear frame below (lo <= F - 2, hi = lo + 1)
  float frac[4];  // host-rounded bilinear fraction
  int j[4];       // OLA chunk t / hop
  float rise[4];  // window[r], weighting a[j + 1]
  float fall[4];  // window[hop + r], weighting a[j]
};

__device__ __forceinline__ Taps load_taps(const int* __restrict__ lo_idx,
                                          const float* __restrict__ frac,
                                          const float* __restrict__ window, int hop, int t0) {
  Taps p;
  const int4 lo4 = *reinterpret_cast<const int4*>(lo_idx + t0);
  const float4 fr4 = *reinterpret_cast<const float4*>(frac + t0);
  p.lo[0] = lo4.x, p.lo[1] = lo4.y, p.lo[2] = lo4.z, p.lo[3] = lo4.w;
  p.frac[0] = fr4.x, p.frac[1] = fr4.y, p.frac[2] = fr4.z, p.frac[3] = fr4.w;
  int j = t0 / hop;  // one division per run
  int r = t0 - j * hop;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    p.j[q] = j;
    p.rise[q] = window[r];
    p.fall[q] = window[hop + r];
    if (++r == hop) r = 0, ++j;
  }
  return p;
}

// f = (x[lo], x[lo + 1])
__device__ __forceinline__ float env_f_of(float2 f, float frac) {
  return __fadd_rn(f.x, __fmul_rn(frac, __fsub_rn(f.y, f.x)));
}

// a = (a[j], a[j + 1])
__device__ __forceinline__ float env_a_of(float2 a, float rise, float fall) {
  return __fadd_rn(__fmul_rn(a.y, rise), __fmul_rn(a.x, fall));
}

// Asynchronous global -> shared copies (cp.async, sm_80+): no registers held
// while the copies fly, so a block's loads share one round trip.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src));
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// dst[j * kt + kk] = x[b, min(j, F - 1), k0 + kk] for j < rows (rows = F + 1
// repeats the last frame: the OLA's a[F] = a[F - 1]), copied asynchronously
__device__ __forceinline__ void copy_frames(const float* __restrict__ src, float* dst, int b,
                                            int n_frames, int rows, int n_sin, int k0, int kt) {
  for (int idx = threadIdx.x; idx < rows * kt; idx += blockDim.x) {
    const int j = idx / kt;
    cp_async4(dst + idx,
              src + ((size_t)b * n_frames + min(j, n_frames - 1)) * n_sin + k0 + idx - j * kt);
  }
}

__device__ __forceinline__ void store4(float* dst, const float (&v)[4]) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
}

// grid (batch, segments); totals[b, k, c] = sum of chunk c's increments.
// Warp w takes chunk w % 4 of the segment and every other harmonic.
__global__ void __launch_bounds__(FWD_NT, FWD_BLOCKS_PER_SM)
synth_phase_totals_kernel(const float* __restrict__ freqs, const int* __restrict__ lo_idx,
                          const float* __restrict__ frac, double* __restrict__ totals,
                          int n_frames, int n_sin, int n_samples, float omega_scale) {
  extern __shared__ float f_s[];  // [F][min(K, KT_MAX)]
  constexpr int RED_STRIDE = 36;  // rows of the lane sums, padded against bank conflicts
  __shared__ double red_s[FWD_NW][4 * RED_STRIDE];
  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int half = warp / FWD_CHUNKS;
  const int n_chunks = n_samples / CHUNK;
  const int c = blockIdx.y * FWD_CHUNKS + warp % FWD_CHUNKS;
  const bool active = c < n_chunks;  // warp-uniform
  const int t0 = c * CHUNK + 4 * lane;
  int lo[4] = {0, 0, 0, 0};
  float fr[4] = {0.f, 0.f, 0.f, 0.f};
  if (active) {
    const int4 lo4 = *reinterpret_cast<const int4*>(lo_idx + t0);
    const float4 fr4 = *reinterpret_cast<const float4*>(frac + t0);
    lo[0] = lo4.x, lo[1] = lo4.y, lo[2] = lo4.z, lo[3] = lo4.w;
    fr[0] = fr4.x, fr[1] = fr4.y, fr[2] = fr4.z, fr[3] = fr4.w;
  }
  for (int k0 = 0; k0 < n_sin; k0 += KT_MAX) {
    const int kt = min(KT_MAX, n_sin - k0);
    __syncthreads();
    copy_frames(freqs, f_s, b, n_frames, n_frames, n_sin, k0, kt);
    cp_async_wait_all();
    __syncthreads();
    if (!active) continue;
    // harmonics half, half + 2, ...: four at a time
    for (int kk = half; kk < kt; kk += 8) {
      double s[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        s[u] = 0.0;
        if (kk + 2 * u < kt)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float* fk = f_s + lo[q] * kt + kk + 2 * u;
            s[u] += static_cast<double>(
                __fmul_rn(env_f_of(make_float2(fk[0], fk[kt]), fr[q]), omega_scale));
          }
      }
      // the four sums over the lanes: through shared memory, lane (u, g) adds
      // lanes g, g + 8, g + 16, g + 24 of harmonic u, then a butterfly over
      // the eight g (exact, so the order does not matter)
      double* red = red_s[warp];
#pragma unroll
      for (int u = 0; u < 4; ++u) red[u * RED_STRIDE + lane] = s[u];
      __syncwarp();
      const int u = lane >> 3, g = lane & 7;
      double v = red[u * RED_STRIDE + g];
#pragma unroll
      for (int i = 1; i < 4; ++i) v += red[u * RED_STRIDE + g + 8 * i];
#pragma unroll
      for (int d = 4; d > 0; d >>= 1) v += __shfl_xor_sync(FULL, v, d);
      if (g == 0 && kk + 2 * u < kt)
        totals[((size_t)b * n_sin + k0 + kk + 2 * u) * n_chunks + c] = v;
      __syncwarp();
    }
  }
}

// grid (batch, segments). Warp w takes chunk w % 4 of the segment and every
// other harmonic of it (w / 4, w / 4 + 2, ...), so that a chunk's two warps
// see alike shares of masked harmonics; both leave their terms in shared
// memory, and the chunk's 64 threads then add them in k order, two samples
// each. DEBUG also writes env_f, env_a and the rounded phase, each [B, K, T],
// and computes every harmonic of every chunk.
template <bool DEBUG>
__global__ void __launch_bounds__(FWD_NT, FWD_BLOCKS_PER_SM)
synth_fwd_kernel(const float* __restrict__ amps, const float* __restrict__ freqs,
                 const int* __restrict__ lo_idx, const float* __restrict__ frac,
                 const float* __restrict__ window, const double* __restrict__ totals,
                 float* __restrict__ audio, float* __restrict__ env_f_dbg,
                 float* __restrict__ env_a_dbg, float* __restrict__ phase_dbg, int n_frames,
                 int n_sin, int n_samples, float nyquist, float omega_scale) {
  // ktc = min(K, KT_MAX): the chunk totals [ktc][n_chunks] (float64), the
  // terms [FWD_CHUNKS][ktc][CHUNK], then the frame controls f [F][ktc] and
  // a [F + 1][ktc] (f32)
  extern __shared__ double fwd_dyn[];
  __shared__ double carries[KT_MAX][FWD_CHUNKS];
  __shared__ double groups[FWD_NW][4];  // a warp's 8-lane group totals
  const int ktc = min(n_sin, KT_MAX);
  const int n_chunks = n_samples / CHUNK;
  double* tot_s = fwd_dyn;
  float* terms = reinterpret_cast<float*>(fwd_dyn + ktc * n_chunks);
  float* f_s = terms + FWD_CHUNKS * ktc * CHUNK;
  float* a_s = f_s + ktc * n_frames;

  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int chunk = warp % FWD_CHUNKS;
  const int half = warp / FWD_CHUNKS;
  const int c0 = blockIdx.y * FWD_CHUNKS;  // the segment's first chunk
  const int c = c0 + chunk;
  const bool active = c < n_chunks;  // warp-uniform
  const int t0 = c * CHUNK + 4 * lane;
  const int s0 = 64 * half + 2 * lane;  // this thread's two samples of the sum
  const int n_before = min(c0 + FWD_CHUNKS - 1, n_chunks);  // totals the carries need
  float* chunk_terms = terms + chunk * ktc * CHUNK;
  Taps p{};
  if (active) p = load_taps(lo_idx, frac, window, n_samples / n_frames, t0);
  float acc[2] = {0.f, 0.f};

  for (int k0 = 0; k0 < n_sin; k0 += KT_MAX) {
    const int kt = min(KT_MAX, n_sin - k0);
    __syncthreads();
    // one round trip for the block: the frame controls and the chunk totals
    copy_frames(freqs, f_s, b, n_frames, n_frames, n_sin, k0, kt);
    copy_frames(amps, a_s, b, n_frames, n_frames + 1, n_sin, k0, kt);
    for (int idx = threadIdx.x; idx < kt * n_before; idx += FWD_NT) {
      const int kk = idx / n_before;
      cp_async8(tot_s + kk * n_chunks + idx - kk * n_before,
                totals + ((size_t)b * n_sin + k0 + kk) * n_chunks + idx - kk * n_before);
    }
    cp_async_wait_all();
    __syncthreads();
    // each harmonic's phase carry into the segment's chunks: the totals of the
    // chunks before the segment (a warp takes four harmonics at a time, 8
    // lanes each: lane g adds chunks g, g + 8, ..., then a butterfly over the
    // 8), then those of the segment's earlier chunks in order; exact, so the
    // order does not matter
    for (int k4 = 4 * warp; k4 < kt; k4 += 4 * FWD_NW) {
      const int kk = k4 + (lane >> 3), g = lane & 7;
      const double* col = tot_s + min(kk, kt - 1) * n_chunks;
      double v = 0.0;
      for (int cc = g; cc < c0; cc += 8) v += col[cc];
#pragma unroll
      for (int d = 4; d > 0; d >>= 1) v += __shfl_xor_sync(FULL, v, d);
      if (g < FWD_CHUNKS && kk < kt) {
        for (int w = 0; w < g && c0 + w < n_chunks; ++w) v += col[c0 + w];
        carries[kk][g] = v;
      }
    }
    __syncthreads();

    if (active) {
      for (int kk = half; kk < kt; kk += 2) {
        float ef[4], term[4] = {0.f, 0.f, 0.f, 0.f};
        bool keep[4];
        bool any = false;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float* fk = f_s + p.lo[q] * kt + kk;
          ef[q] = env_f_of(make_float2(fk[0], fk[kt]), p.frac[q]);
          keep[q] = ef[q] < nyquist;
          any |= keep[q];
        }
        if (DEBUG || __any_sync(FULL, any)) {  // else +-0 for every sample
          float inc[4];
          double own = 0.0;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            inc[q] = __fmul_rn(ef[q], omega_scale);
            own += static_cast<double>(inc[q]);
          }
          // the lanes' exclusive prefix (exact): shuffles within groups of 8
          // lanes, the groups' totals through shared memory
          double incl = own;
#pragma unroll
          for (int d = 1; d < 8; d <<= 1) {
            const double u = __shfl_up_sync(FULL, incl, d, 8);
            if ((lane & 7) >= d) incl += u;
          }
          __syncwarp();
          if ((lane & 7) == 7) groups[warp][lane >> 3] = incl;
          __syncwarp();
          double run = carries[kk][chunk] + (incl - own);
#pragma unroll
          for (int g = 0; g < 3; ++g)
            if (g < (lane >> 3)) run += groups[warp][g];

          float ea[4], ph[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            run += static_cast<double>(inc[q]);
            ph[q] = __double2float_rn(run);
            ea[q] = 0.f;
            if (keep[q]) {
              const float* ak = a_s + p.j[q] * kt + kk;
              ea[q] = env_a_of(make_float2(ak[0], ak[kt]), p.rise[q], p.fall[q]);
              term[q] = __fmul_rn(ea[q], sinf(ph[q]));
            }
          }
          if (DEBUG) {
            const size_t o = ((size_t)b * n_sin + k0 + kk) * n_samples + t0;
            store4(env_f_dbg + o, ef);
            store4(env_a_dbg + o, ea);
            store4(phase_dbg + o, ph);
          }
        }
        // +0 where the mask zeroes the product: the accumulator, which starts
        // at +0 and so is never -0, does not change
        store4(chunk_terms + kk * CHUNK + 4 * lane, term);
      }
    }
    __syncthreads();
    if (active) {
      for (int kk = 0; kk < kt; ++kk) {
        const float2 t2 = *reinterpret_cast<const float2*>(chunk_terms + kk * CHUNK + s0);
        acc[0] = __fadd_rn(acc[0], t2.x);
        acc[1] = __fadd_rn(acc[1], t2.y);
      }
    }
  }
  if (active)
    *reinterpret_cast<float2*>(audio + (size_t)b * n_samples + c * CHUNK + s0) =
        make_float2(acc[0], acc[1]);
}

// ---------------------------------------------------------------------------
// Backward. For one (clip b, harmonic k) lane and the audio cotangent dout:
//   d_env_a[t] = keep[t] * dout[b,t] * sin(phase[t])   (keep = env_f < nyquist)
//   d_phase[t] = (dout[b,t] * env_a[t]) * cos(phase[t])
//   d_omega[t] = f32( sum_{s >= t} d_phase[s] )          (float64 suffix)
//   d_env_f[t] = d_omega[t] * omega_scale
//   d_f[lo[t]] += d_env_f - frac*d_env_f,  d_f[hi[t]] += frac*d_env_f
//   d_a[j+1] += w[r] d_env_a,  d_a[j] += w[hop+r] d_env_a   (t = j*hop + r)
// with the endpoint-duplicated frame a[F] = a[F-1] folded into d_a[F-1].
// The Nyquist mask is piecewise constant: it passes no gradient to env_f.
//
// This is the function autograd computes through the plain version
// (ops/kernels/synth.py:synth_render_plain): the phase is the forward's, and
// d_omega is the float64 reversed cumsum that autograd of ops/scan.prefix_sum
// gives, summed here in another (fixed) order, so fp-close to it.
//
// Design. The TPU kernel runs 128-sample chunks in reverse with one-hot
// matmuls for the frame transposes. Here one block owns one lane, so the
// suffix over the whole clip stays inside the block. NT = min(512, T/4)
// threads; thread i owns R runs of 4 consecutive samples, run r at
// t = r*4*NT + 4*i (16-byte loads of the tables and dout, 16-byte stores to
// shared memory: coalesced, conflict-free). Pass 1 evaluates the envelopes
// once into registers; a float64 scan of every run's increment sum gives
// each run its phase carry (rows of 4*NT samples: warp shuffles, warp 0's
// scan of the warp totals, the row totals); pass 2 runs sincosf only where
// env_f < nyquist (else both products are 0) and writes each sample's
// weighted d_env_a for its two OLA frames; a mirrored scan of the runs'
// d_phase sums gives each run its suffix, and pass 3 walks the run
// backwards into d_env_f and its two bilinear shares. Then one warp per
// frame sums the contiguous sample ranges of its d_freqs and d_amps (host
// tables of the bilinear ranges), five sums side by side, each in sample
// order and a shuffle tree. The order of every float64 sum is fixed
// (transcribed in tests/test_torch_synth_plan.py): two launches agree bit
// for bit, no atomics. A segment tiling of the same function, with a pass
// of its own for the suffix carry, measured 2.2x slower on an H100 (PERF.md).
//
// Bound on the H100: operations, as the forward's (the same envelope and
// phase arithmetic, sincosf where the mask keeps the sample and the suffix;
// inputs are the 1 MB audio cotangent and ~0.2 MB of controls and tables).
// ---------------------------------------------------------------------------

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(FULL, v, d);
  return v;
}

// The two scans below keep, per row r of 4 * NT samples, the warp totals in
// wsum[r][w], and each row's total in wsum[r][BWD_MAX_NT / 32]. Every thread
// of the block must make the call.
constexpr int WSUM = BWD_MAX_NT / 32 + 1;

// Exclusive prefix, over time, of each run's value own[r] (run r of thread
// i at r*4*NT + 4*i): the lanes' shfl_up scan, warp 0's scan of the warp
// totals, then the earlier rows.
template <int R>
__device__ __forceinline__ void runs_excl_prefix(const double (&own)[R], double (&out)[R],
                                                 double (*wsum)[WSUM]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  double excl[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    double incl = own[r];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const double u = __shfl_up_sync(FULL, incl, d);
      if (lane >= d) incl += u;
    }
    excl[r] = __shfl_up_sync(FULL, incl, 1);
    if (lane == 0) excl[r] = 0.0;
    if (lane == 31) wsum[r][warp] = incl;
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      double incl = lane < nw ? wsum[r][lane] : 0.0;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const double u = __shfl_up_sync(FULL, incl, d);
        if (lane >= d) incl += u;
      }
      const double before = __shfl_up_sync(FULL, incl, 1);
      if (lane < nw) wsum[r][lane] = lane == 0 ? 0.0 : before;
      if (lane == 31) wsum[r][WSUM - 1] = incl;
    }
  }
  __syncthreads();
  double rows = 0.0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    out[r] = rows + wsum[r][warp] + excl[r];
    rows += wsum[r][WSUM - 1];
  }
  __syncthreads();
}

// Exclusive suffix, over time, of each run's value own[r]: the sum over every
// later sample, in this fixed order: a shfl_down tree over the lanes, the
// same tree over the warp totals (warp 0, the totals of warps >= NT / 32
// taken as 0), the rows from the last down; out[r] = (later rows + later
// warps) + later lanes.
template <int R>
__device__ __forceinline__ void runs_excl_suffix(const double (&own)[R], double (&out)[R],
                                                 double (*wsum)[WSUM]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  double excl[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    double incl = own[r];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const double u = __shfl_down_sync(FULL, incl, d);
      if (lane + d < 32) incl += u;
    }
    excl[r] = __shfl_down_sync(FULL, incl, 1);
    if (lane == 31) excl[r] = 0.0;
    if (lane == 0) wsum[r][warp] = incl;
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      double incl = lane < nw ? wsum[r][lane] : 0.0;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const double u = __shfl_down_sync(FULL, incl, d);
        if (lane + d < 32) incl += u;
      }
      const double after = __shfl_down_sync(FULL, incl, 1);
      if (lane < nw) wsum[r][lane] = lane == 31 ? 0.0 : after;
      if (lane == 0) wsum[r][WSUM - 1] = incl;
    }
  }
  __syncthreads();
  double rows = 0.0;
#pragma unroll
  for (int r = R - 1; r >= 0; --r) {
    out[r] = (rows + wsum[r][warp]) + excl[r];
    rows += wsum[r][WSUM - 1];
  }
  __syncthreads();
}

// grid batch * n_sin, NT = min(512, T / 4) threads, R runs each (R * 4 * NT >= T);
// up to T = 4096 two blocks of 512 threads fit an SM (64 registers a thread)
template <int R>
__global__ void __launch_bounds__(BWD_MAX_NT, R < 4 ? 2 : 1)
synth_bwd_kernel(const float* __restrict__ amps, const float* __restrict__ freqs,
                 const int* __restrict__ lo_idx, const float* __restrict__ frac,
                 const float* __restrict__ window, const int* __restrict__ lo_start,
                 const int* __restrict__ hi_start, const float* __restrict__ dout,
                 float* __restrict__ d_amps, float* __restrict__ d_freqs, int n_frames,
                 int n_sin, int n_samples, float nyquist, float omega_scale) {
  // each sample's contributions to its frames, [n_samples] each:
  extern __shared__ __align__(16) float dyn[];
  float* s_lo = dyn;                    // d_env_f - frac * d_env_f (to lo)
  float* s_hi = dyn + n_samples;        // frac * d_env_f (to lo + 1)
  float* s_fall = dyn + 2 * n_samples;  // w[hop + r] * d_env_a (to j)
  float* s_rise = dyn + 3 * n_samples;  // w[r] * d_env_a (to j + 1)
  __shared__ float f_s[MAX_FRAMES];
  __shared__ float a_s[MAX_FRAMES + 1];
  __shared__ double wsum[R][WSUM];

  const int lane = blockIdx.x;  // b * n_sin + k
  const int b = lane / n_sin;
  const int k = lane - b * n_sin;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int warp = tid >> 5;
  const int lane_id = tid & 31;

  for (int j = tid; j < n_frames; j += nt) {
    const size_t src = ((size_t)b * n_frames + j) * n_sin + k;
    f_s[j] = freqs[src];
    a_s[j] = amps[src];
  }
  __syncthreads();
  if (tid == 0) a_s[n_frames] = a_s[n_frames - 1];
  __syncthreads();

  const int hop = n_samples / n_frames;
  const float* g = dout + (size_t)b * n_samples;

  // pass 1: envelopes and increments, once per sample
  Taps p[R];
  float inc[R][4], ea[R][4];
  unsigned keep = 0;  // bit 4r + q
  double own[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int t0 = r * 4 * nt + 4 * tid;
    own[r] = 0.0;
#pragma unroll
    for (int q = 0; q < 4; ++q) inc[r][q] = ea[r][q] = 0.f;
    if (t0 < n_samples) {
      p[r] = load_taps(lo_idx, frac, window, hop, t0);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float ef =
            env_f_of(make_float2(f_s[p[r].lo[q]], f_s[p[r].lo[q] + 1]), p[r].frac[q]);
        if (ef < nyquist) {
          keep |= 1u << (4 * r + q);
          ea[r][q] = env_a_of(make_float2(a_s[p[r].j[q]], a_s[p[r].j[q] + 1]), p[r].rise[q],
                              p[r].fall[q]);
        }
        inc[r][q] = __fmul_rn(ef, omega_scale);
        own[r] += static_cast<double>(inc[r][q]);
      }
    }
  }
  double run[R];
  runs_excl_prefix<R>(own, run, wsum);

  // pass 2: d_env_a, d_phase (sincosf only where the mask keeps the sample)
  float dph[R][4];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int t0 = r * 4 * nt + 4 * tid;
    float gt[4] = {0.f, 0.f, 0.f, 0.f}, fall[4], rise[4];
    if (t0 < n_samples) {
      const float4 g4 = *reinterpret_cast<const float4*>(g + t0);
      gt[0] = g4.x, gt[1] = g4.y, gt[2] = g4.z, gt[3] = g4.w;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      run[r] += static_cast<double>(inc[r][q]);
      float da = 0.f;
      dph[r][q] = 0.f;
      if (keep & (1u << (4 * r + q))) {
        float s, co;
        sincosf(__double2float_rn(run[r]), &s, &co);
        da = __fmul_rn(gt[q], s);
        dph[r][q] = __fmul_rn(__fmul_rn(gt[q], ea[r][q]), co);
      }
      fall[q] = __fmul_rn(p[r].fall[q], da);
      rise[q] = __fmul_rn(p[r].rise[q], da);
    }
    if (t0 < n_samples) {
      store4(s_fall + t0, fall);
      store4(s_rise + t0, rise);
    }
    // the run's d_phase sum, last sample first
    own[r] = static_cast<double>(dph[r][3]);
    own[r] += static_cast<double>(dph[r][2]);
    own[r] += static_cast<double>(dph[r][1]);
    own[r] += static_cast<double>(dph[r][0]);
  }
  double suf[R];
  runs_excl_suffix<R>(own, suf, wsum);

  // pass 3: d_env_f from the float64 suffix, walking each run backwards
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int t0 = r * 4 * nt + 4 * tid;
    float to_lo[4], to_hi[4];
#pragma unroll
    for (int q = 3; q >= 0; --q) {
      suf[r] += static_cast<double>(dph[r][q]);
      const float d = __fmul_rn(__double2float_rn(suf[r]), omega_scale);
      to_hi[q] = __fmul_rn(p[r].frac[q], d);
      to_lo[q] = __fsub_rn(d, to_hi[q]);
    }
    if (t0 < n_samples) {
      store4(s_lo + t0, to_lo);
      store4(s_hi + t0, to_hi);
    }
  }
  __syncthreads();

  // frame sums, one warp per frame f: d_freqs[f] from the samples whose lo
  // (hi) is f, d_amps[f] from the fall taps of OLA chunk f, the rise taps of
  // chunk f-1 and, for the last frame, the rise taps of chunk F-1 (the
  // endpoint-duplicated frame). Five sums, each lane-strided in sample order
  // and then a shuffle tree, run side by side.
  for (int f = warp; f < n_frames; f += nt >> 5) {
    const int lo0 = lo_start[f], lo1 = lo_start[f + 1];
    const int hi0 = hi_start[f], hi1 = hi_start[f + 1];
    const int fall0 = f * hop;
    const int rise0 = f > 0 ? (f - 1) * hop : 0, rise1 = f > 0 ? f * hop : 0;
    const int end1 = f == n_frames - 1 ? (f + 1) * hop : fall0;
    const int span = max(max(lo1 - lo0, hi1 - hi0), hop);
    float to_f = 0.f, to_f_hi = 0.f, fall = 0.f, rise = 0.f, end = 0.f;
    for (int i = lane_id; i < span; i += 32) {
      if (lo0 + i < lo1) to_f += s_lo[lo0 + i];
      if (hi0 + i < hi1) to_f_hi += s_hi[hi0 + i];
      if (i < hop) fall += s_fall[fall0 + i];
      if (rise0 + i < rise1) rise += s_rise[rise0 + i];
      if (fall0 + i < end1) end += s_rise[fall0 + i];
    }
    to_f = warp_sum(to_f) + warp_sum(to_f_hi);
    fall = warp_sum(fall) + warp_sum(rise) + warp_sum(end);
    if (lane_id == 0) {
      d_freqs[((size_t)b * n_frames + f) * n_sin + k] = to_f;
      d_amps[((size_t)b * n_frames + f) * n_sin + k] = fall;
    }
  }
}

// Opt in to more than 48 KB of shared memory (static + dynamic) where needed.
template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, size_t dynamic_bytes) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess || attr.sharedSizeBytes + dynamic_bytes <= 48 * 1024) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)dynamic_bytes);
}

}  // namespace

// amps, freqs [batch, n_frames, n_sin] f32; lo_idx [n_samples] int32;
// frac [n_samples] f32; window [2 * n_samples / n_frames] f32; totals
// [batch, n_sin, n_samples / 128] float64 scratch; audio [batch, n_samples];
// env_f_dbg / env_a_dbg / phase_dbg [batch, n_sin, n_samples] or all null.
// Requires batch >= 1, n_sin >= 1, n_samples % 256 == 0, n_samples <= 8192,
// 2 <= n_frames <= 128 and n_samples % n_frames == 0 (checked by the Python
// wrapper). Returns cudaGetLastError() of the launches.
extern "C" int synth_forward_f32(const float* amps, const float* freqs, const int* lo_idx,
                                 const float* frac, const float* window, double* totals,
                                 float* audio, float* env_f_dbg, float* env_a_dbg,
                                 float* phase_dbg, int batch, int n_frames, int n_sin,
                                 int n_samples, float nyquist, float omega_scale,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int kt = n_sin < KT_MAX ? n_sin : KT_MAX;
  const size_t tot_smem = (size_t)kt * n_frames * sizeof(float);
  const dim3 grid(batch, (n_samples / CHUNK + FWD_CHUNKS - 1) / FWD_CHUNKS);
  cudaError_t err = allow_shared(synth_phase_totals_kernel, tot_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  synth_phase_totals_kernel<<<grid, FWD_NT, tot_smem, s>>>(freqs, lo_idx, frac, totals, n_frames,
                                                           n_sin, n_samples, omega_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = (size_t)kt * (n_samples / CHUNK) * sizeof(double) +
                      ((size_t)FWD_CHUNKS * kt * CHUNK + (2 * (size_t)n_frames + 1) * kt) *
                          sizeof(float);
  if (env_f_dbg != nullptr) {
    err = allow_shared(synth_fwd_kernel<true>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    synth_fwd_kernel<true><<<grid, FWD_NT, smem, s>>>(
        amps, freqs, lo_idx, frac, window, totals, audio, env_f_dbg, env_a_dbg, phase_dbg,
        n_frames, n_sin, n_samples, nyquist, omega_scale);
  } else {
    err = allow_shared(synth_fwd_kernel<false>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    synth_fwd_kernel<false><<<grid, FWD_NT, smem, s>>>(
        amps, freqs, lo_idx, frac, window, totals, audio, nullptr, nullptr, nullptr, n_frames,
        n_sin, n_samples, nyquist, omega_scale);
  }
  return static_cast<int>(cudaGetLastError());
}

// amps, freqs [batch, n_frames, n_sin] f32 (the forward's inputs); lo_idx,
// frac, window as for synth_forward_f32; lo_start / hi_start [n_frames + 1]
// int32: the samples t with lo[t] == f (hi[t] == f) are
// [lo_start[f], lo_start[f+1]); dout [batch, n_samples] f32;
// d_amps, d_freqs [batch, n_frames, n_sin] f32. Same shape limits as the
// forward. Returns cudaGetLastError() of the launch.
extern "C" int synth_backward_f32(const float* amps, const float* freqs, const int* lo_idx,
                                  const float* frac, const float* window, const int* lo_start,
                                  const int* hi_start, const float* dout, float* d_amps,
                                  float* d_freqs, int batch, int n_frames, int n_sin,
                                  int n_samples, float nyquist, float omega_scale,
                                  void* stream) {
  const size_t shmem = 4 * (size_t)n_samples * sizeof(float);
  const int nt = n_samples / 4 < BWD_MAX_NT ? n_samples / 4 : BWD_MAX_NT;
  const int rows = (n_samples + 4 * nt - 1) / (4 * nt);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
#define SYNTH_BWD_LAUNCH(R)                                                                   \
  err = allow_shared(synth_bwd_kernel<R>, shmem);                                             \
  if (err != cudaSuccess) return static_cast<int>(err);                                       \
  synth_bwd_kernel<R><<<batch * n_sin, nt, shmem, s>>>(amps, freqs, lo_idx, frac, window,     \
                                                       lo_start, hi_start, dout, d_amps,      \
                                                       d_freqs, n_frames, n_sin, n_samples,   \
                                                       nyquist, omega_scale)
  if (rows == 1) {
    SYNTH_BWD_LAUNCH(1);
  } else if (rows == 2) {
    SYNTH_BWD_LAUNCH(2);
  } else {
    SYNTH_BWD_LAUNCH(4);
  }
#undef SYNTH_BWD_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
