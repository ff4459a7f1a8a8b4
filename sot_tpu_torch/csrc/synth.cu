// Sinusoidal synth forward and backward for Hopper (sm_90a).
//
// Replaces the TPU kernels sot_tpu/ops/pallas/synth.py:_fwd_kernel and
// :_bwd_kernel (the backward's notes are above synth_lane_bwd_kernel).
//
// Frame-rate controls -> audio, for amplitudes a[b, j, k] (already
// Nyquist-masked at frame rate) and harmonic frequencies f[b, j, k]:
//   env_f[t] = f_lo + frac[t] * (f_hi - f_lo)          (bilinear, exact taps)
//   env_a[t] = a[j+1] * w[r] + a[j] * w[hop + r]       (hann OLA, t = j*hop + r,
//                                                       a[F] = a[F-1])
//   env_a[t] = 0 where env_f[t] >= nyquist
//   phase[t] = sum_{s <= t} env_f[s] * (2*pi / sr)     (unwrapped)
//   audio[b, t] = sum_k env_a * sin(phase)
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
// ~1.3e4 rad, where one f32 ulp is ~1e-3 rad; an f32 prefix summed in any
// order drifts by several ulps over 4096 samples (a sequential f32 scan by
// ~1e-2 rad). The increments env_f * (2*pi/sr) are f32 products as in the
// reference; they are summed in float64 and each phase is rounded once to
// f32 — the same function as the plain version's float64-accumulated cumsum
// (ops/scan.py), which the two then agree on to the last bit but for rare
// ties of the final rounding.
//
// sinf, never __sinf: the fast intrinsic's range reduction fails at these
// phases.
//
// Bound on the H100: operations. Inputs are ~0.2 MB and the output 1 MB, so
// the bytes take well under a microsecond; the work is 64*20*4096 = 5.24 M
// lanes*samples of envelope arithmetic, a prefix sum and a full-range sinf.
// Design: one block per (batch, harmonic) lane; each thread owns 16
// consecutive samples, sums their increments, and a block-wide scan (warp
// shuffles, then the warp totals; float64) gives each thread its phase
// carry; a second pass recomputes the envelopes and writes
// env_a * sin(phase) through shared memory, coalesced. A second small kernel sums the harmonics of each clip
// in a fixed order (deterministic; no atomics).

#include <cuda_runtime.h>
#include <stddef.h>

#include "scan.cuh"

namespace {

constexpr int NT = 256;
constexpr int NWARPS = NT / 32;
constexpr int MAX_FRAMES = 128;
constexpr int MAX_SAMPLES = 8192;
constexpr unsigned FULL = 0xffffffffu;

struct LaneControls {
  const float* f_s;    // [n_frames]
  const float* a_s;    // [n_frames + 1], endpoint-duplicated
  const int* lo_idx;   // [n_samples]
  const float* frac;   // [n_samples]
  const float* window; // [2 * hop]
  int n_frames;
  int hop;
  float nyquist;
};

__device__ __forceinline__ void envelopes(const LaneControls& c, int t, float& env_f,
                                          float& env_a) {
  const int lo = c.lo_idx[t];
  const int hi = min(lo + 1, c.n_frames - 1);
  const float x_lo = c.f_s[lo];
  const float x_hi = c.f_s[hi];
  env_f = __fadd_rn(x_lo, __fmul_rn(c.frac[t], __fsub_rn(x_hi, x_lo)));
  const int j = t / c.hop;
  const int r = t - j * c.hop;
  const float rise = __fmul_rn(c.a_s[j + 1], c.window[r]);
  const float fall = __fmul_rn(c.a_s[j], c.window[c.hop + r]);
  env_a = env_f >= c.nyquist ? 0.f : __fadd_rn(rise, fall);
}

__global__ void __launch_bounds__(NT)
synth_lane_kernel(const float* __restrict__ amps, const float* __restrict__ freqs,
                  const int* __restrict__ lo_idx, const float* __restrict__ frac,
                  const float* __restrict__ window, float* __restrict__ contrib,
                  float* __restrict__ env_f_dbg, float* __restrict__ env_a_dbg,
                  int n_frames, int n_sin, int n_samples, float nyquist,
                  float omega_scale) {
  __shared__ float f_s[MAX_FRAMES];
  __shared__ float a_s[MAX_FRAMES + 1];
  __shared__ double warp_buf[NWARPS];
  __shared__ float out_s[MAX_SAMPLES];

  const int lane = blockIdx.x;  // b * n_sin + k
  const int b = lane / n_sin;
  const int k = lane - b * n_sin;
  const int tid = threadIdx.x;

  for (int j = tid; j < n_frames; j += NT) {
    const size_t src = ((size_t)b * n_frames + j) * n_sin + k;
    f_s[j] = freqs[src];
    a_s[j] = amps[src];
  }
  __syncthreads();
  if (tid == 0) a_s[n_frames] = a_s[n_frames - 1];
  __syncthreads();

  const LaneControls c{f_s, a_s, lo_idx, frac, window, n_frames, n_samples / n_frames,
                       nyquist};
  const int spt = n_samples / NT;
  const int t0 = tid * spt;

  // pass 1: this thread's sum of phase increments
  double local = 0.0;
  for (int i = 0; i < spt; ++i) {
    float env_f, env_a;
    envelopes(c, t0 + i, env_f, env_a);
    local += static_cast<double>(__fmul_rn(env_f, omega_scale));
  }

  // pass 2: phase = carry + this thread's running sum; audio = env_a * sin(phase)
  double run = block_excl_scan<NT>(local, warp_buf);
  const size_t base = (size_t)lane * n_samples;
  for (int i = 0; i < spt; ++i) {
    const int t = t0 + i;
    float env_f, env_a;
    envelopes(c, t, env_f, env_a);
    run += static_cast<double>(__fmul_rn(env_f, omega_scale));
    const float phase = __double2float_rn(run);
    out_s[t] = __fmul_rn(env_a, sinf(phase));
    if (env_f_dbg != nullptr) {
      env_f_dbg[base + t] = env_f;
      env_a_dbg[base + t] = env_a;
    }
  }
  __syncthreads();
  for (int t = tid; t < n_samples; t += NT) contrib[base + t] = out_s[t];
}

// audio[b, t] = sum_{k = 0, 1, ...} contrib[b, k, t]
__global__ void synth_sum_kernel(const float* __restrict__ contrib, float* __restrict__ audio,
                                 int batch, int n_sin, int n_samples) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= batch * n_samples) return;
  const int b = idx / n_samples;
  const int t = idx - b * n_samples;
  const float* src = contrib + (size_t)b * n_sin * n_samples + t;
  float acc = 0.f;
  for (int k = 0; k < n_sin; ++k) acc += src[(size_t)k * n_samples];
  audio[idx] = acc;
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
// (ops/kernels/synth.py:synth_render_plain): the phase is the forward's
// (f32 increments summed in float64, rounded once), and d_omega is the
// float64 reversed cumsum that autograd of ops/scan.prefix_sum's float64
// cumsum gives. The envelopes are recomputed bit-equal to ops/resample.py.
//
// Design. The TPU kernel runs 128-sample chunks in reverse with one-hot
// matmuls for the frame transposes (its VMEM holds one chunk at a time).
// Here one block owns one lane, as in the forward: pass 1 recomputes each
// thread's phase carry (block scan), pass 2 forms d_env_a and d_phase into
// shared memory (2 x T floats) and each thread's float64 sum of d_phase, a
// mirrored block scan gives each thread the suffix after its samples, and
// pass 3 walks the thread's samples backwards into d_env_f. Then one warp
// per output frame sums its contiguous sample range (host tables of the
// bilinear ranges) in a fixed order and a shuffle tree: deterministic, no
// atomics.
//
// Bound on the H100: operations, as the forward's (the same envelope and
// phase arithmetic plus sincosf and the suffix; inputs are the 1 MB audio
// cotangent and ~0.2 MB of controls and tables).
// ---------------------------------------------------------------------------

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(FULL, v, d);
  return v;
}

__global__ void __launch_bounds__(NT)
synth_lane_bwd_kernel(const float* __restrict__ amps, const float* __restrict__ freqs,
                      const int* __restrict__ lo_idx, const float* __restrict__ frac,
                      const float* __restrict__ window, const int* __restrict__ lo_start,
                      const int* __restrict__ hi_start, const float* __restrict__ dout,
                      float* __restrict__ d_amps, float* __restrict__ d_freqs,
                      int n_frames, int n_sin, int n_samples, float nyquist,
                      float omega_scale) {
  extern __shared__ float dyn[];
  float* s_da = dyn;              // [n_samples]: d_env_a
  float* s_df = dyn + n_samples;  // [n_samples]: d_phase, then d_env_f
  __shared__ float f_s[MAX_FRAMES];
  __shared__ float a_s[MAX_FRAMES + 1];
  __shared__ double warp_buf[NWARPS];
  __shared__ double mirror[NT];

  const int lane = blockIdx.x;  // b * n_sin + k
  const int b = lane / n_sin;
  const int k = lane - b * n_sin;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane_id = tid & 31;

  for (int j = tid; j < n_frames; j += NT) {
    const size_t src = ((size_t)b * n_frames + j) * n_sin + k;
    f_s[j] = freqs[src];
    a_s[j] = amps[src];
  }
  __syncthreads();
  if (tid == 0) a_s[n_frames] = a_s[n_frames - 1];
  __syncthreads();

  const int hop = n_samples / n_frames;
  const LaneControls c{f_s, a_s, lo_idx, frac, window, n_frames, hop, nyquist};
  const int spt = n_samples / NT;
  const int t0 = tid * spt;
  const float* g = dout + (size_t)b * n_samples;

  // pass 1: the phase carry into this thread's samples
  double local = 0.0;
  for (int i = 0; i < spt; ++i) {
    float env_f, env_a;
    envelopes(c, t0 + i, env_f, env_a);
    local += static_cast<double>(__fmul_rn(env_f, omega_scale));
  }
  double run = block_excl_scan<NT>(local, warp_buf);

  // pass 2: d_env_a, d_phase, and this thread's sum of d_phase
  double dsum = 0.0;
  for (int i = 0; i < spt; ++i) {
    const int t = t0 + i;
    float env_f, env_a;
    envelopes(c, t, env_f, env_a);
    run += static_cast<double>(__fmul_rn(env_f, omega_scale));
    float s, co;
    sincosf(__double2float_rn(run), &s, &co);
    const float gt = g[t];
    s_da[t] = env_f >= nyquist ? 0.f : __fmul_rn(gt, s);
    const float dph = __fmul_rn(__fmul_rn(gt, env_a), co);
    s_df[t] = dph;
    dsum += static_cast<double>(dph);
  }

  // suffix of d_phase after this thread's samples
  double suf = block_excl_suffix<NT>(dsum, warp_buf, mirror);

  // pass 3: d_env_f from the float64 suffix, in place of d_phase
  for (int i = spt - 1; i >= 0; --i) {
    const int t = t0 + i;
    suf += static_cast<double>(s_df[t]);
    s_df[t] = __fmul_rn(__double2float_rn(suf), omega_scale);
  }
  __syncthreads();

  // frame sums: tasks 0..F-1 are d_freqs, F..2F-1 are d_amps; one warp each
  for (int task = warp; task < 2 * n_frames; task += NWARPS) {
    float acc = 0.f;
    if (task < n_frames) {
      const int f = task;
      for (int t = lo_start[f] + lane_id; t < lo_start[f + 1]; t += 32) {
        const float d = s_df[t];
        acc += __fsub_rn(d, __fmul_rn(frac[t], d));
      }
      float acc_hi = 0.f;
      for (int t = hi_start[f] + lane_id; t < hi_start[f + 1]; t += 32)
        acc_hi += __fmul_rn(frac[t], s_df[t]);
      acc = warp_sum(acc) + warp_sum(acc_hi);
      if (lane_id == 0) d_freqs[((size_t)b * n_frames + f) * n_sin + k] = acc;
    } else {
      const int j = task - n_frames;
      // fall taps of chunk j, rise taps of chunk j-1, and for the last frame
      // the rise taps of chunk F-1 (the endpoint-duplicated frame)
      for (int r = lane_id; r < hop; r += 32)
        acc += __fmul_rn(window[hop + r], s_da[j * hop + r]);
      float rise = 0.f;
      if (j > 0)
        for (int r = lane_id; r < hop; r += 32)
          rise += __fmul_rn(window[r], s_da[(j - 1) * hop + r]);
      float end = 0.f;
      if (j == n_frames - 1)
        for (int r = lane_id; r < hop; r += 32)
          end += __fmul_rn(window[r], s_da[j * hop + r]);
      acc = warp_sum(acc) + warp_sum(rise) + warp_sum(end);
      if (lane_id == 0) d_amps[((size_t)b * n_frames + j) * n_sin + k] = acc;
    }
  }
}

}  // namespace

// amps, freqs [batch, n_frames, n_sin] f32; lo_idx [n_samples] int32;
// frac [n_samples] f32; window [2 * n_samples / n_frames] f32;
// contrib [batch, n_sin, n_samples] scratch; audio [batch, n_samples];
// env_f_dbg / env_a_dbg [batch, n_sin, n_samples] or null.
// Requires n_samples % 256 == 0, n_samples <= 8192, n_frames <= 128 and
// n_samples % n_frames == 0 (checked by the Python wrapper). Returns
// cudaGetLastError() of the launches.
extern "C" int synth_forward_f32(const float* amps, const float* freqs, const int* lo_idx,
                                 const float* frac, const float* window, float* contrib,
                                 float* audio, float* env_f_dbg, float* env_a_dbg, int batch,
                                 int n_frames, int n_sin, int n_samples, float nyquist,
                                 float omega_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  synth_lane_kernel<<<batch * n_sin, NT, 0, s>>>(amps, freqs, lo_idx, frac, window, contrib,
                                                 env_f_dbg, env_a_dbg, n_frames, n_sin,
                                                 n_samples, nyquist, omega_scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int total = batch * n_samples;
  synth_sum_kernel<<<(total + 255) / 256, 256, 0, s>>>(contrib, audio, batch, n_sin,
                                                        n_samples);
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
  const size_t shmem = 2 * (size_t)n_samples * sizeof(float);
  if (shmem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        synth_lane_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  synth_lane_bwd_kernel<<<batch * n_sin, NT, shmem, static_cast<cudaStream_t>(stream)>>>(
      amps, freqs, lo_idx, frac, window, lo_start, hi_start, dout, d_amps, d_freqs, n_frames,
      n_sin, n_samples, nyquist, omega_scale);
  return static_cast<int>(cudaGetLastError());
}
