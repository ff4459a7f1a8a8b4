// Sinusoidal synth forward for Hopper (sm_90a).
//
// Replaces the TPU kernel sot_tpu/ops/pallas/synth.py:_fwd_kernel.
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
  __shared__ double warp_tot[NWARPS];
  __shared__ float out_s[MAX_SAMPLES];

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

  // exclusive block scan of the thread sums
  double incl = local;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const double v = __shfl_up_sync(FULL, incl, d);
    if (lane_id >= d) incl += v;
  }
  double excl = __shfl_up_sync(FULL, incl, 1);
  if (lane_id == 0) excl = 0.0;
  if (lane_id == 31) warp_tot[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    double w = lane_id < NWARPS ? warp_tot[lane_id] : 0.0;
#pragma unroll
    for (int d = 1; d < NWARPS; d <<= 1) {
      const double v = __shfl_up_sync(FULL, w, d);
      if (lane_id >= d) w += v;
    }
    if (lane_id < NWARPS) warp_tot[lane_id] = w;
  }
  __syncthreads();

  // pass 2: phase = carry + this thread's running sum; audio = env_a * sin(phase)
  double run = warp > 0 ? warp_tot[warp - 1] + excl : excl;
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
