// STFT frontend for Hopper (sm_90a): pad_end framing + window + real FFT of
// each frame, float32 (kernel B9).
//
// Replaces the TPU kernel sot_tpu/ops/pallas/stft.py:_frontend_kernel (entry
// _project_pallas).
//
//   proj[b, c, :] = rfft(window * frame_c(audio[b]))  as [re | im], n/2 + 1 each
//
// with audio [batch, T], frame c = samples [c*hop, c*hop + n), zeros past T
// (tf-style pad_end framing: C = T / hop frames when hop divides T).
//
// Bound on the H100: bytes. At the loss STFT of SOT-2048 (2048/256, 64 clips,
// 1024 frames) the function is ~60 MFLOP of FFTs against ~9.4 MB of audio read
// and spectra written, ~0.003 ms. The TPU kernel computes the dense DFT as a
// matmul (8.6 GFLOP at that shape) because its matrix unit makes that cheap;
// the H100 has no such reason, so this kernel computes the FFT itself.
//
// Design. Each 64-thread block takes whole frames: P complex points per
// thread held in registers (P = 16 for n >= 1024, 8 below, so that even the
// smallest STFT has a warp per frame), N/P threads per frame (N = n/2). Each
// frame is packed as z[j] = x[2j] + i x[2j+1], read straight from the audio
// (the pad_end mask applied) and multiplied by the f32 window. An N-point
// complex FFT follows as Stockham passes (autosort, no bit reversal): radix
// P while it divides what is left, then one pass of the remaining radix (2
// or 4); a radix-16 or radix-8 butterfly is a 4 x 4 or 4 x 2 decomposition
// in registers. The first pass works on the values read from the audio;
// between passes the frame sits in shared memory, in two buffers used in
// turn (one barrier per pass), skewed by one point in 16 so that the
// stride-P writes hit distinct banks. Each pass loads its twiddles before its barrier, so their
// latency hides behind the wait. The real spectrum follows from Z by the
// post-twiddle, two bins k and N-k at a time:
//   E[k] = (Z[k] + conj Z[N-k]) / 2,  O[k] = (Z[k] - conj Z[N-k]) / 2i,
//   t = exp(-2 pi i k / n) O[k],  X[k] = E[k] + t,  X[N-k] = conj(E[k] - t),
// written as the row's re and im halves (row stride 2(N+1) floats, so
// scalar stores: no row is assumed 16-byte aligned). The pass twiddles and
// the post-twiddle come from a table exp(-2 pi i m / n), m < n, computed in
// float64 on the host and rounded once to f32; the radix-8 and radix-16
// butterflies' own constants are decimal literals of cos(pi/8), sin(pi/8)
// and cos(pi/4), rounded once by the compiler (no fast-math sines). One
// launch per STFT, no scratch. n = 256, 512, 1024 or 2048; any other n is
// refused.
//
// Measured on the H100: every frame's block is resident at once (one wave),
// so the loads, the passes and the stores of all frames run as three phases
// with little overlap; cutting the instruction count or doubling the warps
// per SM did not move the time. It sits between cuFFT's time for the FFT
// alone and 1.4x it (PERF.md).

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int NT = 64;  // two warps: one frame of N = 1024, more of smaller N

// complex points per thread for an N-point transform
__host__ __device__ constexpr int points(int n) { return n >= 512 ? 16 : 8; }

// exp(-2 pi i m / 16), m = 1, 2, 3 (the rest follow by symmetry)
constexpr float C1 = 0.923879532511286756128f;  // cos(pi/8)
constexpr float S1 = 0.382683432365089771728f;  // sin(pi/8)
constexpr float C2 = 0.707106781186547524401f;  // cos(pi/4)

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(fmaf(a.x, b.x, -a.y * b.y), fmaf(a.x, b.y, a.y * b.x));
}
__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 mul_neg_i(float2 a) { return make_float2(a.y, -a.x); }

// In-place DFT of v[0], v[s], v[2s], v[3s]: X_r = sum_q v_q (-i)^(r q).
template <int S>
__device__ __forceinline__ void dft4(float2* v) {
  const float2 s02 = cadd(v[0], v[2 * S]), d02 = csub(v[0], v[2 * S]);
  const float2 s13 = cadd(v[S], v[3 * S]), d13 = mul_neg_i(csub(v[S], v[3 * S]));
  v[0] = cadd(s02, s13);
  v[S] = cadd(d02, d13);
  v[2 * S] = csub(s02, s13);
  v[3 * S] = csub(d02, d13);
}

// v * exp(-2 pi i m / 16), m a compile-time constant
template <int M>
__device__ __forceinline__ float2 w16(float2 v) {
  constexpr int m = M % 16;
  if (m == 0) return v;
  if (m == 4) return mul_neg_i(v);
  if (m == 8) return make_float2(-v.x, -v.y);
  if (m == 12) return make_float2(-v.y, v.x);
  // exp(-i pi mm / 8) for mm = m mod 4 in 1..3, then (-i)^quad for quad = m / 4
  constexpr int quad = m / 4, mm = m % 4;
  const float2 w = make_float2(mm == 1 ? C1 : mm == 2 ? C2 : S1,
                               -(mm == 1 ? S1 : mm == 2 ? C2 : C1));
  float2 r = cmul(v, w);
  if (quad == 1) r = mul_neg_i(r);
  if (quad == 2) r = make_float2(-r.x, -r.y);
  if (quad == 3) r = make_float2(-r.y, r.x);
  return r;
}

// In-place DFT of R = 4Q points v[0..R) (natural order in and out), as
// X[k1 + 4 k2] = sum_n2 W_R^(n2 k1) W_Q^(n2 k2) sum_n1 v[Q n1 + n2] W_4^(n1 k1).
template <int R>
__device__ __forceinline__ void dft(float2* v) {
  if constexpr (R == 2) {
    const float2 a = v[0], b = v[1];
    v[0] = cadd(a, b);
    v[1] = csub(a, b);
  } else if constexpr (R == 4) {
    dft4<1>(v);
  } else {
    constexpr int Q = R / 4;
#pragma unroll
    for (int n2 = 0; n2 < Q; ++n2) dft4<Q>(v + n2);  // y[n2][k1] at v[Q k1 + n2]
    // twiddles W_R^(n2 k1) = W_16^(n2 k1 16 / R)
#pragma unroll
    for (int n2 = 1; n2 < Q; ++n2) {
#pragma unroll
      for (int k1 = 1; k1 < 4; ++k1) {
        float2& y = v[Q * k1 + n2];
        const int m = n2 * k1 * (16 / R);
        y = m == 1 ? w16<1>(y) : m == 2 ? w16<2>(y) : m == 3 ? w16<3>(y)
          : m == 4 ? w16<4>(y) : m == 6 ? w16<6>(y) : w16<9>(y);
      }
    }
    float2 out[R];
#pragma unroll
    for (int k1 = 0; k1 < 4; ++k1) {
      float2* y = v + Q * k1;  // y[n2] = v[Q k1 + n2]
      if constexpr (Q == 2) {
        out[k1] = cadd(y[0], y[1]);
        out[k1 + 4] = csub(y[0], y[1]);
      } else {
        dft4<1>(y);
#pragma unroll
        for (int k2 = 0; k2 < 4; ++k2) out[k1 + 4 * k2] = y[k2];
      }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) v[i] = out[i];
  }
}

// the frame's point p in a skewed shared buffer
__device__ __forceinline__ int sk(int p) { return p + (p >> 4); }

// One Stockham pass of radix R over a frame of N points (P per thread) whose
// sub-transforms have size ns: each of the thread's P / R butterflies j = lt
// + b N/P takes x[b R + r] = z[j + r N/R], twiddles it by exp(-2 pi i k r /
// (R ns)), k = j mod ns, transforms it and writes it to dst at z[(j - k) R +
// k + r ns]. With src the inputs are read from there after a barrier (their
// twiddles are loaded before it); without, x holds them already.
template <int N, int P, int R>
__device__ __forceinline__ void pass(const float2* src, float2* dst, float2 (&x)[P], int lt,
                                     int ns, const float2* __restrict__ twiddle) {
  constexpr int TPF = N / P, B = P / R, S = N / R;
  float2 w[B][R];
  if (ns > 1) {
#pragma unroll
    for (int b = 0; b < B; ++b) {
      const int k = (lt + b * TPF) & (ns - 1);
      const int step = k * (2 * N / (R * ns));  // twiddle[m] = exp(-2 pi i m / 2N)
#pragma unroll
      for (int r = 1; r < R; ++r) w[b][r] = twiddle[r * step];
    }
  }
  if (src != nullptr) {
    __syncthreads();
#pragma unroll
    for (int b = 0; b < B; ++b)
#pragma unroll
      for (int r = 0; r < R; ++r) x[b * R + r] = src[sk(lt + b * TPF + r * S)];
  }
#pragma unroll
  for (int b = 0; b < B; ++b) {
    const int j = lt + b * TPF;
    const int k = j & (ns - 1);
    if (ns > 1) {
#pragma unroll
      for (int r = 1; r < R; ++r) x[b * R + r] = cmul(x[b * R + r], w[b][r]);
    }
    dft<R>(x + b * R);
    const int d = (j - k) * R + k;
#pragma unroll
    for (int r = 0; r < R; ++r) dst[sk(d + r * ns)] = x[b * R + r];
  }
}

// The passes after the first, from sub-transforms of size NS: radix P
// while P NS <= N, then one of the remaining radix; reads src, writes dst,
// then the other way round. Returns the buffer that holds the transform.
template <int N, int P, int NS>
__device__ __forceinline__ const float2* passes(float2* src, float2* dst, float2 (&x)[P],
                                                int lt, const float2* __restrict__ twiddle) {
  if constexpr (NS * P <= N) {
    pass<N, P, P>(src, dst, x, lt, NS, twiddle);
    return passes<N, P, NS * P>(dst, src, x, lt, twiddle);
  } else if constexpr (NS < N) {
    pass<N, P, N / NS>(src, dst, x, lt, NS, twiddle);
    return dst;
  } else {
    return src;
  }
}

// N complex points per frame; twiddle[m] = exp(-2 pi i m / (2N)), m < 2N.
// Passes: radix P while the sub-transforms allow, then the remaining radix.
template <int N>
__global__ void __launch_bounds__(NT)
stft_frontend_fft_kernel(const float* __restrict__ audio, const float* __restrict__ window,
                         const float2* __restrict__ twiddle, float* __restrict__ out, int t,
                         int n_frames, int hop, int m_rows) {
  constexpr int P = points(N);
  constexpr int TPF = N / P;                // threads per frame
  constexpr int FPB = NT / TPF;             // frames per block
  constexpr int LD = N + N / 16;            // skewed frame length
  constexpr int PAIRS = N / 2 / TPF + 1;    // (k, N - k) pairs per thread, k <= N/2
  __shared__ float2 smem[2][FPB * LD];

  const int lf = threadIdx.x / TPF;
  const int lt = threadIdx.x - lf * TPF;
  const int m = blockIdx.x * FPB + lf;
  const bool live = m < m_rows;
  int b = 0, f = 0;
  if (live) {
    b = m / n_frames;
    f = m - b * n_frames;
  }
  const float* src = audio + (size_t)b * t + (size_t)f * hop;
  const int left = live ? t - f * hop : 0;  // samples from the frame's start to the end
  float2* buf0 = smem[0] + lf * LD;
  float2* buf1 = smem[1] + lf * LD;

  // the first pass (ns = 1) takes z[lt + r N/P] from the audio
  float2 x[P];
#pragma unroll
  for (int r = 0; r < P; ++r) {
    const int p = lt + r * TPF;
    float2 v = make_float2(0.f, 0.f);
    if (2 * p < left) {  // t is even: a pair lies wholly inside or past the end
      const float2 a = *reinterpret_cast<const float2*>(src + 2 * p);
      const float2 w = *reinterpret_cast<const float2*>(window + 2 * p);
      v = make_float2(a.x * w.x, a.y * w.y);
    }
    x[r] = v;
  }
  pass<N, P, P>(nullptr, buf0, x, lt, 1, twiddle);
  const float2* z = passes<N, P, P>(buf0, buf1, x, lt, twiddle);

  float2 w[PAIRS];
#pragma unroll
  for (int i = 0; i < PAIRS; ++i) {
    const int k = lt + i * TPF;
    w[i] = twiddle[k <= N / 2 ? k : 0];
  }
  __syncthreads();
  if (!live) return;
  float* row = out + (size_t)m * (2 * (N + 1));
#pragma unroll
  for (int i = 0; i < PAIRS; ++i) {
    const int k = lt + i * TPF;
    if (k > N / 2) break;
    const float2 zk = z[sk(k & (N - 1))];
    const float2 zn = z[sk((N - k) & (N - 1))];
    const float er = 0.5f * (zk.x + zn.x), ei = 0.5f * (zk.y - zn.y);
    const float orr = 0.5f * (zk.y + zn.y), oi = -0.5f * (zk.x - zn.x);
    const float tr = fmaf(w[i].x, orr, -w[i].y * oi), ti = fmaf(w[i].x, oi, w[i].y * orr);
    row[k] = er + tr;
    row[N + 1 + k] = ei + ti;
    row[N - k] = er - tr;
    row[2 * N + 1 - k] = ti - ei;
  }
}

template <int N>
int launch(const float* audio, const float* window, const float2* twiddle, float* out, int t,
           int n_frames, int hop, int m_rows, cudaStream_t s) {
  constexpr int FPB = NT / (N / points(N));
  stft_frontend_fft_kernel<N><<<(m_rows + FPB - 1) / FPB, NT, 0, s>>>(
      audio, window, twiddle, out, t, n_frames, hop, m_rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// audio [batch, t] f32 (t even); window [n_fft] f32; twiddle [n_fft] float2
// exp(-2 pi i m / n_fft); out [batch, n_frames, n_fft + 2]. Launches on
// `stream`; returns cudaGetLastError() of the launch, or cudaErrorInvalidValue
// for an n_fft other than 256, 512, 1024 or 2048.
extern "C" int stft_frontend_fft(const float* audio, const float* window, const float* twiddle,
                                 float* out, int batch, int t, int n_frames, int hop, int n_fft,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float2* tw = reinterpret_cast<const float2*>(twiddle);
  const int m_rows = batch * n_frames;
  switch (n_fft) {
    case 256: return launch<128>(audio, window, tw, out, t, n_frames, hop, m_rows, s);
    case 512: return launch<256>(audio, window, tw, out, t, n_frames, hop, m_rows, s);
    case 1024: return launch<512>(audio, window, tw, out, t, n_frames, hop, m_rows, s);
    case 2048: return launch<1024>(audio, window, tw, out, t, n_frames, hop, m_rows, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
