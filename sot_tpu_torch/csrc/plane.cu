// Banded-plane SOT kernels for Hopper (sm_90a): the same-grid W_p^p value
// (forward) and its cotangents (backward).
//
// Replaces the TPU kernels sot_tpu/ops/pallas/sot.py:_fwd_kernel (entry
// _pallas_fwd) and _bwd_kernel (entry _pallas_bwd).
//
// Per row, with alpha, beta [n] the clipped augmented CDFs, gamma_i =
// alpha_{i-1}, delta_j = beta_{j-1} (gamma_0 = delta_0 = 0) and the grid g [n]:
//
//   mu_ij = relu(min(alpha_i, beta_j) - max(gamma_i, delta_j))
//   W     = sum_ij mu_ij |g_j - g_i|^p                            (forward)
//
// and, for the row weight wbar, the plane convention of _bwd_kernel
// (sot.py:180-197), cell by cell:
//
//   m  = [min(alpha_i, beta_j) > max(gamma_i, delta_j)]
//   k  = (m * |g_j - g_i|^p) * wbar
//   wa = 1, 0.5, 0 for alpha_i <, ==, > beta_j
//   wc = 1, 0.5, 0 for gamma_i >, ==, < delta_j
//   db_j += k - k wa,  dd_j += k wc - k,  da_i += k wa,  dc_i -= k wc
//
// then the shift fold of sot.py:365-380: dbeta_j = db_j + dd_{j+1} and
// dalpha_i = da_i + dc_{i+1} (the terms past the last column are 0).
// |d|^p is d*d for p = 2, |d| for p = 1, |d|*|d|*|d| for p = 3 (the product
// PyTorch's pow takes for that exponent, so the plain version on the card
// rounds the same way) and powf otherwise.
//
// The tie weights are load-bearing: every real training row sits on the
// quantile cap's ties, where another valid subgradient trained worse
// (PERF.md, "The gradient-convention lesson"). So every cell where m = 1 is
// evaluated with exactly these expressions on the raw values; a cell where
// m = 0 adds only zeros to every sum.
//
// Design: one balanced walk over the staircase. Every output term carries m,
// and m = 1 only where a nonempty interval (gamma_i, alpha_i] of one side
// overlaps a nonempty (delta_j, beta_j] of the other. On a sorted row those
// cells lie on the merge path of the nonempty intervals' alpha and beta:
// the lattice path that steps to the next nonempty row where alpha_i <=
// beta_j (ties to alpha) and to the next nonempty column otherwise, one
// position on each diagonal, na + nb + 1 positions for na and nb nonempty
// intervals (at most 2n + 1). A block of NT = 128 threads owns one row:
//   1. cp.async brings the row's alpha and beta and the grid into shared
//      memory, all copies in flight at once;
//   2. one pass over each thread's contiguous chunk checks that both sides
//      are nondecreasing and counts the nonempty intervals; a scan places
//      them and a second pass lists their values and indices;
//   3. thread r owns the positions [r L, (r + 1) L), L = ceil((na + nb + 1)
//      / NT): one co-rank binary search over the lists finds the position
//      before its first, then it walks its slice one position a step. The
//      next decision waits on one shared load: between two nonempty rows
//      alpha is constant, so the new row's gamma_i is the old row's alpha_i.
// No thread's work depends on a riser's length. That is the point: with
// whole columns a thread, a block runs at the pace of its longest column
// band, and on the smoke's real SOT-2048 rows the slowest lane of a block
// holds ~300 cells against a mean of ~4, at ~35 cycles a cell forward and
// ~140 backward (PERF.md §6, tools/plane_timeline.py).
//
// Sums. The forward adds each thread's cells in path order in float64, the
// lanes by a shfl_down tree, the warps in order. The backward's outputs are
// keyed: dbeta_j takes the db terms of column j's cells and the dd terms of
// column j + 1's, which are consecutive runs on the path, so a thread keeps
// two open sums per side (key j - 1 and key j while it walks column j) and
// writes a key when it leaves column j + 1 (a step past a gap of empty
// columns closes key j too; the row is zeroed first, so keys no cell feeds
// read 0). Keys cut by a slice boundary are joined by a segmented scan of the
// threads' carries: a slice maps the open sums it receives (P, C) to
// (P + x, C + y) if it stays in one column, to (C + x, y) if it closes one
// key, to (x, y) if it closes more; the maps compose by a shfl_up tree and
// then the warps in order. The first two keys a thread closes add the carry
// it receives; the rest are its own. The alpha side runs the same keys over
// rows, in the same walk. Fixed orders and no atomics, so two launches agree
// bit for bit. Each cell's f32 product is rounded as in the plain version
// (__fmul_rn / __fsub_rn, no FMA contraction), and each output is rounded
// once to f32.
//
// A row whose alpha or beta is not nondecreasing (or holds a NaN) takes the
// full scan: each thread takes columns (and, for dalpha, rows) and sums all
// n cells of each, so the kernels equal their plain versions on any input.
//
// Bound on the H100: bytes. A sorted row has at most 2n - 1 cells with
// m = 1: at SOT-2048's loss shape (1024 rows x 1026) the forward reads
// 8.4 MB (~2.5 us) and the backward also writes dbeta (12.6 MB, ~3.8 us);
// the cells' ~8-20 operations each are ~0.01-0.02 GFLOP. What holds the
// kernels (PERF.md §6): each block's chain of load, list, search and
// walk phases, and the rows whose every interval is nonempty (na + nb ~ 2n,
// 4x the median on real SOT-2048 rows), which set the launch's tail.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "rows.cuh"

namespace {

constexpr int NT = 128;  // threads of a block, which walks one row
constexpr int NWARPS = NT / 32;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float dist_pow(float d, float p) {
  if (p == 2.f) return __fmul_rn(d, d);
  const float a = fabsf(d);
  if (p == 1.f) return a;
  if (p == 3.f) return __fmul_rn(__fmul_rn(a, a), a);
  return powf(a, p);
}

// Dynamic shared memory of one block: the grid, alpha and beta in slots,
// then the lists of nonempty intervals (values, then 16-bit indices) of
// both sides. 196656 bytes at n = 8192, within the 227 KB a block may take.
__host__ __device__ __forceinline__ size_t smem_bytes(int n) {
  return 3 * (size_t)slot_floats(n) * sizeof(float) + 2 * (size_t)n * sizeof(float) +
         (size_t)((2 * n + 7) & ~7) * sizeof(unsigned short);
}

// Writes zeros to dst[0, n) with 16-byte stores where dst is aligned.
__device__ __forceinline__ void zero_row(float* dst, int n) {
  const int lead = (int)(((16u - ((unsigned)(uintptr_t)dst & 15u)) & 15u) >> 2);
  const int h = min(n, lead);
  const int m = (n - h) >> 2;
  for (int e = threadIdx.x; e < h; e += NT) dst[e] = 0.f;
  for (int q = threadIdx.x; q < m; q += NT)
    reinterpret_cast<float4*>(dst + h)[q] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int e = h + 4 * m + threadIdx.x; e < n; e += NT) dst[e] = 0.f;
}

// The block's row in shared memory, and its nonempty intervals: alpha_i >
// gamma_i (beta_j > delta_j). Only they can hold a cell with m = 1. The
// lists hold, at [0, na), the nonempty rows' alpha_i (v) and i (ix), and at
// [n, n + nb) the nonempty columns' beta_j and j.
struct Tile {
  const float* al;
  const float* be;
  const float* g;
  const float* v;
  const unsigned short* ix;
  int n, na, nb;
  bool full;  // the row is not sorted: full scan
};

// Loads the row and the grid, all copies in flight at once; then one pass
// over each thread's contiguous chunk checks the monotonicity and counts the
// nonempty intervals, a scan places them, and a second pass lists them
// (sorted rows only). Three barriers. Every thread must make the call.
__device__ Tile load_tile(const float* __restrict__ alpha, const float* __restrict__ beta,
                          const float* __restrict__ grid, float* smem, int n, int* warp_flag,
                          int* warp_count) {
  const int S = slot_floats(n);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  Tile t;
  t.n = n;
  const size_t base = (size_t)blockIdx.x * n;
  t.g = copy_slot<NT>(grid, smem, n);
  float* al = copy_slot<NT>(alpha + base, smem + S, n);
  float* be = copy_slot<NT>(beta + base, smem + 2 * S, n);
  float* v = smem + 3 * S;
  unsigned short* ix = reinterpret_cast<unsigned short*>(v + 2 * n);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  const int chunk = (n + NT - 1) / NT;
  const int e0 = min((int)threadIdx.x * chunk, n), e1 = min(e0 + chunk, n);
  bool bad = false;
  int cnt = 0;  // nonempty alpha intervals in the low 16 bits, beta's above
  {
    float pa = e0 > 0 ? al[e0 - 1] : 0.f, pb = e0 > 0 ? be[e0 - 1] : 0.f;
#pragma unroll 4
    for (int e = e0; e < e1; ++e) {
      const float a = al[e], b = be[e];
      // not nondecreasing, or a NaN (element 0 against itself)
      bad |= !(a >= (e > 0 ? pa : a)) || !(b >= (e > 0 ? pb : b));
      cnt += (a > pa ? 1 : 0) + (b > pb ? 1 << 16 : 0);
      pa = a;
      pb = b;
    }
  }
  int incl = cnt;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(FULL, incl, d);
    if (lane >= d) incl += u;
  }
  const unsigned any = __any_sync(FULL, bad);
  if (lane == 31) {
    warp_flag[warp] = any ? 1 : 0;
    warp_count[warp] = incl;
  }
  __syncthreads();
  int f = 0, before = 0, total = 0;
#pragma unroll
  for (int w = 0; w < NWARPS; ++w) {
    f |= warp_flag[w];
    before += w < warp ? warp_count[w] : 0;
    total += warp_count[w];
  }
  t.full = f != 0;
  t.na = total & 0xffff;
  t.nb = total >> 16;
  if (!t.full) {
    int oa = (before + incl - cnt) & 0xffff, ob = n + ((before + incl - cnt) >> 16);
    float pa = e0 > 0 ? al[e0 - 1] : 0.f, pb = e0 > 0 ? be[e0 - 1] : 0.f;
#pragma unroll 4
    for (int e = e0; e < e1; ++e) {
      const float a = al[e], b = be[e];
      if (a > pa) {
        v[oa] = a;
        ix[oa++] = (unsigned short)e;
      }
      if (b > pb) {
        v[ob] = b;
        ix[ob++] = (unsigned short)e;
      }
      pa = a;
      pb = b;
    }
  }
  __syncthreads();
  t.al = al;
  t.be = be;
  t.v = v;
  t.ix = ix;
  return t;
}

// A nonempty row goes before a nonempty column on the merge path where
// alpha_i <= beta_j (ties to alpha).
struct AlphaFirst {
  __device__ __forceinline__ bool operator()(float a, float b) const { return a <= b; }
};

// The walk's cursor: the position (p, q) on the lists, the row i and column
// j they are, and the values there. Past the last nonempty row (column), i
// (j) is n and alpha_i (beta_j) repeats gamma_i (delta_j), so the cell there
// has m = 0.
struct Cursor {
  int p, q, i, j;
  float a, c, b, d, gi, gj;  // alpha_i, gamma_i, beta_j, delta_j, g_i, g_j
};

__device__ __forceinline__ Cursor cursor_at(const Tile& t, int p, int q) {
  const int n = t.n;
  Cursor u;
  u.p = p;
  u.q = q;
  u.i = p < t.na ? t.ix[p] : n;
  u.j = q < t.nb ? t.ix[n + q] : n;
  u.c = u.i > 0 ? t.al[u.i - 1] : 0.f;
  u.d = u.j > 0 ? t.be[u.j - 1] : 0.f;
  u.a = u.i < n ? t.al[u.i] : u.c;
  u.b = u.j < n ? t.be[u.j] : u.d;
  u.gi = t.g[min(u.i, n - 1)];
  u.gj = t.g[min(u.j, n - 1)];
  return u;
}

// One step along the merge path, without a branch: to the next nonempty
// row where alpha_i <= beta_j (or no column is left), else to the next
// nonempty column. Between two nonempty rows every interval is empty, so
// the new row's gamma_i is the old row's alpha_i; the next decision waits
// on one shared load. Returns true for a row step.
__device__ __forceinline__ bool step(const Tile& t, Cursor& u) {
  const int n = t.n;
  const bool si = u.q == t.nb || (u.p < t.na && u.a <= u.b);
  u.p += si;
  u.q += !si;
  const int pos = si ? u.p : u.q;
  const bool in = pos < (si ? t.na : t.nb);
  const int at = (si ? 0 : n) + pos;
  const float old = si ? u.a : u.b;
  const float x = in ? t.v[at] : old;
  const int e = in ? t.ix[at] : n;
  const float ge = t.g[min(e, n - 1)];
  u.i = si ? e : u.i;
  u.c = si ? u.a : u.c;
  u.a = si ? x : u.a;
  u.gi = si ? ge : u.gi;
  u.j = si ? u.j : e;
  u.d = si ? u.d : u.b;
  u.b = si ? u.b : x;
  u.gj = si ? u.gj : ge;
  return si;
}

// The slice [k0, k1) of this thread over the na + nb + 1 positions.
__device__ __forceinline__ void slice(const Tile& t, int* k0, int* k1) {
  const int npos = t.na + t.nb + 1;
  const int len = (npos + NT - 1) / NT;
  *k0 = min((int)threadIdx.x * len, npos);
  *k1 = min(*k0 + len, npos);
}

// The cursor before the slice's first step: the position k0 - 1, or (0, 0)
// for the first slice (which then takes no step into its first position).
__device__ __forceinline__ Cursor slice_start(const Tile& t, int k0) {
  if (k0 == 0) return cursor_at(t, 0, 0);
  const int p = corank(t.v, t.na, t.nb, t.n, k0 - 1, AlphaFirst());
  return cursor_at(t, p, k0 - 1 - p);
}

__global__ void __launch_bounds__(NT)
plane_fwd_kernel(const float* __restrict__ alpha, const float* __restrict__ beta,
                 const float* __restrict__ grid, float p, float* __restrict__ out, int n) {
  extern __shared__ float4 smem4[];
  __shared__ int warp_flag[NWARPS], warp_count[NWARPS];
  __shared__ double warp_sum[NWARPS];
  const Tile t = load_tile(alpha, beta, grid, reinterpret_cast<float*>(smem4), n, warp_flag,
                           warp_count);
  double acc = 0.0;
  if (t.full) {
    for (int j = threadIdx.x; j < n; j += NT) {
      const float b = t.be[j];
      const float d = j > 0 ? t.be[j - 1] : 0.f;
      const float gj = t.g[j];
      for (int i = 0; i < n; ++i) {
        const float diff = __fsub_rn(fminf(t.al[i], b), fmaxf(i > 0 ? t.al[i - 1] : 0.f, d));
        const float mu = diff > 0.f ? diff : 0.f;
        acc += (double)__fmul_rn(mu, dist_pow(__fsub_rn(gj, t.g[i]), p));
      }
    }
  } else {
    int k0, k1;
    slice(t, &k0, &k1);
    if (k0 < k1) {
      Cursor u = slice_start(t, k0);
      for (int k = k0; k < k1; ++k) {
        if (k > 0) step(t, u);
        // every position: one with m = 0 (or past the last interval) adds +0
        const float diff = __fsub_rn(fminf(u.a, u.b), fmaxf(u.c, u.d));
        const float mu = diff > 0.f ? diff : 0.f;
        acc += (double)__fmul_rn(mu, dist_pow(__fsub_rn(u.gj, u.gi), p));
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(FULL, acc, off);
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    double total = warp_sum[0];
#pragma unroll
    for (int w = 1; w < NWARPS; ++w) total += warp_sum[w];
    out[blockIdx.x] = (float)total;
  }
}

// A thread's effect on the open sums it receives: (P, C) -> (P + x, C + y)
// for s = 0, (C + x, y) for s = 1, (x, y) for s = 2 (s = the keys it moved
// past, at most 2).
struct Map {
  int s;
  double x, y;
};

// earlier, then later
__device__ __forceinline__ Map compose(const Map& e, const Map& l) {
  Map r;
  r.s = min(e.s + l.s, 2);
  if (l.s == 0) {
    r.x = e.x + l.x;
    r.y = e.y + l.y;
  } else if (l.s == 1) {
    r.x = e.y + l.x;
    r.y = l.y;
  } else {
    r.x = l.x;
    r.y = l.y;
  }
  return r;
}

__device__ __forceinline__ Map shfl_up(const Map& m, int d) {
  return {__shfl_up_sync(FULL, m.s, d), __shfl_up_sync(FULL, m.x, d),
          __shfl_up_sync(FULL, m.y, d)};
}

// One side's open sums along the walk (columns for dbeta, rows for dalpha):
// P is key cur - 1, C is key cur, for the column (row) cur the walk is in.
struct Keys {
  double P, C;
  double pend1, pend2;  // the first two keys closed, before the carry
  int moves;            // keys moved past
  int start;            // the column (row) the walk started in
};

__device__ __forceinline__ Keys keys_at(int start) { return {0.0, 0.0, 0.0, 0.0, 0, start}; }

// The walk leaves column (row) cur: key cur - 1 closes.
__device__ __forceinline__ void leave(Keys& s, int cur, float* out) {
  if (s.moves == 0) {
    s.pend1 = s.P;
  } else if (s.moves == 1) {
    s.pend2 = s.P;
  } else {
    out[cur - 1] = (float)s.P;  // cur > start >= 0
  }
  ++s.moves;
  s.P = s.C;
  s.C = 0.0;
}

// With the carry (P, C) received from the earlier slices, writes the keys
// closed before the carry was known.
__device__ __forceinline__ void settle(const Keys& s, const Map& carry, float* out) {
  if (s.moves >= 1 && s.start >= 1) out[s.start - 1] = (float)(carry.x + s.pend1);
  if (s.moves >= 2) out[s.start] = (float)(carry.y + s.pend2);
}

__device__ __forceinline__ Map map_of(const Keys& s) { return {min(s.moves, 2), s.P, s.C}; }

// Exclusive scan of the block's maps in thread order (the carry each
// thread receives). Shared: NWARPS entries of wm. Every thread must call.
__device__ Map carry_in(const Map& own, Map* wm) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  Map incl = own;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Map u = shfl_up(incl, d);
    if (lane >= d) incl = compose(u, incl);
  }
  Map excl = shfl_up(incl, 1);
  if (lane == 0) excl = {0, 0.0, 0.0};
  if (lane == 31) wm[warp] = incl;
  __syncthreads();
  Map pre = {0, 0.0, 0.0};
  for (int w = 0; w < warp; ++w) pre = compose(pre, wm[w]);
  return compose(pre, excl);
}

template <bool DA>
__global__ void __launch_bounds__(NT)
plane_bwd_kernel(const float* __restrict__ alpha, const float* __restrict__ beta,
                 const float* __restrict__ grid, const float* __restrict__ wbar, float p,
                 float* __restrict__ da, float* __restrict__ db, int n) {
  extern __shared__ float4 smem4[];
  __shared__ int warp_flag[NWARPS], warp_count[NWARPS];
  __shared__ Map wm_col[NWARPS];
  __shared__ Map wm_row[DA ? NWARPS : 1];
  float* dbr = db + (size_t)blockIdx.x * n;
  float* dar = DA ? da + (size_t)blockIdx.x * n : nullptr;
  // the walk writes the keys a cell can feed; the rest are 0
  zero_row(dbr, n);
  if (DA) zero_row(dar, n);
  const Tile t = load_tile(alpha, beta, grid, reinterpret_cast<float*>(smem4), n, warp_flag,
                           warp_count);
  const float w = wbar[blockIdx.x];
  Keys col = keys_at(0), row = keys_at(0);

  if (t.full) {
    // db_j + dd_{j+1}: column j's and column j + 1's cells, increasing i
    for (int j = threadIdx.x; j < n; j += NT) {
      double sb = 0.0, sd = 0.0;
      for (int jj = j; jj <= j + 1 && jj < n; ++jj) {
        const float b = t.be[jj];
        const float d = jj > 0 ? t.be[jj - 1] : 0.f;
        for (int i = 0; i < n; ++i) {
          const float a = t.al[i];
          const float c = i > 0 ? t.al[i - 1] : 0.f;
          const float m = fminf(a, b) > fmaxf(c, d) ? 1.f : 0.f;
          const float k = __fmul_rn(__fmul_rn(m, dist_pow(__fsub_rn(t.g[jj], t.g[i]), p)), w);
          if (jj == j) {
            const float wa = a < b ? 1.f : (a == b ? 0.5f : 0.f);
            sb += (double)__fsub_rn(k, __fmul_rn(k, wa));
          } else {
            const float wc = c > d ? 1.f : (c == d ? 0.5f : 0.f);
            sd += (double)__fsub_rn(__fmul_rn(k, wc), k);
          }
        }
      }
      dbr[j] = (float)(sb + sd);
    }
    if (DA) {
      // da_i + dc_{i+1}: row i's and row i + 1's cells, increasing j
      for (int i = threadIdx.x; i < n; i += NT) {
        double sa = 0.0, sc = 0.0;
        for (int ii = i; ii <= i + 1 && ii < n; ++ii) {
          const float a = t.al[ii];
          const float c = ii > 0 ? t.al[ii - 1] : 0.f;
          for (int j = 0; j < n; ++j) {
            const float b = t.be[j];
            const float d = j > 0 ? t.be[j - 1] : 0.f;
            const float m = fminf(a, b) > fmaxf(c, d) ? 1.f : 0.f;
            const float k = __fmul_rn(__fmul_rn(m, dist_pow(__fsub_rn(t.g[j], t.g[ii]), p)), w);
            if (ii == i) {
              const float wa = a < b ? 1.f : (a == b ? 0.5f : 0.f);
              sa += (double)__fmul_rn(k, wa);
            } else {
              const float wc = c > d ? 1.f : (c == d ? 0.5f : 0.f);
              sc -= (double)__fmul_rn(k, wc);
            }
          }
        }
        dar[i] = (float)(sa + sc);
      }
    }
  } else {
    int k0, k1;
    slice(t, &k0, &k1);
    if (k0 < k1) {
      Cursor u = slice_start(t, k0);
      col = keys_at(u.j);
      row = keys_at(u.i);
      for (int k = k0; k < k1; ++k) {
        if (k > 0) {
          // leaving row (column) e closes key e - 1; past a gap of empty
          // intervals, key e too
          const int i = u.i, j = u.j;
          if (step(t, u)) {
            if (DA) {
              leave(row, i, dar);
              if (u.i != i + 1) leave(row, i + 1, dar);
            }
          } else {
            leave(col, j, dbr);
            if (u.j != j + 1) leave(col, j + 1, dbr);
          }
        }
        // every position: one with m = 0 (or past the last interval) adds zeros
        const float m = fminf(u.a, u.b) > fmaxf(u.c, u.d) ? 1.f : 0.f;
        const float kc = __fmul_rn(__fmul_rn(m, dist_pow(__fsub_rn(u.gj, u.gi), p)), w);
        const float wa = u.a < u.b ? 1.f : (u.a == u.b ? 0.5f : 0.f);
        const float wc = u.c > u.d ? 1.f : (u.c == u.d ? 0.5f : 0.f);
        const float kwa = __fmul_rn(kc, wa), kwc = __fmul_rn(kc, wc);
        col.C += (double)__fsub_rn(kc, kwa);
        col.P += (double)__fsub_rn(kwc, kc);
        if (DA) {
          row.C += (double)kwa;
          row.P -= (double)kwc;
        }
      }
      if (k1 == t.na + t.nb + 1) {
        // past the last position (n, n): keys n - 1 close
        leave(col, n, dbr);
        if (DA) leave(row, n, dar);
      }
    }
  }
  const Map cc = carry_in(map_of(col), wm_col);
  if (!t.full) settle(col, cc, dbr);
  if (DA) {
    const Map cr = carry_in(map_of(row), wm_row);
    if (!t.full) settle(row, cr, dar);
  }
}

int set_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes));
}

template <bool DA>
int launch_bwd(const float* alpha, const float* beta, const float* grid, const float* wbar,
               float p, float* da, float* db, int rows, int n, cudaStream_t stream) {
  const size_t shmem = smem_bytes(n);
  const int err = set_smem((const void*)plane_bwd_kernel<DA>, shmem);
  if (err != 0) return err;
  plane_bwd_kernel<DA><<<rows, NT, shmem, stream>>>(alpha, beta, grid, wbar, p, da, db, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// alpha, beta [rows, n] f32 contiguous; grid [n] f32; out [rows] f32.
// Requires 1 <= n <= 8192 (checked by the Python wrapper). Returns
// cudaGetLastError() of the launch.
extern "C" int sot_plane_forward_f32(const float* alpha, const float* beta, const float* grid,
                                     float p, float* out, int rows, int n, void* stream) {
  const size_t shmem = smem_bytes(n);
  const int err = set_smem((const void*)plane_fwd_kernel, shmem);
  if (err != 0) return err;
  plane_fwd_kernel<<<rows, NT, shmem, static_cast<cudaStream_t>(stream)>>>(alpha, beta, grid, p,
                                                                           out, n);
  return static_cast<int>(cudaGetLastError());
}

// alpha, beta [rows, n] f32 contiguous; grid [n] f32; wbar [rows] f32;
// db [rows, n] f32; da [rows, n] f32, or null to skip the alpha side.
// Requires 1 <= n <= 8192 (checked by the Python wrapper). Returns
// cudaGetLastError() of the launch.
extern "C" int sot_plane_backward_f32(const float* alpha, const float* beta, const float* grid,
                                      const float* wbar, float p, float* da, float* db, int rows,
                                      int n, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return da != nullptr ? launch_bwd<true>(alpha, beta, grid, wbar, p, da, db, rows, n, s)
                       : launch_bwd<false>(alpha, beta, grid, wbar, p, da, db, rows, n, s);
}
