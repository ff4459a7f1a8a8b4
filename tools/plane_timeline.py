#!/usr/bin/env python3
"""Per-block timelines of the per-column banded-plane kernels on one GPU.

The per-column design of ``sot_tpu_torch/csrc/plane.cu`` (one block per row,
thread t taking columns t, t + 256, ..., each column's band of cells found by
two binary searches) ran each block at the pace of its longest band. This
script measures that: it copies such a plane.cu, adds ``clock64`` and
``%globaltimer`` stamps (block start, after the row load, each warp's end of
its band loop, block end), builds the copy with nvcc, runs both kernels on
the smoke's rows and prints, per input, one JSON line: the rows on the
full-scan path, the cells a thread's columns visit (mean, and the slowest
lane of a block), the mu > 0 cells per row, and per kernel the block cycles,
the loop cycles against the slowest lane's cells (slope and correlation)
and the launch's span.

    git show 6a7cb09:sot_tpu_torch/csrc/plane.cu > runs/parent/plane.cu
    python3 tools/plane_timeline.py runs/parent/plane.cu

It needs a GPU and an earlier plane.cu of the per-column design; the
instrumented copy and its library go next to that file.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from sot_tpu_torch.configs import get_experiment  # noqa: E402
from sot_tpu_torch.ops.kernels import _build  # noqa: E402
from sot_tpu_torch.training.trainer import build_modules  # noqa: E402

STAMPS = '''
__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t; asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t)); return t; }
__device__ __forceinline__ unsigned smid() {
  unsigned s; asm volatile("mov.u32 %0, %%smid;" : "=r"(s)); return s; }
'''
# (text of the per-column plane.cu, its instrumented replacement); each must
# occur in the source. A block's 16 stamps: [0] start (globaltimer), [1]
# cycles to the end of the row load, [2 + w] warp w's end of its band loop,
# [10] cycles to the block's end, [11] end (globaltimer), [14] the SM.
EDITS = [
    ('#include "scan.cuh"', '#include "scan.cuh"\n' + STAMPS),
    ('''                 const float* __restrict__ grid, float p, float* __restrict__ out, int n) {
  extern __shared__ float smem[];''',
     '''                 const float* __restrict__ grid, float p, float* __restrict__ out, int n,
                 unsigned long long* tb) {
  extern __shared__ float smem[];
  unsigned long long* T = tb + (size_t)blockIdx.x * 16;
  const long long c0 = clock64();
  if (threadIdx.x == 0) { T[0] = gtime(); T[14] = smid(); }'''),
    ('''  const bool full = load_row(alpha, beta, grid, al, be, g, n) & 1;

  double acc = 0.0;''',
     '''  const bool full = load_row(alpha, beta, grid, al, be, g, n) & 1;
  if (threadIdx.x == 0) T[1] = clock64() - c0;
  double acc = 0.0;'''),
    ('''  double total;
  block_excl_scan<NT>(acc, warp_buf, &total);
  if (threadIdx.x == 0) out[blockIdx.x] = (float)total;''',
     '''  __syncwarp();
  if ((threadIdx.x & 31) == 0) T[2 + (threadIdx.x >> 5)] = clock64() - c0;
  double total;
  block_excl_scan<NT>(acc, warp_buf, &total);
  if (threadIdx.x == 0) {
    out[blockIdx.x] = (float)total; T[10] = clock64() - c0; T[11] = gtime(); }'''),
    ('''                 float* __restrict__ da, float* __restrict__ db, int n) {
  extern __shared__ double dsmem[];''',
     '''                 float* __restrict__ da, float* __restrict__ db, int n,
                 unsigned long long* tb) {
  extern __shared__ double dsmem[];
  unsigned long long* T = tb + (size_t)blockIdx.x * 16;
  const long long c0 = clock64();
  if (threadIdx.x == 0) { T[0] = gtime(); T[14] = smid(); }'''),
    ('''  const int unsorted = load_row(alpha, beta, grid, al, be, g, n);''',
     '''  const int unsorted = load_row(alpha, beta, grid, al, be, g, n);
  if (threadIdx.x == 0) T[1] = clock64() - c0;'''),
    ('''  if (threadIdx.x == 0) shifted[n] = 0.0;
  __syncthreads();''',
     '''  if (threadIdx.x == 0) shifted[n] = 0.0;
  __syncwarp();
  if ((threadIdx.x & 31) == 0) T[2 + (threadIdx.x >> 5)] = clock64() - c0;
  __syncthreads();'''),
    ('''  for (int j = threadIdx.x; j < n; j += NT) db[base + j] = (float)(own[j] + shifted[j + 1]);
  if (da == nullptr) return;''',
     '''  for (int j = threadIdx.x; j < n; j += NT) db[base + j] = (float)(own[j] + shifted[j + 1]);
  if (da == nullptr) {
    __syncthreads();
    if (threadIdx.x == 0) { T[10] = clock64() - c0; T[11] = gtime(); }
    return;
  }'''),
    ("float p, float* out, int rows, int n, void* stream) {",
     "float p, float* out, int rows, int n, void* stream, unsigned long long* tb) {"),
    ("out, n);", "out, n, tb);"),
    ("int n, void* stream) {", "int n, void* stream, unsigned long long* tb) {"),
    ("p, da, db, n);", "p, da, db, n, tb);"),
]


def instrument(src_path: str) -> ctypes.CDLL:
    src = open(src_path).read()
    for old, new in EDITS:
        if old not in src:
            raise SystemExit(f"{src_path} is not the per-column design: missing {old[:60]!r}")
        src = src.replace(old, new)
    cu = os.path.join(os.path.dirname(os.path.abspath(src_path)), "plane_timeline.cu")
    lib_path = cu[:-3] + ".so"
    with open(cu, "w") as f:
        f.write(src)
    out = subprocess.run([_build.nvcc_path(), *_build.ARCH_FLAGS, *_build.COMMON_FLAGS,
                          "-I", str(_build.CSRC), "-o", lib_path, cu],
                         capture_output=True, text=True)
    if out.returncode != 0:
        raise SystemExit(f"nvcc failed:\n{out.stdout}{out.stderr}")
    lib = ctypes.CDLL(lib_path)
    lib.sot_plane_forward_f32.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_float, ctypes.c_void_p]
                                          + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2)
    lib.sot_plane_backward_f32.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_float]
                                           + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
                                           + [ctypes.c_void_p] * 2)
    return lib


def stamps(lib, alpha, beta, g, forward: bool) -> np.ndarray:
    rows, n = alpha.shape
    tb = torch.zeros((rows, 16), dtype=torch.int64, device=alpha.device)
    stream = torch.cuda.current_stream().cuda_stream
    for _ in range(2):  # the second launch is read
        if forward:
            out = torch.empty(rows, device=alpha.device)
            err = lib.sot_plane_forward_f32(alpha.data_ptr(), beta.data_ptr(), g.data_ptr(), 2.0,
                                            out.data_ptr(), rows, n, stream, tb.data_ptr())
        else:
            w = torch.full((rows,), 1.0 / rows, device=alpha.device)
            db = torch.empty_like(beta)
            err = lib.sot_plane_backward_f32(alpha.data_ptr(), beta.data_ptr(), g.data_ptr(),
                                             w.data_ptr(), 2.0, None, db.data_ptr(), rows, n,
                                             stream, tb.data_ptr())
        _build.check(err, "instrumented plane kernel")
        torch.cuda.synchronize()
    return tb.cpu().numpy().astype(np.float64)


def lane_cells(alpha, beta) -> np.ndarray:
    """[rows, 256]: the cells each thread's columns visit in the per-column
    design (#{alpha < beta_j} + 1, capped at n, less #{alpha <= delta_j})."""
    rows, n = alpha.shape
    prev = torch.nn.functional.pad(beta, (1, 0))[:, :-1].contiguous()
    lo = torch.searchsorted(alpha, prev, right=True)
    hi = torch.clamp(torch.searchsorted(alpha, beta.contiguous(), right=False) + 1, max=n)
    per_col = torch.clamp(hi - lo, min=0).double()
    per_col = torch.nn.functional.pad(per_col, (0, (-n) % 256)).reshape(rows, -1, 256).sum(1)
    return per_col.cpu().numpy()


def report(lib, tag, alpha, beta, g) -> None:
    rows, n = alpha.shape
    cells = lane_cells(alpha, beta)
    slowest = cells.max(1)  # a block's slowest lane (its warp's pace)
    stats = cs.plane_walk_stats(alpha, beta)
    res = {"rows": tag, "shape": [rows, n], "rows_full_scan": stats["full_rows"],
           "mean_lane_cells": float(cells.mean()), "mean_slowest_lane_cells": float(slowest.mean()),
           "max_slowest_lane_cells": float(slowest.max()),
           "mu_pos_cells_per_row": stats["cells"] / rows,
           "visited_cells_per_row": float(cells.sum(1).mean())}
    for forward in (True, False):
        t = stamps(lib, alpha, beta, g, forward)
        block, load = t[:, 10], t[:, 1]
        loop = t[:, 2:10].max(1) - load
        slope, icpt = np.polyfit(slowest, loop, 1)
        res["kernel 6" if forward else "kernel 7 (target constant)"] = {
            "block_cycles_min_median_p90_max": [float(np.min(block)), float(np.median(block)),
                                                float(np.percentile(block, 90)),
                                                float(np.max(block))],
            "load_cycles_median": float(np.median(load)),
            "loop_cycles_median": float(np.median(loop)),
            "loop_cycles_per_slowest_lane_cell": float(slope), "loop_cycles_intercept": float(icpt),
            "corr_loop_slowest_lane_cells": float(np.corrcoef(slowest, loop)[0, 1]),
            "span_us": float(t[:, 11].max() - t[:, 0].min()) / 1e3,
            "sms": int(len(np.unique(t[:, 14])))}
    print(json.dumps(res))


def main() -> int:
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    lib = instrument(sys.argv[1])
    dev = torch.device("cuda")
    print(cs.card_line())
    torch.manual_seed(0)
    cfg, cfg512 = get_experiment("SOT-2048"), get_experiment("SOT-512")
    mod = build_modules(cfg, device=dev)
    cs.load_golden_weights(mod, cs.GOLDEN)
    mod512 = build_modules(cfg512, device=dev)
    cs.load_golden_weights(mod512, cs.GOLDEN_512)
    x = torch.from_numpy(cs.make_requests(cfg, dev, 1, seed=3000)[0]).to(dev)
    report(lib, "SOT-2048 real", *cs.sot_rows(mod, x))
    report(lib, "SOT-512 real", *cs.sot_rows(mod512, x))
    a, b, g, _ = cs.random_plane_rows(np.random.default_rng(0), 1024, 1026)
    report(lib, "random_plane_rows", *(torch.from_numpy(v).to(dev) for v in (a, b, g)))
    with np.load(cs.GOLDEN_512) as z:
        report(lib, "SOT-512 golden", *(torch.from_numpy(z[k]).to(dev)
                                        for k in ("sot_alpha", "sot_beta", "sot_gaug")))
    return 0


if __name__ == "__main__":
    sys.exit(main())
