#!/usr/bin/env python3
"""Per-block timelines of the SOT rank kernels (4, 5 and 8) on one GPU.

Kernel 4 is ``coupling_fwd_kernel`` and kernel 8 ``coupling_grad_kernel`` in
``sot_tpu_torch/csrc/merge.cu``, kernel 5 ``refgrad_kernel`` in
``sot_tpu_torch/csrc/refgrad.cu``. The script copies a merge.cu (twice:
once for kernel 4, once for kernel 8) and a refgrad.cu of either design and
adds ``clock64`` and ``%globaltimer`` stamps, builds the copies with nvcc,
runs them on the smoke's real SOT rows at both loss shapes (kernel 8 on the
gated step's rows, without alpha gradients, as training calls it) and
prints, per (kernel, shape), one JSON line: the registers and shared memory
``ptxas`` gave the unmodified kernel, the blocks per SM the occupancy API
allows for it, the median (and 90th percentile) cycles of each phase, the
block cycles, the launch's span, the blocks each SM ran and how many ran on
it at once, the waves that makes, how the block cycles follow the row's
work (kernel 4: its runs of equal values; kernel 5: its columns that need
the closed form; kernel 8: the distinct values of b, and the columns whose
query ties a value of a) and the phases of the slowest tenth of the blocks.
Kernel 8's line also holds the unmodified kernel's device ms (profiler).

  * The first design (a block of 256 threads per row, float64
    scans in kernel 4, a binary search per element): stamps at the block
    start and SM, the end of each phase, each warp's end of its search
    loop and the block end.
  * The second design (kernel 4 a merge-path walk over the two rows'
    elements, 128 threads per row; kernel 5 a binary search per column that
    needs the closed form, 256 threads per row): a stamp after every barrier
    of the kernel (and after kernel 4's shared prologue, which ends in
    one), so each phase reads as its slowest thread and the barrier.
  * Kernel 8, first design (256 threads per row, two binary searches per
    column): stamps after the row load (behind a barrier the copy adds),
    the x prefix and the sortedness check, each warp's end of its searches
    and the block end. Second design (128 threads per row, one search per
    distinct query of a warp): stamps after the row load and the prologue,
    the slowest warp's end of each of its passes and the block end.

    mkdir -p runs/parent && git archive 8859f17 sot_tpu_torch/csrc | tar -x -C runs/parent
    python3 tools/rank_timeline.py runs/parent/sot_tpu_torch/csrc/{merge,refgrad}.cu
    python3 tools/rank_timeline.py sot_tpu_torch/csrc/{merge,refgrad}.cu

It needs a GPU and the two sources, with the headers they were written
against beside them (found before the checkout's); the instrumented copies
and their libraries go into ``sot_tpu_torch/_build``.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
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
# A block's 16 stamps: [0] start (globaltimer); in the first design [1]
# cycles to the end of the row load, [2] to thread 0's end of the prefix
# scan, [3] to the end of the suffix scan (kernel 4 only), [4 + w] warp w's
# end of its search loop; in the walk [1 + i] cycles to the end of the
# kernel's barrier i; [12] cycles to the block's end, [13] end
# (globaltimer), [14] the SM.
START = '''
  unsigned long long* T = tb + (size_t)blockIdx.x * 16;
  const long long c0 = clock64();
  if (threadIdx.x == 0) { T[0] = gtime(); T[14] = smid(); }'''
WARP_END = '''
  __syncwarp();
  if ((threadIdx.x & 31) == 0) T[4 + (threadIdx.x >> 5)] = clock64() - c0;'''
BLOCK_END = "if (threadIdx.x == 0) { T[12] = clock64() - c0; T[13] = gtime(); }"
OCCUPANCY = '''
extern "C" int timeline_occupancy(void* kernel, int threads, size_t shmem, int* blocks) {
  if (shmem > 48 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, threads, shmem);
}
'''

# kernel 8's first design: (text, its instrumented replacement)
FIRST_GRAD_EDITS = [
    ('#include "scan.cuh"', '#include "scan.cuh"\n' + STAMPS),
    ('''                     float* __restrict__ db, int m) {
  extern __shared__ double smem[];''',
     '''                     float* __restrict__ db, int m, unsigned long long* tb) {
  extern __shared__ double smem[];''' + START),
    ('''    bs[l] = b[base + l];
  }''',
     '''    bs[l] = b[base + l];
  }
  __syncthreads();
  if (tid == 0) T[1] = clock64() - c0;'''),
    ('''  if (tid == 0) px[m] = total;
  __syncthreads();''',
     '''  if (tid == 0) px[m] = total;
  __syncthreads();
  if (tid == 0) T[2] = clock64() - c0;'''),
    ("  const bool b_unsorted = __syncthreads_or(ub) != 0;",
     "  const bool b_unsorted = __syncthreads_or(ub) != 0;\n"
     "  if (tid == 0) T[3] = clock64() - c0;"),
    ("  if (da != nullptr) side_grad(bs, as, x, px, da + base, m, b_unsorted);\n}",
     "  if (da != nullptr) side_grad(bs, as, x, px, da + base, m, b_unsorted);" + WARP_END
     + "\n  __syncthreads();\n  " + BLOCK_END + "\n}"),
    ("float* db, int rows, int m, void* stream) {",
     "float* db, int rows, int m, void* stream, unsigned long long* tb) {"),
]

# kernel 8's second design (a block of 128 threads per row): stamps by
# thread 0 ([1] the load, [2] the prologue, each after its barrier) and by
# the slowest warp ([3] heads, [4] searches, [5] columns: atomicMax of each
# warp's lane 0)
WARP_PHASE = ("\n  __syncwarp();\n  if ((threadIdx.x & 31) == 0) "
              "atomicMax(T + {k}, (unsigned long long)(clock64() - c0));")
SECOND_GRAD_EDITS = [
    ("namespace {", STAMPS + "\nnamespace {"),
    ("""                          const double* px, double* heads, float* __restrict__ out, int m,
                          bool full) {""",
     """                          const double* px, double* heads, float* __restrict__ out, int m,
                          bool full, unsigned long long* T, long long c0) {"""),
    ("    nh += __popc(mask);\n  }\n  __syncwarp();\n  // 2.",
     "    nh += __popc(mask);\n  }" + WARP_PHASE.format(k=3) + "\n  // 2."),
    ("  }\n  __syncwarp();\n  // 3.", "  }" + WARP_PHASE.format(k=4) + "\n  // 3."),
    ("    nh += __popc(mask);\n  }\n}\n",
     "    nh += __popc(mask);\n  }" + WARP_PHASE.format(k=5) + "\n}\n"),
    ("""                     float* __restrict__ db, int m) {
  extern __shared__ float4 smem4[];""",
     """                     float* __restrict__ db, int m, unsigned long long* tb) {
  extern __shared__ float4 smem4[];""" + START),
    ("""  __syncthreads();
  const int unsorted = row_prologue<GT, false>(as, bs, x, nullptr, px, m);""",
     """  __syncthreads();
  if (threadIdx.x == 0) T[1] = clock64() - c0;
  const int unsorted = row_prologue<GT, false>(as, bs, x, nullptr, px, m);
  if (threadIdx.x == 0) T[2] = clock64() - c0;"""),
    ("""    side_grad(bs, as, x, px, heads, da + base, m, unsorted & 2);
  }
}""",
     """    side_grad(bs, as, x, px, heads, da + base, m, unsorted & 2, T, c0);
  }
  __syncthreads();
  """ + BLOCK_END + "\n}"),
    ("db + base, m, unsorted & 1);", "db + base, m, unsorted & 1, T, c0);"),
    ("float* db, int rows, int m, void* stream) {",
     "float* db, int rows, int m, void* stream, unsigned long long* tb) {"),
]
GRAD_THREADS = 128  # the second design's block, which owns one row


# (text of the first design's source, its instrumented replacement); each
# must occur in the source
FIRST_MERGE_EDITS = [
    ('#include "scan.cuh"', '#include "scan.cuh"\n' + STAMPS),
    ('''                    const float* __restrict__ x, float* __restrict__ out, int m) {
  extern __shared__ double smem[];''',
     '''                    const float* __restrict__ x, float* __restrict__ out, int m,
                    unsigned long long* tb) {
  extern __shared__ double smem[];''' + START),
    ('''  for (int l = tid; l < m; l += NT) bs[l] = b_r[l];
  __syncthreads();''',
     '''  for (int l = tid; l < m; l += NT) bs[l] = b_r[l];
  __syncthreads();
  if (tid == 0) T[1] = clock64() - c0;'''),
    ('''  if (tid == 0) px[m] = total;

  // suffix''',
     '''  if (tid == 0) { px[m] = total; T[2] = clock64() - c0; }

  // suffix'''),
    ('''  if (tid == 0) sxb[m] = 0.0;
  __syncthreads();''',
     '''  if (tid == 0) sxb[m] = 0.0;
  __syncthreads();
  if (tid == 0) T[3] = clock64() - c0;'''),
    ('''  block_excl_scan<NT>(acc, warp_buf, &total);
  if (tid == 0) out[row] = (float)total;''',
     WARP_END + '''
  block_excl_scan<NT>(acc, warp_buf, &total);
  if (tid == 0) out[row] = (float)total;
  ''' + BLOCK_END),
    ("float* out, int rows, int m, void* stream) {",
     "float* out, int rows, int m, void* stream, unsigned long long* tb) {"),
    ("(a, b, x, out, m);", "(a, b, x, out, m, tb);"),
    ("}  // namespace", "}  // namespace\n" + OCCUPANCY
     + 'extern "C" void* timeline_kernel() { return (void*)coupling_fwd_kernel; }\n'),
]
FIRST_REFGRAD_EDITS = [
    ("#include <stddef.h>", "#include <stddef.h>\n" + STAMPS),
    ('''               float* __restrict__ db, int n) {
  extern __shared__ float smem[];''',
     '''               float* __restrict__ db, int n, unsigned long long* tb) {
  extern __shared__ float smem[];''' + START),
    ('''    g[i] = grid[i];
  }
  __syncthreads();''',
     '''    g[i] = grid[i];
  }
  __syncthreads();
  if (threadIdx.x == 0) T[1] = clock64() - c0;'''),
    ('''    db[base + j] = __fmul_rn(w, d);
  }
}''',
     '''    db[base + j] = __fmul_rn(w, d);
  }''' + WARP_END + '''
  __syncthreads();
  ''' + BLOCK_END + '''
}'''),
    ("float* db, int rows, int n, void* stream) {",
     "float* db, int rows, int n, void* stream, unsigned long long* tb) {"),
    ("wbar, db, n);", "wbar, db, n, tb);"),
    ("}  // namespace", "}  // namespace\n" + OCCUPANCY
     + 'extern "C" void* timeline_kernel() { return (void*)refgrad_kernel; }\n'),
]


def nvcc(src: str, lib_path: str, include: str) -> str:
    """Builds ``src`` with the headers of ``include`` first, then the
    checkout's; returns the compiler's output."""
    out = subprocess.run([_build.nvcc_path(), *_build.ARCH_FLAGS, *_build.COMMON_FLAGS,
                          "-I", include, "-I", str(_build.CSRC), "-o", lib_path, src],
                         capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        raise SystemExit(f"nvcc failed for {src}:\n{out.stdout}{out.stderr}")
    return out.stdout + out.stderr


def ptxas_lines(log: str, kernel: str):
    """The ptxas -v lines (stack and spills, registers and shared memory)
    of ``kernel``."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and kernel in line:
            return [ln.replace("ptxas info    :", "").strip() for ln in lines[i + 1:i + 4]
                    if "Function properties" not in ln]
    return []


def stamp_barriers(src: str, kernel: str, launch_args: str, signature: str) -> str:
    """The walk's source with a stamp after every barrier of ``kernel``'s
    body (and after its call of ``row_prologue``, which ends in one), at its
    start and at its end; ``launch_args`` and ``signature``: the text of its
    launch's arguments and of its C function's parameters up to the stream,
    each given the stamp buffer."""
    i = src.index(f"\n{kernel}(")
    sig_end = src.index(") {", i)
    src = src[:sig_end] + ", unsigned long long* tb" + src[sig_end:]
    body = src.index("{", sig_end) + 1
    depth, end = 1, body
    while depth:
        depth += {"{": 1, "}": -1}.get(src[end], 0)
        end += 1
    parts = re.split(r"(__syncthreads\(\);|row_prologue<[^;]*;)", src[body:end - 1])
    if len(parts) > 23:
        raise SystemExit(f"{kernel}: more barriers than stamps")
    text = parts[0] + "".join(
        f"{barrier} if (threadIdx.x == 0) T[{k}] = clock64() - c0;" + part
        for k, (barrier, part) in enumerate(zip(parts[1::2], parts[2::2]), start=1))
    src = (src[:body] + START + text + "\n  __syncthreads();\n  " + BLOCK_END + "\n"
           + src[end - 1:])
    for old, new in ((launch_args + ");", launch_args + ", tb);"),
                     (signature + "void* stream) {",
                      signature + "void* stream, unsigned long long* tb) {")):
        if src.count(old) != 1:
            raise SystemExit(f"{kernel}: missing {old!r}")
        src = src.replace(old, new)
    return src


KERNELS = {"merge": "coupling_fwd_kernel", "merge_grad": "coupling_grad_kernel",
           "refgrad": "refgrad_kernel"}


def instrument(src_path: str, name: str):
    """(the instrumented library, ptxas -v lines of the unmodified kernel,
    the design: "first" or "second"); the unmodified source is built too,
    into ``lib<name>_timeline_plain.so``."""
    src = open(src_path).read()
    here = os.path.dirname(os.path.abspath(src_path))
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    log = nvcc(src_path, str(_build.BUILD_DIR / f"lib{name}_timeline_plain.so"), here)
    kernel = KERNELS[name]
    if name == "merge_grad":
        design = "first" if "count_above<true>" in src else "second"
        for old, new in FIRST_GRAD_EDITS if design == "first" else SECOND_GRAD_EDITS:
            if src.count(old) != 1:
                raise SystemExit(f"{src_path}: kernel 8's {design} design without {old[:60]!r}")
            src = src.replace(old, new)
        src, n = re.subn(r"\(a, b, x, da, db,\s*m\);", "(a, b, x, da, db, m, tb);", src)
        if n != 1:
            raise SystemExit(f"{src_path}: kernel 8's launch not found")
        src = src.replace("}  // namespace", "}  // namespace\n" + OCCUPANCY
                          + f'extern "C" void* timeline_kernel() {{ return (void*){kernel}; }}\n')
    elif "copy_slot<" not in src:
        design = "first"
        for old, new in FIRST_MERGE_EDITS if name == "merge" else FIRST_REFGRAD_EDITS:
            if old not in src:
                raise SystemExit(f"{src_path} is not the first design: missing {old[:60]!r}")
            src = src.replace(old, new)
    else:
        design = "second"
        src = src.replace("namespace {", STAMPS + "\nnamespace {", 1)
        src = src.replace("}  // namespace", "}  // namespace\n" + OCCUPANCY
                          + f'extern "C" void* timeline_kernel() {{ return (void*){kernel}; }}\n')
        src = (stamp_barriers(src, kernel, "(a, b, x, out, m", "float* out, int rows, int m, ")
               if name == "merge" else
               stamp_barriers(src, kernel, "wbar, db, n", "float* db, int rows, int n, "))
    cu = str(_build.BUILD_DIR / f"{name}_timeline.cu")
    with open(cu, "w") as f:
        f.write(src)
    lib_path = str(_build.BUILD_DIR / f"lib{name}_timeline.so")
    nvcc(cu, lib_path, here)
    lib = ctypes.CDLL(lib_path)
    lib.timeline_kernel.restype = ctypes.c_void_p
    lib.timeline_occupancy.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t,
                                       ctypes.c_void_p]
    return lib, ptxas_lines(log, kernel), design


def occupancy(lib, threads: int, shmem: int) -> int:
    blocks = ctypes.c_int(0)
    err = lib.timeline_occupancy(lib.timeline_kernel(), threads, shmem, ctypes.byref(blocks))
    _build.check(err, "cudaOccupancyMaxActiveBlocksPerMultiprocessor")
    return blocks.value


def run_stamps(launch, rows: int, dev) -> np.ndarray:
    tb = torch.zeros((rows, 16), dtype=torch.int64, device=dev)
    for _ in range(2):  # the second launch is read
        tb.zero_()
        _build.check(launch(tb.data_ptr(), torch.cuda.current_stream().cuda_stream),
                     "instrumented kernel")
        torch.cuda.synchronize()
    return tb.cpu().numpy().astype(np.float64)


def waves(t: np.ndarray):
    """(blocks on the busiest SM, most blocks resident on one SM at once, the
    waves: the most blocks one SM ran one after another, ceil(blocks /
    resident))."""
    start, end, sm = t[:, 0], t[:, 13], t[:, 14]
    per_sm, resident, wave = [], [], []
    for s in np.unique(sm):
        st, en = start[sm == s], end[sm == s]
        most = max(int(np.sum((st <= x) & (en > x))) for x in st)
        per_sm.append(len(st))
        resident.append(most)
        wave.append(-(-len(st) // most))
    return int(max(per_sm)), int(max(resident)), int(max(wave)), len(per_sm)


def report(kernel: str, tag: str, t: np.ndarray, ptxas, blocks_per_sm: int, phases,
           work: np.ndarray, extra=None) -> None:
    """One JSON line; ``phases``: (name, stamp column) in order, ending at
    the block's end; ``work``: each row's measure of work; ``extra``: more
    keys of the line."""
    most, resident, n_waves, sms = waves(t)
    block = t[:, 12]
    slow = block >= np.percentile(block, 90)
    prev, cycles, slowest = 0.0, {}, {}
    for name, col in phases:
        if not col.any():  # a barrier this build does not reach
            continue
        cycles[name] = float(np.median(col - prev))
        slowest[name] = float(np.median((col - prev)[slow]))
        prev = col
    res = {
        "kernel": kernel, "rows": tag, "ptxas": ptxas,
        "occupancy_blocks_per_sm": blocks_per_sm, "sms": sms, "blocks_on_busiest_sm": most,
        "most_resident_per_sm": resident, "waves": n_waves,
        "span_us": float(t[:, 13].max() - t[:, 0].min()) / 1e3,
        "start_spread_us": float(t[:, 0].max() - t[:, 0].min()) / 1e3,
        "block_us_median": float(np.median(t[:, 13] - t[:, 0])) / 1e3,
        "block_cycles_min_median_p90_max": [float(np.min(block)), float(np.median(block)),
                                            float(np.percentile(block, 90)),
                                            float(np.max(block))],
        "phase_cycles_median": cycles, "phase_cycles_median_slowest_tenth": slowest,
        "work_per_row_median_max": [float(np.median(work)), float(work.max())],
        "work_per_row_median_slowest_tenth": float(np.median(work[slow])),
        "corr_block_cycles_work": float(np.corrcoef(work, block)[0, 1])}
    if phases[-2][0].startswith("search"):
        res["search_warp_spread_cycles_median"] = float(np.median(t[:, 4:12].max(1)
                                                                  - t[:, 4:12].min(1)))
    res.update(extra or {})
    print(json.dumps(res))


def runs_per_row(s: torch.Tensor) -> np.ndarray:
    return (1 + (s[:, 1:] != s[:, :-1]).sum(1)).cpu().numpy().astype(np.float64)


def tied_columns(a: torch.Tensor, b: torch.Tensor) -> np.ndarray:
    """Per row, the columns l whose query b_l equals some a_k (#{a >= b_l}
    > #{a > b_l}; a nonincreasing): where kernel 8 needs a second search."""
    neg_a, neg_b = (-a).contiguous(), (-b).contiguous()
    tie = (torch.searchsorted(neg_a, neg_b, right=True)
           > torch.searchsorted(neg_a, neg_b, right=False))
    return tie.sum(1).cpu().numpy().astype(np.float64)


def grad_timeline(lib, plain, ptxas, design: str, name: str, rows_list, dev) -> None:
    """Kernel 8 (db only) on the gated step's real rows: the stamps of the
    first of ``rows_list``, the unmodified kernel's device ms over the
    others."""
    a, b, xd = rows_list[0]
    rows, m = a.shape
    db = torch.empty_like(b)
    t = run_stamps(lambda tb, s: lib.coupling_grads_f32(
        a.data_ptr(), b.data_ptr(), xd.data_ptr(), None, db.data_ptr(), rows, m, s, tb), rows, dev)
    if design == "first":  # 256 threads, float64 block scan, two searches per column
        threads, shmem = 256, (m + 1) * 8 + 2 * m * 4
        phases = [("load (behind an added barrier)", t[:, 1]), ("x prefix", t[:, 2]),
                  ("sortedness check", t[:, 3]), ("searches (slowest warp)", t[:, 4:12].max(1)),
                  ("block end", t[:, 12])]
    else:  # one search per distinct query of a warp
        threads = GRAD_THREADS
        shmem = 8 * ((m + 7) & ~3) + (m + 1) * 8 + 8 * threads * -(-m // threads)
        phases = [("load", t[:, 1]), ("prologue: sortedness, x, PX", t[:, 2]),
                  ("heads (slowest warp)", t[:, 3]), ("searches (slowest warp)", t[:, 4]),
                  ("columns (slowest warp)", t[:, 5]), ("block end", t[:, 12])]

    def unmodified(a_, b_, x_):
        out = torch.empty_like(b_)
        _build.check(plain.coupling_grads_f32(a_.data_ptr(), b_.data_ptr(), x_.data_ptr(), None,
                                              out.data_ptr(), rows, m,
                                              torch.cuda.current_stream().cuda_stream),
                     "coupling_grads_f32")
        return out

    ties = tied_columns(a, b)
    report(f"8 coupling_grad_kernel ({design} design), db only", f"{name} gated real [{rows}, {m}]",
           t, ptxas, occupancy(lib, threads, shmem), phases, runs_per_row(b),
           {"work": "distinct values of b per row",
            "tied_columns_per_row_median_max": [float(np.median(ties)), float(ties.max())],
            "corr_block_cycles_tied_columns": float(np.corrcoef(ties, t[:, 12])[0, 1]),
            "unmodified_device_ms": cs.device_ms(unmodified, rows_list[1:],
                                                 "coupling_grad_kernel")})


def main() -> int:
    if len(sys.argv) != 3 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    grad, grad_ptxas, grad_design = instrument(sys.argv[1], "merge_grad")
    grad.coupling_grads_f32.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p] * 2
    grad_plain = ctypes.CDLL(str(_build.BUILD_DIR / "libmerge_grad_timeline_plain.so"))
    grad_plain.coupling_grads_f32.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    merge, merge_ptxas, merge_design = instrument(sys.argv[1], "merge")
    merge_prologue = "row_prologue<" in open(sys.argv[1]).read()  # kernel 4 on the shared prologue
    refgrad, refgrad_ptxas, refgrad_design = instrument(sys.argv[2], "refgrad")
    merge.coupling_forward_f32.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p] * 2
    refgrad.refgrad_beta_f32.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p] * 2
    dev = torch.device("cuda")
    print(cs.card_line())
    torch.manual_seed(0)
    batches = [torch.from_numpy(v).to(dev) for v in cs.make_requests(
        get_experiment("SOT-2048"), dev, 1 + cs.TIMING_INPUTS, seed=3000)]
    x = batches[0]
    for name in ("SOT-2048", "SOT-512"):
        gated = build_modules(get_experiment(name), device=dev, kernels=cs.GATED)
        cs.load_golden_weights(gated, cs.GOLDEN if name == "SOT-2048" else cs.GOLDEN_512)
        grad_timeline(grad, grad_plain, grad_ptxas, grad_design, name,
                      [cs.complements(*cs.sot_rows(gated, v)) for v in batches], dev)
        mod = build_modules(get_experiment(name), device=dev)
        cs.load_golden_weights(mod, cs.GOLDEN if name == "SOT-2048" else cs.GOLDEN_512)
        alpha, beta, gaug = cs.sot_rows(mod, x)
        rows, n = alpha.shape
        a, b, xd = cs.complements(alpha, beta, gaug)
        m = n - 1
        out = torch.empty(rows, device=dev)
        t = run_stamps(lambda tb, s: merge.coupling_forward_f32(
            a.data_ptr(), b.data_ptr(), xd.data_ptr(), out.data_ptr(), rows, m, s, tb), rows, dev)
        slot = 4 * ((m + 7) & ~3)
        if merge_design == "first":  # 256 threads, float64 scans, a search per element
            threads, shmem = 256, 2 * (m + 1) * 8 + m * 4
            phases = [("load", t[:, 1]), ("prefix scan (thread 0)", t[:, 2]),
                      ("suffix scan", t[:, 3]), ("search (slowest warp)", t[:, 4:12].max(1)),
                      ("reduce and write", t[:, 12])]
        else:  # the merge-path walk over the elements
            threads, shmem = 128, 2 * slot + (2 * m + 1) * 8
            names = (("load", "prologue: sortedness, x, PX", "walk") if merge_prologue
                     else ("load", "scan", "prefix PX", "walk"))
            phases = [(p, t[:, k + 1]) for k, p in enumerate(names)] + [
                ("reduce and write", t[:, 12])]
        report(f"4 coupling_fwd_kernel ({merge_design} design)", f"{name} real [{rows}, {m}]",
               t, merge_ptxas, occupancy(merge, threads, shmem), phases,
               runs_per_row(a) + runs_per_row(b))
        wbar = torch.full((rows,), 1.0 / rows, device=dev)
        db = torch.empty_like(beta)
        t = run_stamps(lambda tb, s: refgrad.refgrad_beta_f32(
            alpha.data_ptr(), beta.data_ptr(), gaug.data_ptr(), wbar.data_ptr(), db.data_ptr(),
            rows, n, s, tb), rows, dev)
        if refgrad_design == "first":
            threads, shmem = 256, 3 * n * 4
            phases = [("load", t[:, 1]), ("search (slowest warp)", t[:, 4:12].max(1)),
                      ("write", t[:, 12])]
        else:
            threads, shmem = 256, 2 * 4 * ((n + 7) & ~3)
            phases = [("load", t[:, 1]), ("columns", t[:, 12])]
        report(f"5 refgrad_kernel ({refgrad_design} design)", f"{name} real [{rows}, {n}]", t,
               refgrad_ptxas, occupancy(refgrad, threads, shmem), phases,
               cs.closed_form_columns(beta).sum(1).cpu().numpy().astype(np.float64))
    return 0


if __name__ == "__main__":
    sys.exit(main())
