"""CQT projection: hand-written CUDA kernel and its plain PyTorch version.

Replaces the TPU kernel ``sot_tpu/ops/pallas/cqt.py:_cqt_slab_kernel``
(entry ``cqt_project``). The CUDA source is ``sot_tpu_torch/csrc/cqt.cu``.

    proj[b, f, n] = sum_w xpad[b, f*hop + w] * bank[w, n]

Bound on the H100: operations. Each bin's kernel is non-zero on one centred
interval (14.1% of the bank), so the function is 2*1024*nnz = 5.4 GFLOP per
64-clip request, ~0.033 ms at the 3xTF32 rate (495 / 3 TFLOP/s). The kernel
computes only each column tile's non-zero K range, read from the bank by
``tile_plan``, on the tensor cores with the 3xTF32 split (f32 accuracy: the
bank's TF32 high and low parts come from ``tf32_split``), reading the
overlapping windows straight from the padded signal; work units of a fixed
number of taps (``TilePlan.units``) fill the SMs, and a second pass sums
their partial tiles in a fixed order. See the source for the design notes.

On a CPU tensor ``cqt_project`` runs ``cqt_project_plain``; on a CUDA tensor
it launches the kernel or raises. The kernel has no backward (the CQT's input
is data on every ported path), so on a CUDA input that requires a gradient
under grad mode it raises rather than return a result cut from the graph.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field
from typing import Dict, Tuple

import numpy as np
import torch

from sot_tpu_torch.ops.kernels import _build

# Launches of the CUDA kernel (plain-version calls are not counted).
launches = 0

BM = 128        # frames per block tile (csrc/cqt.cu)
BINS = 32       # bins per column tile
BN = 2 * BINS   # columns per tile: the tile's bins re, then im
BK = 32         # taps per pipeline stage: K ranges and units are multiples
CHUNKS = (512, 1024, 2048, 4096)  # candidate taps per work unit
SLOTS = 132 * 2  # blocks resident at once: 132 SMs, 2 blocks each


def cqt_project_plain(xpad: torch.Tensor, bank: torch.Tensor, hop: int,
                      n_frames: int, n_out: int) -> torch.Tensor:
    """Unfold the windows and one f32 matmul: [B, T_pad] x [W, >= n_out]
    -> [B, n_frames, n_out]."""
    width = bank.shape[0]
    frames = xpad.unfold(1, width, hop)[:, :n_frames]
    return torch.matmul(frames, bank[:, :n_out])


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to TF32 (10 explicit mantissa bits), to nearest with ties
    away from zero: the device's ``cvt.rna.tf32.f32``."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) TF32 parts with hi + lo = x to ~2^-22 relative."""
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


@dataclass
class TilePlan:
    """The column tiles of one bank: ``perm[j]`` the bank column of each of
    tile j's BN columns (-1: none), its non-zero taps ``[k_lo[j], k_hi[j])``
    (multiples of BK) and their rows in ``packed`` from ``offset[j]``."""

    n_out: int
    perm: np.ndarray
    k_lo: np.ndarray
    k_hi: np.ndarray
    offset: np.ndarray
    packed: torch.Tensor
    _units: Dict[int, tuple] = field(default_factory=dict, repr=False)

    @property
    def n_tiles(self) -> int:
        return len(self.perm)

    def col_of_out(self) -> np.ndarray:
        """[n_out] permuted position of each output column."""
        pos = np.empty(self.n_out, np.int32)
        flat = self.perm.ravel()
        pos[flat[flat >= 0]] = np.nonzero(flat >= 0)[0]
        return pos

    def chunk(self, m_rows: int) -> int:
        """Taps per work unit: the candidate whose units, one block each,
        finish soonest on SLOTS resident blocks (ties: the longer chunk,
        fewer partial tiles)."""
        lengths = self.k_hi - self.k_lo
        row_tiles = -(-m_rows // BM)
        best = None
        for c in CHUNKS:
            units = row_tiles * int(np.sum(-(-lengths // c)))
            cost = -(-units // SLOTS) * c
            if best is None or cost <= best[0]:
                best = (cost, c)
        return best[1]

    def units(self, m_rows: int) -> Tuple[np.ndarray, np.ndarray]:
        """(units [U, 4] int32 of (m0, k0, steps, packed row), spans [row
        tiles * n_tiles, 2] int32 of (first unit, count)): each row tile
        times each column tile's K range cut into ``chunk`` taps, in order."""
        got = self._units.get(m_rows)
        if got is None:
            c = self.chunk(m_rows)
            units, spans = [], []
            for rt in range(-(-m_rows // BM)):
                for j in range(self.n_tiles):
                    first = len(units)
                    for k0 in range(int(self.k_lo[j]), int(self.k_hi[j]), c):
                        steps = (min(k0 + c, int(self.k_hi[j])) - k0) // BK
                        units.append((rt * BM, k0, steps,
                                      int(self.offset[j]) + k0 - int(self.k_lo[j])))
                    spans.append((first, len(units) - first))
            got = self._units[m_rows] = (np.asarray(units, np.int32).reshape(-1, 4),
                                         np.asarray(spans, np.int32))
        return got

    def flops(self, m_rows: int) -> float:
        """Operations the kernel's tiles do (2 per multiply-add, once)."""
        return 2.0 * m_rows * BN * float(np.sum(self.k_hi - self.k_lo))


def tile_plan(bank: torch.Tensor, n_out: int) -> TilePlan:
    """The plan for columns [0, n_out) = [re | im] of ``bank`` [W, >= n_out]:
    tile j holds bins [BINS j, BINS (j+1)) re, then im; its K range covers
    every non-zero entry of its columns, rounded out to BK."""
    if n_out % 2:
        raise ValueError(f"cqt plan: n_out {n_out} is not [re | im] of one bin count")
    b = bank[:, :n_out].detach().cpu().numpy()
    width = b.shape[0]
    if width % BK:
        raise ValueError(f"cqt plan: bank width {width} is not a multiple of {BK}")
    bins = n_out // 2
    n_tiles = -(-bins // BINS)
    perm = np.full((n_tiles, BN), -1, np.int64)
    nz = b != 0
    has = nz.any(axis=0)
    first = np.where(has, nz.argmax(axis=0), width)
    last = np.where(has, width - 1 - nz[::-1].argmax(axis=0), -1)
    k_lo = np.zeros(n_tiles, np.int64)
    k_hi = np.zeros(n_tiles, np.int64)
    for j in range(n_tiles):
        lo_bin, hi_bin = BINS * j, min(BINS * (j + 1), bins)
        perm[j, :hi_bin - lo_bin] = np.arange(lo_bin, hi_bin)
        perm[j, BINS:BINS + hi_bin - lo_bin] = np.arange(lo_bin, hi_bin) + bins
        cols = perm[j][perm[j] >= 0]
        if has[cols].any():
            k_lo[j] = first[cols].min() // BK * BK
            k_hi[j] = -(-(last[cols].max() + 1) // BK) * BK
    offset = np.concatenate([[0], np.cumsum(k_hi - k_lo)[:-1]]).astype(np.int64)
    packed = np.zeros((int(np.sum(k_hi - k_lo)), BN), np.float32)
    for j in range(n_tiles):
        valid = perm[j] >= 0
        rows = slice(int(offset[j]), int(offset[j] + k_hi[j] - k_lo[j]))
        packed[rows, valid] = b[k_lo[j]:k_hi[j], perm[j][valid]]
    return TilePlan(n_out, perm, k_lo, k_hi, offset, torch.from_numpy(packed))


_PLANS: dict = {}


def _device_plan(bank: torch.Tensor, n_out: int):
    """(plan, hi, lo, col_of_out) on the bank's device, built once per bank
    (held by the cache, so its storage is not reused while cached)."""
    key = (bank.data_ptr(), tuple(bank.shape), n_out, str(bank.device))
    got = _PLANS.get(key)
    if got is None or got[0] is not bank:
        plan = tile_plan(bank, n_out)
        hi, lo = (t.to(bank.device) for t in tf32_split(plan.packed))
        col = torch.from_numpy(plan.col_of_out()).to(bank.device)
        if len(_PLANS) >= 4:
            _PLANS.pop(next(iter(_PLANS)))
        got = _PLANS[key] = (bank, plan, hi, lo, col, {})
    return got[1:]


def _bind() -> ctypes.CDLL:
    lib = _build.load("cqt")
    fn = lib.cqt_project_tf32x3
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p] * 4
                   + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def cqt_project(xpad: torch.Tensor, bank: torch.Tensor, hop: int, n_frames: int,
                n_out: int) -> torch.Tensor:
    """[B, T_pad] padded audio x [W, ldb] bank -> [B, n_frames, n_out] f32.

    Columns [0, n_out) of ``bank`` are [re | im] of n_out / 2 bins; on CUDA
    the tile plan is built at the first call with a bank and kept.
    """
    if xpad.device.type == "cpu":
        return cqt_project_plain(xpad, bank, hop, n_frames, n_out)
    if xpad.device.type != "cuda" or bank.device != xpad.device:
        raise ValueError(f"cqt_project: tensors on {xpad.device} / {bank.device}")
    if xpad.dtype != torch.float32 or bank.dtype != torch.float32:
        raise TypeError("cqt_project: the CUDA kernel takes float32 audio and bank")
    if torch.is_grad_enabled() and (xpad.requires_grad or bank.requires_grad):
        raise RuntimeError("cqt_project: the CUDA kernel has no backward; its inputs "
                           "must not require a gradient")
    if xpad.ndim != 2 or bank.ndim != 2:
        raise ValueError("cqt_project: expected xpad [B, T] and bank [W, N]")
    if not xpad.is_contiguous():
        raise ValueError("cqt_project: xpad must be contiguous")
    batch, t_pad = xpad.shape
    width, ldb = bank.shape
    if n_out > ldb or n_out % 2 or width % BK:
        raise ValueError(f"cqt_project: bank {tuple(bank.shape)} needs a width multiple of "
                         f"{BK} and [re | im] columns n_out = {n_out} <= its row length")
    if n_frames < 1 or (n_frames - 1) * hop + width > t_pad:
        raise ValueError(f"cqt_project: {n_frames} frames at hop {hop} of width "
                         f"{width} overrun the padded signal of {t_pad}")
    if batch * t_pad >= 2 ** 31:
        raise ValueError("cqt_project: the padded signal exceeds 2^31 samples")
    plan, hi, lo, col, per_rows = _device_plan(bank, n_out)
    m_rows = batch * n_frames
    dev_units = per_rows.get(m_rows)
    if dev_units is None:
        dev_units = per_rows[m_rows] = tuple(torch.from_numpy(a).to(xpad.device)
                                             for a in plan.units(m_rows))
    units, spans = dev_units
    partial = torch.empty((max(len(units), 1), BM, BN), dtype=torch.float32,
                          device=xpad.device)
    out = torch.empty((batch, n_frames, n_out), dtype=torch.float32, device=xpad.device)
    stream = torch.cuda.current_stream(xpad.device).cuda_stream
    err = _bind().cqt_project_tf32x3(xpad.data_ptr(), hi.data_ptr(), lo.data_ptr(),
                                     units.data_ptr(), len(units), spans.data_ptr(),
                                     col.data_ptr(), partial.data_ptr(), out.data_ptr(),
                                     t_pad, n_frames, hop, m_rows, n_out, plan.n_tiles,
                                     stream)
    _build.check(err, "cqt_project_tf32x3")
    global launches
    launches += 1
    return out
