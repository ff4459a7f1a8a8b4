"""Kernels 10 and 11's decomposition (``sot_tpu_torch/csrc/conv.cu``),
emulated fragment by fragment in numpy and held against the plain versions.

The emulation builds every tensor-core operand the way the kernels' lanes
load it: the taps padded from k to 16 with zero weights, C_out padded to n8
tiles, the input strip with its halo staged with zeros outside the row, the
Hankel operand read as bf16 pair words (bf16) or as six split f32 values
per lane (3xTF32), the weights in fragment order, the output stage and its
masked stores, and kernel 11's chunks of rows summed in their fixed order.
Each lane's registers are placed where ``mma.sync`` reads them (m16n8k16
bf16, m16n8k8 TF32), so a wrong index map in the source's formulas shows
up as a wrong sum here.

Tolerances: against ``conv1d_same_plain``/``conv1d_weight_plain`` within
1e-5 of the max (chip_smoke's CONV_LIMIT), in both operand types: the bf16
products are exact and only the order of the f32 sums differs; the 3xTF32
products drop lo*lo and the split's remainder (at most ~2^-21 of each
product).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from sot_tpu_torch.ops.kernels import conv as kconv
from sot_tpu_torch.ops.kernels.cqt import tf32_round
from test_conv_pallas import SHAPES

LANE = np.arange(32)
G, T = LANE // 4, LANE % 4
SPAN = kconv.STRIP + kconv.TAPS
FWD_WARPS = kconv.STRIP // 32
DW_WARPS = 8
FWD_CH, DW_STEPS = 8, 6  # bf16 channels / k16 steps per tensor-core stage
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _bf16(a: np.ndarray) -> np.ndarray:
    return kconv.round_to(torch.from_numpy(np.ascontiguousarray(a, np.float32)),
                          torch.bfloat16).numpy()


def _tf32(a: np.ndarray) -> np.ndarray:
    """f32 rounded to TF32, to nearest with ties away from zero."""
    return tf32_round(torch.from_numpy(np.ascontiguousarray(a, np.float32))).numpy()


def _split(a: np.ndarray):
    """The kernels' 3xTF32 split: hi = tf32(a), lo = tf32(a - hi)."""
    hi = _tf32(a)
    return hi, _tf32(a - hi)


def _strip(rows: np.ndarray, start: int, n: int) -> np.ndarray:
    """[C, n] of rows [C, W] from bin ``start``, zeros outside [0, W)."""
    out = np.zeros((rows.shape[0], n), np.float32)
    w = start + np.arange(n)
    ok = (w >= 0) & (w < rows.shape[1])
    out[:, ok] = rows[:, w[ok]]
    return out


def _hankel_bf16(raw: np.ndarray, bases: np.ndarray) -> np.ndarray:
    """A [C, tiles, 16, 16] of the Hankel operand from pair words P[j] =
    (x[j], x[j + 1]): registers P[b + g + 2t], P[b + g + 8 + 2t] (twice),
    P[b + g + 2t + 16] at A[g][2t..], A[g+8][2t..], A[g][2t+8..],
    A[g+8][2t+8..]."""
    lo = _bf16(raw)
    hi = np.concatenate([lo[:, 1:], np.zeros_like(lo[:, :1])], axis=1)
    a = np.zeros((raw.shape[0], len(bases), 16, 16), np.float64)
    for i, base in enumerate(bases):
        idx = base + G + 2 * T
        for row, col, word in ((0, 0, 0), (8, 0, 8), (0, 8, 8), (8, 8, 16)):
            a[:, i, G + row, 2 * T + col] = lo[:, idx + word]
            a[:, i, G + row, 2 * T + col + 1] = hi[:, idx + word]
    return a


def _hankel_tf32(raw: np.ndarray, bases: np.ndarray):
    """(hi, lo) A [C, tiles, 16, 16] of the Hankel operand as the TF32 lanes
    read it: values at b + g + t + {0, 4, ..., 20}; k8 step 0 takes offsets
    {0, 8, 4, 12} as a0..a3 at (g, t), (g+8, t), (g, t+4), (g+8, t+4), step 1
    {8, 16, 12, 20}."""
    hi = np.zeros((raw.shape[0], len(bases), 16, 16), np.float64)
    lo = np.zeros_like(hi)
    for i, base in enumerate(bases):
        vals = [raw[:, base + G + T + 4 * o] for o in range(6)]
        for step, offs in ((0, (0, 2, 1, 3)), (1, (2, 4, 3, 5))):
            for reg, o in enumerate(offs):
                row, col = G + 8 * (reg & 1), T + 4 * (reg >> 1) + 8 * step
                hi[:, i, row, col], lo[:, i, row, col] = _split(vals[o])
    return hi, lo


def _product(a, b, bf16: bool) -> np.ndarray:
    """One zeroed tensor-core stage: the sum over the leading axis (the
    stage's channels or k16 steps) of A [.., 16, 16] @ B [.., 16, 8],
    rounded to f32 as the fragment is read back."""
    if bf16:
        return np.matmul(a, b).sum(axis=0).astype(np.float32)
    (ah, al), (bh, bl) = a, b
    return (np.matmul(al, bh) + np.matmul(ah, bl) + np.matmul(ah, bh)).sum(axis=0) \
        .astype(np.float32)


def _weight_b(weight: np.ndarray, bf16: bool):
    """B [C_in, NT, 16, 8] of B10 from the weights in fragment order: per
    (ci, n8 tile j, lane) the taps 2t, 2t+1, 2t+8, 2t+9 (bf16) or t, t+4,
    t+8, t+12 (TF32) of co = 8j + g, zero past C_out and past k."""
    cout, cin, k = weight.shape
    nt = -(-cout // 8)
    w16 = np.zeros((nt * 8, cin, kconv.TAPS), np.float32)
    w16[:cout, :, :k] = weight
    taps = ([2 * T, 2 * T + 1, 2 * T + 8, 2 * T + 9] if bf16
            else [T, T + 4, T + 8, T + 12])
    parts = [np.zeros((cin, nt, 16, 8), np.float64) for _ in range(1 if bf16 else 2)]
    for j in range(nt):
        co = 8 * j + G
        for tap in taps:
            v = w16[co, :, tap].T  # [C_in, 32 lanes]
            if bf16:
                parts[0][:, j, tap, G] = _bf16(v)
            else:
                parts[0][:, j, tap, G], parts[1][:, j, tap, G] = _split(v)
    return parts[0] if bf16 else (parts[0], parts[1])


def emulate_fwd(x: np.ndarray, weight: np.ndarray, dtype: torch.dtype,
                n_sm: int = 132) -> np.ndarray:
    """Kernel 10 on x [B, C_in, W], weight [C_out, C_in, k]."""
    rows, cin, width = x.shape
    cout, _, k = weight.shape
    pad, nt, bf16 = (k - 1) // 2, -(-cout // 8), dtype == torch.bfloat16
    y = np.full((rows, cout, width), np.nan, np.float32)
    b_op = _weight_b(weight, bf16)
    strips = kconv.n_strips(width)
    blocks = kconv.fwd_blocks(rows, width, n_sm)
    done = np.zeros(rows * strips, int)
    for block in range(blocks):
        for item in range(block, rows * strips, blocks):  # the persistent walk
            done[item] += 1
            b, s = divmod(item, strips)
            w0 = s * kconv.STRIP
            nbins = min(kconv.STRIP, width - w0)
            raw = _strip(x[b], w0 - pad, SPAN)
            stage = np.full((nt * 8, kconv.STRIP + 4), np.nan, np.float32)
            for warp in range(FWD_WARPS):
                mb = 32 * warp
                if mb >= nbins:
                    continue
                bases = np.array([mb, mb + 16])
                a_op = _hankel_bf16(raw, bases) if bf16 else _hankel_tf32(raw, bases)
                acc = np.zeros((2, nt, 16, 8), np.float32)
                group = FWD_CH if bf16 else 1
                for c0 in range(0, cin, group):  # each stage of channels added in f32
                    cs = slice(c0, min(c0 + group, cin))
                    a = a_op[cs][:, :, None] if bf16 else tuple(p[cs][:, :, None] for p in a_op)
                    bb = b_op[cs][:, None] if bf16 else tuple(p[cs][:, None] for p in b_op)
                    acc += _product(a, bb, bf16)
                for mt in range(2):
                    for j in range(nt):
                        for q in range(4):  # c_q at (bin g + 8 (q >> 1), co 2t + (q & 1))
                            m, n = G + 8 * (q >> 1), 2 * T + (q & 1)
                            stage[8 * j + n, mb + 16 * mt + m] = acc[mt, j, m, n]
            y[b, :, w0:w0 + nbins] = stage[:cout, :nbins]  # the masked stores
    assert (done == 1).all()
    return y


def emulate_dw(x: np.ndarray, dy: np.ndarray, k: int, dtype: torch.dtype,
               n_sm: int = 132) -> np.ndarray:
    """Kernel 11 on x [B, C_in, W], dy [B, C_out, W] -> dW [C_out, C_in, k]."""
    rows, cin, width = x.shape
    cout = dy.shape[1]
    pad, nt, bf16 = (k - 1) // 2, -(-cout // 8), dtype == torch.bfloat16
    per, chunks = kconv.dw_chunks(rows, n_sm)
    partial = np.full((chunks, cout, cin, k), np.nan, np.float32)
    seen = np.zeros(rows, int)
    for s in range(chunks):
        acc = np.zeros((cin, nt, 16, 8), np.float32)
        for b in range(s * per, min(s * per + per, rows)):
            seen[b] += 1
            for strip in range(kconv.n_strips(width)):
                w0 = strip * kconv.STRIP
                raw_x = _strip(x[b], w0 - pad, SPAN)
                raw_dy = np.zeros((nt * 8, kconv.STRIP), np.float32)
                raw_dy[:cout] = _strip(dy[b], w0, kconv.STRIP)
                if bf16:
                    dyv = _bf16(raw_dy)
                steps = -(-min(kconv.STRIP, width - w0) // 16)
                for s0 in range(0, steps, DW_STEPS if bf16 else 1):
                    stage = range(s0, min(s0 + (DW_STEPS if bf16 else 1), steps))
                    a_st, bh_st, bl_st = [], [], []
                    for step in stage:
                        kb = 16 * step
                        # A: tap g (+8) x bin kb + ..: the Hankel operand of each channel
                        a_st.append(_hankel_bf16(raw_x, [kb])[:, 0] if bf16
                                    else tuple(p[:, 0] for p in _hankel_tf32(raw_x, [kb])))
                        # B: bin x co, dy[8j + g][kb + ..] in pair words (bf16:
                        # words kb / 2 + t and + 4) or at kb + t (+4, +8, +12) (TF32)
                        bh = np.zeros((nt, 16, 8))
                        bl = np.zeros((nt, 16, 8))
                        for j in range(nt):
                            co = 8 * j + G
                            kks = ([2 * T, 2 * T + 1, 2 * T + 8, 2 * T + 9] if bf16
                                   else [T, T + 4, T + 8, T + 12])
                            for kk in kks:
                                if bf16:
                                    bh[j, kk, G] = dyv[co, kb + kk]
                                else:
                                    bh[j, kk, G], bl[j, kk, G] = _split(raw_dy[co, kb + kk])
                        bh_st.append(bh)
                        bl_st.append(bl)
                    if bf16:
                        acc += _product(np.stack(a_st)[:, :, None], np.stack(bh_st)[:, None],
                                        True)
                    else:
                        acc += _product(tuple(p[None, :, None] for p in a_st[0]),
                                        (bh_st[0][None, None], bl_st[0][None, None]), False)
        for j in range(nt):
            for q in range(4):  # c_q at (tap g + 8 (q >> 1), co 2t + (q & 1))
                d, n = G + 8 * (q >> 1), 2 * T + (q & 1)
                co = 8 * j + n
                keep = (co < cout) & (d < k)
                partial[s, co[keep], :, d[keep]] = acc[:, j, d[keep], n[keep]].T
    assert (seen == 1).all()
    out = np.zeros((cout, cin, k), np.float32)
    for s in range(chunks):  # the fixed-order reduction
        out += partial[s]
    return out


def _case(b, w, cin, cout, k, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, cin, w)).astype(np.float32)
    weight = (rng.standard_normal((cout, cin, k)) / np.sqrt(k * cin)).astype(np.float32)
    dy = rng.standard_normal((b, cout, w)).astype(np.float32)
    return x, weight, dy


def _rel(got: np.ndarray, ref: torch.Tensor) -> float:
    ref = ref.numpy()
    return float(np.abs(got - ref).max() / np.abs(ref).max())


# the SHAPES of tests/test_conv_pallas.py, and few-row cuts of conv1's and the
# prefilter's main-path shapes [1024, C, 285] (one of them wider than a strip)
CASES = list(SHAPES) + [(3, 285, 1, 40, 15), (2, 285, 40, 40, 15), (2, 300, 40, 40, 15)]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("b,w,cin,cout,k", CASES)
def test_emulated_kernels_match_plain(b, w, cin, cout, k, dtype):
    x, weight, dy = _case(b, w, cin, cout, k, seed=b * 1000 + w + cin + k)
    dt = DTYPES[dtype]
    xt, wt, dyt = (torch.from_numpy(a) for a in (x, weight, dy))
    wflip = np.ascontiguousarray(weight[:, :, ::-1].transpose(1, 0, 2))
    assert _rel(emulate_fwd(x, weight, dt), kconv.conv1d_same_plain(xt, wt, dt)) <= 1e-5
    assert _rel(emulate_fwd(dy, wflip, dt),
                kconv.conv1d_same_plain(dyt, torch.from_numpy(wflip), dt)) <= 1e-5
    # a chunk plan of several rows per chunk as well as one row per chunk
    for n_sm in (132, 2):
        assert _rel(emulate_dw(x, dy, k, dt, n_sm), kconv.conv1d_weight_plain(xt, dyt, k, dt)) \
            <= 1e-5


@pytest.mark.parametrize("rows,width,n_sm", [(1024, 285, 132), (4, 33, 132), (1, 600, 132),
                                             (1000, 285, 7), (133, 1, 132)])
def test_work_split_covers_every_item_once(rows, width, n_sm):
    """B10's persistent blocks walk every (row, strip) item once; B11's chunks
    cover every row once, at most one chunk per SM."""
    strips = kconv.n_strips(width)
    assert (strips - 1) * kconv.STRIP < width <= strips * kconv.STRIP
    blocks = kconv.fwd_blocks(rows, width, n_sm)
    assert 1 <= blocks <= n_sm
    walked = sorted(i for blk in range(blocks) for i in range(blk, rows * strips, blocks))
    assert walked == list(range(rows * strips))
    per, chunks = kconv.dw_chunks(rows, n_sm)
    assert chunks <= n_sm and (chunks - 1) * per < rows <= chunks * per
    if (rows, n_sm) == (1024, 132):
        assert (per, chunks) == (8, 128)


def test_tf32_split_reconstructs_to_2_23():
    """hi + lo recovers each operand to 2^-23 relative; the product terms the
    kernels keep (hi*hi + hi*lo + lo*hi) are within 2^-21 of the exact
    product (the dropped lo*lo is at most 2^-22 of it). The integer rounding
    is the host's ``tf32_round`` (kernel 1's) on the same bits."""
    v = np.random.default_rng(0).standard_normal(4096).astype(np.float32)
    v = np.concatenate([v, v * 2.0 ** -100, v * 2.0 ** 100]).astype(np.float32)
    hi, lo = _split(v)
    assert np.all(np.abs((hi.astype(np.float64) + lo) - v) <= 2.0 ** -23 * np.abs(v))
    bits = hi.view(np.uint32)
    assert not np.any(bits & 0x1FFF) and not np.any(lo.view(np.uint32) & 0x1FFF)
    u = np.roll(v, 1)
    uh, ul = _split(u)
    kept = hi.astype(np.float64) * uh + hi.astype(np.float64) * ul + lo.astype(np.float64) * uh
    exact = v.astype(np.float64) * u
    assert np.all(np.abs(kept - exact) <= 2.0 ** -21 * np.abs(exact))
