"""Kernels 6 and 7's work partition and summation order
(``sot_tpu_torch/csrc/plane.cu``), transcribed in numpy and held against the
plain versions.

A group of ``tpr`` threads walks one row's merge path of alpha and beta:
thread r owns the positions k in [r L, (r + 1) L), L = ceil((2n + 1) /
tpr), finds the position before its first by one co-rank binary search and
steps i where alpha_i <= beta_j, else j. It evaluates the cell at each
position inside the plane and adds it where m = [min(alpha_i, beta_j) >
max(gamma_i, delta_j)] holds. The forward adds its cells in float64 in path
order, then a shfl_down tree over the lanes and the warps in order. The
backward keeps two open sums per side (key cur - 1 and key cur), closes a
key when it leaves a column (row), keeps the first two keys it closes until
the carry from the earlier slices is known, and joins the carries by a
shfl_up scan of maps (P, C) -> (P + x, C + y) / (C + x, y) / (x, y), then the
group's warps in order. Each f32 product is rounded as in the kernel (numpy
float32 scalars: one rounding per operation, no FMA).

Tolerances: bit for bit against ``sot_plane_forward_plain`` /
``sot_plane_backward_plain`` on ``chip_smoke.dyadic_plane_rows`` (every
product and sum exact); within ``chip_smoke.PLANE_LIMITS`` (W per row, the
cotangents over their max) elsewhere: both sum the same f32 cell products in
float64 and round once, in other orders.
"""

from __future__ import annotations

import math
import os

import numpy as np
import pytest
import torch

import chip_smoke
from sot_tpu_torch.ops.kernels import plane as kplane

F32 = np.float32
GOLDEN_512 = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "sot_tpu_torch", "golden", "sot512_seed42_trainstep.npz")
IDENTITY = (0, 0.0, 0.0)


def dist_pow(d, p: float):
    if p == 2.0:
        return F32(d * d)
    a = F32(abs(d))
    if p == 1.0:
        return a
    if p == 3.0:
        return F32(F32(a * a) * a)
    return F32(a ** F32(p))


def nonempty(x):
    """The rows (columns) whose interval (x_{e-1}, x_e] is not empty, x_{-1} = 0."""
    return np.flatnonzero(x > np.concatenate([[F32(0)], x[:-1]]))


def corank(al, be, ia, jb, k: int) -> int:
    """rows.cuh:corank as plane.cu calls it, over the nonempty intervals:
    the largest p with alpha'_{p-1} <= beta'_{k-p}."""
    lo, hi = max(0, k - len(jb)), min(k, len(ia))
    while lo < hi:
        mid = (lo + hi + 1) >> 1
        if al[ia[mid - 1]] <= be[jb[k - mid]]:
            lo = mid
        else:
            hi = mid - 1
    return lo


def compose(e, l):
    """plane.cu:compose: the map of slice e, then slice l."""
    s = min(e[0] + l[0], 2)
    if l[0] == 0:
        return (s, e[1] + l[1], e[2] + l[2])
    if l[0] == 1:
        return (s, e[2] + l[1], l[2])
    return (s, l[1], l[2])


class Keys:
    """plane.cu:Keys: one side's open sums along a thread's walk."""

    def __init__(self, start: int, out: np.ndarray, writes: np.ndarray):
        self.P = self.C = self.pend1 = self.pend2 = 0.0
        self.moves, self.start, self.out, self.writes = 0, start, out, writes

    def leave(self, cur: int):
        if self.moves == 0:
            self.pend1 = self.P
        elif self.moves == 1:
            self.pend2 = self.P
        else:
            self.write(cur - 1, self.P)
        self.moves += 1
        self.P, self.C = self.C, 0.0

    def write(self, key: int, v: float):
        self.out[key] = F32(v)
        self.writes[key] += 1

    def map(self):
        return (min(self.moves, 2), self.P, self.C)

    def settle(self, carry):
        if self.moves >= 1 and self.start >= 1:
            self.write(self.start - 1, carry[1] + self.pend1)
        if self.moves >= 2:
            self.write(self.start, carry[2] + self.pend2)


def carries(maps):
    """plane.cu:carry_in: the exclusive scan of the group's maps, a shfl_up
    tree in each warp of 32, then the earlier warps' totals in order."""
    out, totals = [], []
    for w0 in range(0, len(maps), 32):
        incl = list(maps[w0:w0 + 32])
        d = 1
        while d < 32:
            incl = [compose(incl[l - d], incl[l]) if l >= d else incl[l] for l in range(32)]
            d <<= 1
        excl = [IDENTITY] + incl[:31]
        pre = IDENTITY
        for t in totals:
            pre = compose(pre, t)
        out += [compose(pre, e) for e in excl]
        totals.append(incl[31])
    return out


def warp_tree(v):
    """The forward's shfl_down tree over 32 lanes: lane 0's sum."""
    v = list(v)
    off = 16
    while off:
        v = [v[l] + (v[l + off] if l + off < 32 else v[l]) for l in range(32)]
        off >>= 1
    return v[0]


def side_at(x, g, e: int):
    """plane.cu:side_at: (x_e, x_{e-1} or 0, g_e); past the end x_e repeats."""
    n = len(x)
    v = x[min(e, n - 1)]
    return v, (v if e == n else (x[e - 1] if e > 0 else F32(0))), g[min(e, n - 1)]


def walk_row(al, be, g, p: float, w, tpr: int, alpha_grads: bool = True):
    """One row through the kernels' walk over its nonempty intervals: (W,
    dalpha, dbeta, cells evaluated with m = 1 in visit order, path positions
    per slice, writes per key of dbeta and of dalpha)."""
    n = len(al)
    al, be, g, w = np.asarray(al, F32), np.asarray(be, F32), np.asarray(g, F32), F32(w)
    ia, jb = nonempty(al), nonempty(be)
    na, nb = len(ia), len(jb)
    npos = na + nb + 1
    length = (npos + tpr - 1) // tpr
    db, da = np.zeros(n, F32), np.zeros(n, F32)
    db_writes, da_writes = np.zeros(n, np.int64), np.zeros(n, np.int64)
    # keys no cell feeds: intervals e and e + 1 both empty
    for x, out, writes in ((be, db, db_writes), (al, da, da_writes)):
        empty = ~np.isin(np.arange(n), nonempty(x))
        for e in np.flatnonzero(empty[:-1] & empty[1:]):
            out[e] = 0
            writes[e] += 1
    accs, cols, rows, cells, positions = [], [], [], [], []
    for r in range(tpr):
        k0 = min(r * length, npos)
        k1 = min(k0 + length, npos)
        positions.append(k1 - k0)
        acc = 0.0
        col, row = Keys(0, db, db_writes), Keys(0, da, da_writes)
        if k0 < k1:
            pp = 0 if k0 == 0 else corank(al, be, ia, jb, k0 - 1)
            qq = 0 if k0 == 0 else k0 - 1 - pp
            i = ia[pp] if pp < na else n
            j = jb[qq] if qq < nb else n
            (a, c, gi), (b, d, gj) = side_at(al, g, i), side_at(be, g, j)
            col, row = Keys(j, db, db_writes), Keys(i, da, da_writes)
            for k in range(k0, k1):
                if k > 0:
                    if qq == nb or (pp < na and a <= b):
                        pp += 1
                        ni = ia[pp] if pp < na else n
                        if alpha_grads:
                            row.leave(i)
                            if ni != i + 1:
                                row.leave(i + 1)
                        i = ni
                        a, c, gi = side_at(al, g, i)
                    else:
                        qq += 1
                        nj = jb[qq] if qq < nb else n
                        col.leave(j)
                        if nj != j + 1:
                            col.leave(j + 1)
                        j = nj
                        b, d, gj = side_at(be, g, j)
                if min(a, b) > max(c, d):
                    cells.append((i, j))
                    dist = dist_pow(F32(g[j] - g[i]), p)
                    acc += float(F32(F32(min(a, b) - max(c, d)) * dist))
                    kk = F32(F32(F32(1) * dist) * w)
                    wa = F32(1 if a < b else (0.5 if a == b else 0))
                    wc = F32(1 if c > d else (0.5 if c == d else 0))
                    kwa, kwc = F32(kk * wa), F32(kk * wc)
                    col.C += float(F32(kk - kwa))
                    col.P += float(F32(kwc - kk))
                    if alpha_grads:
                        row.C += float(kwa)
                        row.P -= float(kwc)
            if k1 == npos:
                col.leave(n)
                if alpha_grads:
                    row.leave(n)
        accs.append(acc)
        cols.append(col)
        rows.append(row)
    sides = [cols] + ([rows] if alpha_grads else [])
    for side in sides:
        for keys, carry in zip(side, carries([k.map() for k in side])):
            keys.settle(carry)
    warps = [warp_tree(accs[w0:w0 + 32]) for w0 in range(0, tpr, 32)]
    total = warps[0]
    for v in warps[1:]:
        total += v
    return (F32(total), da if alpha_grads else None, db, cells, positions, db_writes,
            da_writes if alpha_grads else None)


def walk(alpha, beta, g, p, wbar, tpr=None, alpha_grads=True):
    """Every row through walk_row; (W, dalpha, dbeta, per-row results)."""
    rows, n = alpha.shape
    tpr = tpr or kplane.THREADS_PER_ROW
    res = [walk_row(alpha[r], beta[r], g, p, wbar[r], tpr, alpha_grads) for r in range(rows)]
    w = np.array([x[0] for x in res], F32)
    da = np.stack([x[1] for x in res]) if alpha_grads else None
    db = np.stack([x[2] for x in res])
    return w, da, db, res


def plain(alpha, beta, g, p, wbar):
    t = [torch.from_numpy(np.ascontiguousarray(x)) for x in (alpha, beta, g, wbar)]
    w = kplane.sot_plane_forward_plain(*t[:3], p).numpy()
    da, db = (x.numpy() for x in kplane.sot_plane_backward_plain(*t[:3], p, t[3], True))
    return w, da, db


def dense_mask(a, b):
    c = np.concatenate([[0], a[:-1]]).astype(F32)
    d = np.concatenate([[0], b[:-1]]).astype(F32)
    return np.minimum(a[:, None], b[None, :]) > np.maximum(c[:, None], d[None, :])


def check_rows(alpha, beta, g, wbar, p, exact, tpr=None):
    """The transcription against the plain versions and the dense mask."""
    w, da, db, res = walk(alpha, beta, g, p, wbar, tpr)
    pw, pda, pdb = plain(alpha, beta, g, p, wbar)
    n = alpha.shape[1]
    for r, x in enumerate(res):
        cells = x[3]
        mask = dense_mask(alpha[r], beta[r])
        assert len(cells) == len(set(cells)) == int(mask.sum()) <= 2 * n - 1
        assert all(mask[i, j] for i, j in cells)
        assert (x[5] == 1).all() and (x[6] == 1).all()  # every key written once
        # slices of the na + nb + 1 positions, each at most one more cell than
        # an even share of the mu > 0 cells
        npos = sum(x[4])
        assert npos == len(nonempty(alpha[r])) + len(nonempty(beta[r])) + 1
        assert len(cells) <= npos <= 2 * n + 1
        assert max(x[4]) <= math.ceil(npos / len(x[4]))
    if exact:
        np.testing.assert_array_equal(w, pw)
        np.testing.assert_array_equal(da, pda)
        np.testing.assert_array_equal(db, pdb)
    else:
        w_lim, d_lim = chip_smoke.PLANE_LIMITS
        assert float(np.max(np.abs(w - pw) / np.maximum(np.abs(pw), 1e-30))) <= w_lim
        for got, ref in ((da, pda), (db, pdb)):
            assert float(np.abs(got - ref).max()) <= d_lim * float(np.abs(ref).max())
    return w, da, db


@pytest.mark.parametrize("n,tpr", [(40, 32), (93, 64), (40, None), (258, None)])
@pytest.mark.parametrize("p", [2.0, 3.0])
def test_walk_bit_equal_to_plain_on_dyadic_rows(n, tpr, p):
    alpha, beta, g, wbar = chip_smoke.dyadic_plane_rows(np.random.default_rng(n), 8, n)
    check_rows(alpha, beta, g, wbar, p, True, tpr)


@pytest.mark.parametrize("n,rows,tpr", [(40, 16, 64), (1026, 2, None)])
def test_walk_matches_plain_on_random_rows(n, rows, tpr):
    alpha, beta, g, wbar = chip_smoke.random_plane_rows(np.random.default_rng(1), rows, n)
    check_rows(alpha, beta, g, wbar, 2.0, False, tpr)


def test_walk_matches_plain_on_golden_rows():
    """The SOT-512 golden's real rows (sorted; the per-column design's
    slowest lane held 37.6 cells against a mean of 0.95 on them)."""
    with np.load(GOLDEN_512) as z:
        alpha, beta, g = z["sot_alpha"][:24], z["sot_beta"][:24], z["sot_gaug"]
    wbar = (np.random.default_rng(2).random(len(alpha)) + 0.5).astype(F32)
    assert not kplane.full_scan_rows(torch.from_numpy(alpha), torch.from_numpy(beta)).any()
    check_rows(alpha, beta, g, wbar, 2.0, False)


STRESS = ["spike beta", "spike alpha", "beta = alpha", "zero-mass stretch"]


@pytest.mark.parametrize("which", range(4))
@pytest.mark.parametrize("tpr", [32, 128])
def test_walk_on_stress_rows(which, tpr):
    """chip_smoke.stress_plane_rows, one kind a row."""
    n = 41
    alpha, beta, g, wbar = chip_smoke.stress_plane_rows(4, n)
    alpha, beta, wbar = alpha[which:which + 1], beta[which:which + 1], wbar[which:which + 1]
    w, da, db = check_rows(alpha, beta, g, wbar, 2.0, False, tpr)
    cells = walk_row(alpha[0], beta[0], g, 2.0, wbar[0], tpr)[3]
    name = STRESS[which]
    if name.startswith("spike"):
        # the spike's column (row) spans the whole other side
        side = [j for i, j in cells] if name == "spike beta" else [i for i, j in cells]
        assert side.count(n // 2) == n
    if name == "beta = alpha":
        assert all(i == j for i, j in cells) and float(w[0]) == 0.0
    if name == "zero-mass stretch":
        assert len(nonempty(alpha[0])) <= n // 2 + 2


@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("tie", [False, True])
def test_walk_at_one_and_two_columns(n, tie):
    rng = np.random.default_rng(n)
    a = np.sort(rng.integers(1, 5, n)).astype(F32) / 4
    b = a.copy() if tie else np.sort(rng.integers(1, 5, n)).astype(F32) / 4
    g = np.arange(n, dtype=F32) / 2
    check_rows(a[None], b[None], g, np.array([0.5], F32), 2.0, True, 32)


def test_corank_is_the_merge_path():
    """The co-rank search over the nonempty intervals lands on the merge
    path of alpha' and beta' (plateaus and ties between the sides)."""
    alpha, beta, _, _ = chip_smoke.random_plane_rows(np.random.default_rng(3), 4, 40)
    alpha[:, 10:20] = alpha[:, 10:11]
    beta[:, 15:25] = alpha[:, 10:11]
    beta = np.maximum.accumulate(beta, 1)
    for r in range(len(alpha)):
        ia, jb = nonempty(alpha[r]), nonempty(beta[r])
        i, j = kplane.staircase(torch.from_numpy(alpha[r][ia][None]),
                                torch.from_numpy(beta[r][jb][None]))
        k = len(ia) + len(jb) + 1
        assert [corank(alpha[r], beta[r], ia, jb, q) for q in range(k)] == i[0].tolist()
        assert (i[0] + j[0]).tolist() == list(range(k))


def test_full_scan_rows_flags_unsorted_and_nan_rows():
    alpha, beta, _, _ = chip_smoke.random_plane_rows(np.random.default_rng(4), 6, 30)
    alpha[1, 5] = alpha[1, 6] + 0.5
    beta[3, 0] = np.nan
    alpha[4, 12] = np.nan
    got = kplane.full_scan_rows(torch.from_numpy(alpha), torch.from_numpy(beta)).tolist()
    assert got == [False, True, False, True, True, False]


def test_walk_carries_gamma_over_empty_intervals():
    """The kernels' step takes the new row's gamma_i as the old nonempty
    row's alpha: on a sorted row every interval between two nonempty ones is
    empty, so alpha is constant across them."""
    with np.load(GOLDEN_512) as z:
        rows = list(z["sot_alpha"][:32]) + list(z["sot_beta"][:32])
    rows += list(chip_smoke.stress_plane_rows(4, 41)[0])
    for x in rows:
        ia = nonempty(x)
        assert all(x[ia[p] - 1] == x[ia[p - 1]] for p in range(1, len(ia)))
