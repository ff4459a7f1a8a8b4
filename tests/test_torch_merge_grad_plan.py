"""Kernel 8's per-warp plan (``sot_tpu_torch/csrc/merge.cu``'s coupling
gradient, min-halving convention), transcribed in numpy and held against
``coupling_grads_plain``.

  * A block of GT = 128 threads owns one row, and row_prologue (shared with
    kernel 4, ``chunk_prefix`` of ``tests/test_torch_rank_plan.py`` at 128
    threads) gives PX. Warp w takes the 32-column chunks w, w + 4, w + 8,
    ... of the row: its columns, in that order.
  * Its heads: its first column and each column whose query differs (!=)
    from that of the column before it among its columns, compacted in
    order. A sorted row's equal queries are neighbours, so each distinct
    value of the warp's columns has one head.
  * One binary search of s per head gives #{s > v}; only where s[strict] ==
    v (a tie) and the tie does not run to the row's end does a second one,
    past the tied run, give #{s >= v} (m where it runs to the end). The
    head keeps its weight 0.5 * (PX[strict] + PX[incl]) in float64.
  * Each column: x_l * its head's weight in float64, rounded once to f32.
  * A side whose s is not nonincreasing (or holds a NaN) scans s whole per
    column, in k order.

Tolerances: bit for bit against the plain version on rows whose grid
deltas are dyadic (every prefix sum exact; the result depends on a and b
only through comparisons), within chip_smoke's COUPLING_GRAD_LIMIT of the
max elsewhere (the plain version sums PX by ``torch.cumsum``, the plan in
the prologue's order). The searches: exactly the distinct values of each
warp's columns plus those of them that tie a value of s short of its end.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import chip_smoke
from sot_tpu_torch.ops.kernels import merge as kmerge
from test_torch_rank_plan import chunk_prefix

GT = 128  # merge.cu's GT
WARPS = GT // 32
F32 = np.float32


def warp_columns(m: int):
    """The columns of each warp of a block, in the warp's order."""
    chunks = -(-m // GT)
    return [[c for k in range(chunks) for c in range((w + WARPS * k) * 32,
                                                     (w + WARPS * k) * 32 + 32) if c < m]
            for w in range(WARPS)]


def first_false(pred, lo: int, hi: int) -> int:
    """The binary search of the kernel: the first k in [lo, hi) with
    !pred(k), pred true then false along it."""
    while lo < hi:
        mid = (lo + hi) >> 1
        if pred(mid):
            lo = mid + 1
        else:
            hi = mid
    return lo


def sorted_row(s) -> bool:
    """row_prologue's test: nonincreasing, no NaN."""
    return bool(np.all(s[1:] <= s[:-1])) and not np.isnan(s[0])


def side_plan(s, q, x, px):
    """(out [m] f32, the searches) of one side of one row."""
    m = len(q)
    out = np.empty(m, F32)
    x64 = x.astype(np.float64)
    if not sorted_row(s):
        for l in range(m):
            strict = incl = 0.0
            for k in range(m):
                strict += x64[k] if s[k] > q[l] else 0.0
                incl += x64[k] if s[k] >= q[l] else 0.0
            out[l] = F32(x64[l] * (0.5 * (strict + incl)))
        return out, 0
    searches = 0
    for cols in warp_columns(m):
        heads, head_of = [], []
        for i, l in enumerate(cols):
            if i == 0 or q[l] != q[cols[i - 1]]:
                heads.append(q[l])
            head_of.append(len(heads) - 1)
        weights = []
        for v in heads:
            strict = first_false(lambda k: s[k] > v, 0, m)
            incl = strict
            searches += 1
            if strict < m and s[strict] == v:
                if s[m - 1] == v:  # the tie runs to the end
                    incl = m
                else:
                    incl = first_false(lambda k: s[k] >= v, strict + 1, m - 1)
                    searches += 1
            weights.append(0.5 * (px[strict] + px[incl]))
        for l, h in zip(cols, head_of):
            out[l] = F32(x64[l] * weights[h])
    return out, searches


def grads_plan(a, b, x, alpha_grads: bool):
    """(da or None, db, searches) of kernel 8 over the rows."""
    px = chunk_prefix(x, GT)
    da, db, searches = [], [], 0
    for ar, br in zip(a, b):
        out, n = side_plan(ar, br, x, px)
        db.append(out)
        searches += n
        if alpha_grads:
            out, n = side_plan(br, ar, x, px)
            da.append(out)
            searches += n
    return (np.stack(da) if alpha_grads else None), np.stack(db), searches


def expected_searches(s, q) -> int:
    """One per distinct value of each warp's columns, one more for each of
    them that is a value of s but not its last (sorted rows)."""
    return sum(len(vals) + int((np.isin(vals, s) & (vals != s[-1])).sum())
               for vals in (np.unique(q[cols]) for cols in warp_columns(len(q)) if cols))


def complements(arrays):
    alpha, beta, g = arrays[:3]
    a, b, x = chip_smoke.complements(*(torch.from_numpy(np.ascontiguousarray(t))
                                       for t in (alpha, beta, g)))
    return a.numpy(), b.numpy(), x.numpy()


def golden_rows(rows: int = 4):
    """The gated SOT-2048 golden's first real rows (kernel 8's JAX rows)."""
    with np.load(chip_smoke.GOLDEN_GATED) as z:
        return complements((z["sot_alpha"][:rows], z["sot_beta"][:rows], z["sot_gaug"]))


def cases():
    rng = np.random.default_rng(0)
    out = {
        "random m=257": (complements(chip_smoke.random_plane_rows(rng, 3, 258)), False),
        "random m=1025": (complements(chip_smoke.random_plane_rows(rng, 2, 1026)), False),
        "dyadic m=40": (complements(chip_smoke.dyadic_plane_rows(rng, 6, 41)), True),
        "dyadic m=1025": (complements(chip_smoke.dyadic_plane_rows(rng, 3, 1026)), True),
        "gated golden m=1025": (golden_rows(), False),
        "m=1": (complements(chip_smoke.dyadic_plane_rows(rng, 4, 2)), True),
        "m=2": (complements(chip_smoke.dyadic_plane_rows(rng, 4, 3)), True),
        "m=8192": (complements(chip_smoke.dyadic_plane_rows(rng, 1, 8193)), True),
    }
    for kind in chip_smoke.GRAD_STRESS_KINDS:
        out[f"stress ({kind}) m=300"] = (chip_smoke.grad_stress_rows(kind, 4, 300), True)
    return out


CASES = cases()


@pytest.mark.parametrize("kind", list(CASES))
@pytest.mark.parametrize("alpha_grads", [True, False])
def test_grad_plan_matches_plain(kind, alpha_grads):
    (a, b, x), exact = CASES[kind]
    da, db, _ = grads_plan(a, b, x, alpha_grads)
    ref = kmerge.coupling_grads_plain(*(torch.from_numpy(t) for t in (a, b, x)), alpha_grads)
    assert (ref[0] is None) == (not alpha_grads)
    for got, r in ((da, ref[0]), (db, ref[1])):
        if r is None:
            continue
        r = r.numpy()
        if exact:
            assert np.array_equal(got.view(np.int32), r.view(np.int32))
        assert np.abs(got - r).max() <= chip_smoke.COUPLING_GRAD_LIMIT * np.abs(r).max()


@pytest.mark.parametrize("kind", list(CASES))
def test_grad_plan_searches_once_per_distinct_value_and_tie(kind):
    """Both sides' searches, and db's as chip_smoke counts them for the
    kernel's bound (``grad_plan_searches``)."""
    (a, b, x), _ = CASES[kind]
    _, _, searches = grads_plan(a, b, x, True)
    assert searches == sum(expected_searches(ar, br) + expected_searches(br, ar)
                           for ar, br in zip(a, b))
    _, _, db_searches = grads_plan(a, b, x, False)
    assert db_searches == chip_smoke.grad_plan_searches(torch.from_numpy(a), torch.from_numpy(b))


def test_grad_plan_shares_searches_on_real_rows():
    """On the gated golden's real rows most columns repeat the query before
    them (the zeros past the quantile cap): db takes far fewer searches than
    columns."""
    (a, b, x), _ = CASES["gated golden m=1025"]
    _, _, searches = grads_plan(a, b, x, False)
    assert searches < 0.5 * a.size


@pytest.mark.parametrize("side", ["a", "b", "both"])
def test_grad_plan_on_unsorted_rows(side):
    """Permuted complements: the side whose s is not sorted scans it whole;
    the other still searches (its queries may come in any order)."""
    rng = np.random.default_rng(7)
    a, b, x = complements(chip_smoke.random_plane_rows(rng, 3, 130))
    if side in ("a", "both"):
        a = rng.permuted(a, axis=-1)
    if side in ("b", "both"):
        b = rng.permuted(b, axis=-1)
    da, db, _ = grads_plan(a, b, x, True)
    ref = kmerge.coupling_grads_plain(*(torch.from_numpy(t) for t in (a, b, x)), True)
    for got, r in ((da, ref[0]), (db, ref[1])):
        r = r.numpy()
        assert np.abs(got - r).max() <= chip_smoke.COUPLING_GRAD_LIMIT * np.abs(r).max()


def test_warp_columns_cover_each_column_once():
    for m in (1, 31, 257, 1025, 8192):
        cols = [c for w in warp_columns(m) for c in w]
        assert sorted(cols) == list(range(m))

