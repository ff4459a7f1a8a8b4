"""Kernels 4 and 5's rank plans (``sot_tpu_torch/csrc/merge.cu``'s coupling
value and ``sot_tpu_torch/csrc/refgrad.cu``), transcribed in numpy and held
against the plain versions and JAX's rank form.

  * Kernel 4 (nonincreasing complements a, b): a group of ``tpr`` threads
    cuts the merge path of the two rows (a's element first where it is
    above b's, b's first on a tie) into slices of L = ceil(2 m / tpr)
    positions; thread r finds its first position by one co-rank binary
    search and takes one element a step. Taking a_k after q elements of b
    adds x_k a_k PX[q], taking b_l after p of a adds x_l b_l PX[p], in
    float64; PX is the chunk-summed, warp-scanned float64 prefix of x. The
    terms are added in path order per thread, the lanes by a shfl_down tree,
    the warps in order. A row that is not nonincreasing on either side is
    summed over all pairs.
  * Kernel 5 (nondecreasing alpha): a column whose flags vne_j and
    vne_{j+1} are both 0 gets a zero; on the others a binary search of
    alpha gives R_lt and, on a tie, a second one past it R_le; only the t of
    each flag that is 1 is computed, and without a tie and with q != 0 both
    inner sums are F_hi itself. Every operation is a numpy float32 one: one
    rounding each, no FMA.

Tolerances: the ranks equal ``torch.searchsorted`` (left and right); kernel
5 equal (``torch.equal``: under ==) to ``ref_grad_beta_plain`` and JAX's
``ref_grad_beta_xla``, and bit for bit wherever the result is not a zero;
kernel 4 within 1e-12 relative of a float64 ``coupling_plain`` (both sum
exact float64 products of f32 values, in other orders), equal after f32
rounding on ``chip_smoke.dyadic_plane_rows`` (every sum exact), and within
chip_smoke's COUPLING_LIMIT per row on unsorted rows.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

import chip_smoke
from sot_tpu_torch.ops.kernels import merge as kmerge
from sot_tpu_torch.ops.kernels import refgrad as krefgrad

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from sot_tpu.ops.pallas.refgrad import ref_grad_beta_xla  # noqa: E402

F32 = np.float32
GOLDEN_512 = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "sot_tpu_torch", "golden", "sot512_seed42_trainstep.npz")
TPRS = [kmerge.THREADS_PER_ROW, 5]


def corank(va, vb, k: int, before) -> int:
    """rows.cuh:corank: the largest p in [max(0, k - nb), min(k, na)] with
    before(va[p - 1], vb[k - p])."""
    lo, hi = max(0, k - len(vb)), min(k, len(va))
    while lo < hi:
        mid = (lo + hi + 1) >> 1
        if before(va[mid - 1], vb[k - mid]):
            lo = mid
        else:
            hi = mid - 1
    return lo


def a_first(u, w) -> bool:
    return u > w


def walk(a, b, tpr: int):
    """merge.cu's slices of the merge path of a and b: a list per thread of
    (side, p, q), side 0 for a's element p and 1 for b's element q, with p
    and q the elements of a and b taken before the step."""
    m = len(a)
    npos = 2 * m
    length = -(-npos // tpr)
    threads = []
    for r in range(tpr):
        k0, k1 = min(r * length, npos), min(r * length + length, npos)
        steps = []
        if k0 < k1:
            p = corank(a, b, k0, a_first)
            q = k0 - p
            for _ in range(k0, k1):
                ta = q == m or (p < m and a[p] > b[q])
                steps.append((0 if ta else 1, p, q))
                p, q = p + ta, q + (not ta)
        threads.append(steps)
    return threads


def chunk_prefix(x, tpr: int) -> np.ndarray:
    """merge.cu's PX [m + 1] in float64: each thread's contiguous chunk summed
    in order, a shfl_up tree in each warp of 32, the earlier warps' totals
    in order, then each chunk's running sum."""
    m = len(x)
    chunk = -(-m // tpr)
    bounds = [(min(t * chunk, m), min(t * chunk + chunk, m)) for t in range(tpr)]
    sx = []
    for e0, e1 in bounds:
        s = 0.0
        for e in range(e0, e1):
            s += float(x[e])
        sx.append(s)
    px = np.zeros(m + 1)
    xbefore = 0.0
    for w0 in range(0, tpr, 32):
        lanes = min(32, tpr - w0)
        incl = sx[w0:w0 + lanes]
        d = 1
        while d < 32:
            incl = [incl[l] + incl[l - d] if l >= d else incl[l] for l in range(lanes)]
            d <<= 1
        for l in range(lanes):
            e0, e1 = bounds[w0 + l]
            run = xbefore + (incl[l] - sx[w0 + l])
            for e in range(e0, e1):
                px[e] = run
                run += float(x[e])
            if e0 < e1 and e1 == m:
                px[m] = run
        xbefore += incl[-1]
    return px


def lane_tree(v):
    """The shfl_down tree over 32 lanes: lane 0's sum."""
    v = list(v) + [0.0] * (32 - len(v))
    off = 16
    while off:
        v = [v[l] + (v[l + off] if l + off < 32 else v[l]) for l in range(32)]
        off >>= 1
    return v[0]


def coupling_row(a, b, x, tpr: int) -> float:
    """merge.cu's coupling value on one row, in float64 before the final
    rounding."""
    m = len(a)
    accs = [0.0] * tpr
    if np.all(a[1:] <= a[:-1]) and np.all(b[1:] <= b[:-1]):
        px = chunk_prefix(x, tpr)
        for r, steps in enumerate(walk(a, b, tpr)):
            for side, p, q in steps:
                if side == 0:
                    accs[r] += float(x[p]) * float(a[p]) * px[q]
                else:
                    accs[r] += float(x[q]) * float(b[q]) * px[p]
    else:
        for k in range(m):
            inner = 0.0
            for ll in range(m):
                inner += float(x[ll]) * float(min(a[k], b[ll]))
            accs[k % tpr] += float(x[k]) * inner
    warps = [lane_tree(accs[w0:w0 + 32]) for w0 in range(0, tpr, 32)]
    total = warps[0]
    for s in warps[1:]:
        total += s
    return total


def coupling_walk(a, b, x, tpr: int) -> np.ndarray:
    a, b, x = (np.asarray(v, F32) for v in (a, b, x))
    return np.array([coupling_row(ar, br, x, tpr) for ar, br in zip(a, b)])


# ---------------------------------------------------------------------------
# kernel 5

def ranks(al, q):
    """refgrad.cu's searches for one query: R_lt by a binary search of alpha,
    R_le past it on a tie."""
    n = len(al)
    lo, hi = 0, n
    while lo < hi:
        mid = (lo + hi) >> 1
        if al[mid] < q:
            lo = mid + 1
        else:
            hi = mid
    r_lt = lo
    if lo < n and al[lo] == q:
        hi = n
        while lo < hi:
            mid = (lo + hi) >> 1
            if al[mid] <= q:
                lo = mid + 1
            else:
                hi = mid
    return r_lt, lo


def payload(al, g, i):
    """refgrad.cu:payload (0 past the end)."""
    if i >= len(al):
        return F32(0), F32(0), F32(0)
    prev = al[i - 1] if i > 0 else F32(0)
    ne = F32(1) if al[i] > prev else F32(0)
    return ne, ne * g[i], ne * (g[i] * g[i])


def combine(q2, q1, q0, G):
    return (q2 - (F32(2) * G) * q1) + (G * G) * q0


def refgrad_row(al, be, g, w):
    """refgrad.cu on one row, column by column."""
    al, be, g, w = (np.asarray(v, F32) for v in (al, be, g, w))
    n = len(al)
    first = payload(al, g, 0)
    out = np.zeros(n, F32)
    for j in range(n):
        q = be[j]
        vne = q > (be[j - 1] if j > 0 else F32(0))
        vne_next = j + 1 < n and be[j + 1] > q
        if not vne and not vne_next:
            continue
        r_lt, r_le = ranks(al, q)
        tie = F32(1) if r_le > r_lt else F32(0)
        q_zero = F32(1) if q == 0 else F32(0)
        fh = payload(al, g, r_lt)
        t1 = t2 = F32(0)
        if r_le == r_lt and q != 0:
            if vne:
                t1 = combine(fh[2], fh[1], fh[0], g[j])
            if vne_next:
                t2 = combine(fh[2], fh[1], fh[0], g[j + 1])
        else:
            if vne:
                keep = F32(1) - F32(0.5) * tie
                i1 = [fh[c] * keep - q_zero * first[c] for c in range(3)]
                t1 = combine(i1[2], i1[1], i1[0], g[j])
            if vne_next:
                fl = fh if r_le == r_lt else payload(al, g, r_le)
                i2 = [F32(0.5) * ((fh[c] + fl[c]) - q_zero * first[c]) - (F32(0.5) * fh[c]) * tie
                      for c in range(3)]
                t2 = combine(i2[2], i2[1], i2[0], g[j + 1])
        d = (t1 - t2 if vne_next else t1) if vne else -t2
        out[j] = w * d
    return out


def refgrad_kernel(alpha, beta, g, wbar) -> np.ndarray:
    return np.stack([refgrad_row(a, b, g, w) for a, b, w in zip(alpha, beta, wbar)])


# ---------------------------------------------------------------------------
# rows

def real_rows(rows: int = 6):
    """The SOT-512 golden's first real rows at n = 258."""
    with np.load(GOLDEN_512) as z:
        a, b, g = (z[k][:rows] if k != "sot_gaug" else z[k]
                   for k in ("sot_alpha", "sot_beta", "sot_gaug"))
    return a, b, g, (np.random.default_rng(1).random(len(a)) + 0.5).astype(F32)


def cases():
    rng = np.random.default_rng(0)
    out = {kind: chip_smoke.edge_sot_rows(kind) for kind in chip_smoke.EDGE_KINDS}
    for n in (7, 33, 64):
        out[f"random n={n}"] = chip_smoke.random_plane_rows(rng, 6, n)
        out[f"dyadic n={n}"] = chip_smoke.dyadic_plane_rows(rng, 6, n)
    out["random n=258"] = chip_smoke.random_plane_rows(rng, 3, 258)
    out["SOT-512 golden n=258"] = real_rows()
    out["stress n=40"] = chip_smoke.stress_plane_rows(4, 40)
    return out


CASES = cases()


def as_torch(*arrays):
    return [torch.tensor(np.asarray(a)) for a in arrays]


# ---------------------------------------------------------------------------
# kernel 5

@pytest.mark.parametrize("kind", list(CASES))
def test_ranks_equal_searchsorted(kind):
    alpha, beta, _, _ = CASES[kind]
    for al, be in zip(alpha, beta):
        got = np.array([ranks(al, q) for q in be])
        ta, tb = as_torch(al, be)
        assert np.array_equal(got[:, 0], torch.searchsorted(ta, tb, right=False).numpy())
        assert np.array_equal(got[:, 1], torch.searchsorted(ta, tb, right=True).numpy())


@pytest.mark.parametrize("kind", list(CASES))
def test_refgrad_plan_equal_to_plain_and_jax(kind):
    """Equal under == to both, bit for bit wherever the result is not a
    zero (a zero column's sign is not reproduced)."""
    alpha, beta, g, wbar = CASES[kind]
    got = torch.from_numpy(refgrad_kernel(alpha, beta, g, wbar))
    plain = krefgrad.ref_grad_beta_plain(*as_torch(alpha, beta, g, wbar))
    xla = torch.tensor(np.asarray(ref_grad_beta_xla(*(jnp.asarray(v)
                                                      for v in (alpha, beta, g, wbar)))))
    assert torch.equal(got, plain) and torch.equal(got, xla)
    nonzero = plain != 0
    assert torch.equal(got.view(torch.int32)[nonzero], plain.view(torch.int32)[nonzero])


def test_refgrad_plan_on_unsorted_beta():
    """beta in any order: each query searched on its own."""
    rng = np.random.default_rng(4)
    alpha, beta, g, wbar = CASES["random n=64"]
    beta = rng.permuted(beta, axis=-1)
    got = torch.from_numpy(refgrad_kernel(alpha, beta, g, wbar))
    assert torch.equal(got, krefgrad.ref_grad_beta_plain(*as_torch(alpha, beta, g, wbar)))


def test_refgrad_inner_sums_without_a_tie_are_the_payload():
    """Without a tie and with q != 0, inner1 = fh (1 - 0.5 * 0) - 0 * p0 and
    inner2 = 0.5 (fh + fh - 0 * p0) - 0.5 fh * 0 are fh itself, to the last
    bit wherever they are not zeros, so comb of either is comb(fh)."""
    rng = np.random.default_rng(5)
    fh = (rng.standard_normal((1000, 3))
          * 10.0 ** rng.integers(-30, 30, (1000, 3))).astype(F32)
    fh[::7] = 0
    first = np.abs(rng.standard_normal((1000, 3))).astype(F32)
    G = rng.random(1000).astype(F32)
    tie, q_zero = F32(0), F32(0)
    keep = F32(1) - F32(0.5) * tie
    i1 = fh * keep - q_zero * first
    i2 = F32(0.5) * ((fh + fh) - q_zero * first) - (F32(0.5) * fh) * tie
    direct = combine(fh[:, 2], fh[:, 1], fh[:, 0], G)
    for inner in (i1, i2):
        assert np.array_equal(inner, fh)
        assert np.array_equal(combine(inner[:, 2], inner[:, 1], inner[:, 0], G), direct)


def test_refgrad_zero_columns_are_the_flagless_ones():
    """The columns the kernel gives a zero are zeros of the plain version."""
    for kind in ("SOT-512 golden n=258", "cap plateau", "random n=258"):
        alpha, beta, g, wbar = as_torch(*CASES[kind])
        flagged = chip_smoke.closed_form_columns(beta)
        plain = krefgrad.ref_grad_beta_plain(alpha, beta, g, wbar)
        assert bool((plain[~flagged] == 0).all())


# ---------------------------------------------------------------------------
# kernel 4

def coupling_inputs(kind):
    alpha, beta, g, _ = CASES[kind]
    return (v.numpy() for v in chip_smoke.complements(*as_torch(alpha, beta, g)))


COUPLING_CASES = [k for k in CASES if k != "n=1"]  # the coupling needs m >= 1


@pytest.mark.parametrize("tpr", TPRS)
@pytest.mark.parametrize("kind", COUPLING_CASES)
def test_coupling_plan_matches_float64_plain(kind, tpr):
    a, b, x = coupling_inputs(kind)
    got = coupling_walk(a, b, x, tpr)
    ref = kmerge.coupling_plain(*(torch.from_numpy(v).double() for v in (a, b, x))).numpy()
    scale = np.maximum(np.abs(ref), 1e-300)
    assert np.all(np.abs(got - ref) <= 1e-12 * scale + 1e-300), np.max(np.abs(got - ref) / scale)


@pytest.mark.parametrize("n", [7, 33, 64])
def test_coupling_plan_equal_after_rounding_on_dyadic_rows(n):
    a, b, x = coupling_inputs(f"dyadic n={n}")
    got = coupling_walk(a, b, x, kmerge.THREADS_PER_ROW).astype(F32)
    ref = kmerge.coupling_plain(*(torch.from_numpy(v) for v in (a, b, x))).numpy()
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("side", ["a", "b", "both"])
def test_coupling_plan_on_unsorted_rows(side):
    """Permuted complements of sorted rows (>= 0, as the coupling takes
    them): the all-pairs sum."""
    rng = np.random.default_rng(7)
    a, b, x = coupling_inputs("random n=33")
    if side in ("a", "both"):
        a = rng.permuted(a, axis=-1)
    if side in ("b", "both"):
        b = rng.permuted(b, axis=-1)
    assert kmerge.unsorted_rows(torch.from_numpy(a), torch.from_numpy(b)).all()
    got = coupling_walk(a, b, x, kmerge.THREADS_PER_ROW)
    ref = kmerge.coupling_plain(*(torch.from_numpy(v) for v in (a, b, x))).double().numpy()
    assert np.all(np.abs(got - ref) <= chip_smoke.COUPLING_LIMIT * np.abs(ref))


@pytest.mark.parametrize("tpr", TPRS)
def test_coupling_walk_takes_every_element_once_at_its_counts(tpr):
    """Every element of a and of b is taken once; a_k after #{l : b_l >=
    a_k} elements of b, b_l after #{k : a_k > b_l} of a; the slices hold at
    most ceil(2 m / tpr) positions."""
    for kind in ("random n=258", "beta = alpha", "cap plateau", "n=2"):
        a, b, _ = coupling_inputs(kind)
        for ar, br in zip(a, b):
            m = len(ar)
            threads = walk(ar, br, tpr)
            taken = sorted((s, p if s == 0 else q) for steps in threads for s, p, q in steps)
            assert taken == [(0, k) for k in range(m)] + [(1, k) for k in range(m)]
            assert max(len(s) for s in threads) == -(-2 * m // tpr)
            ta, tb = as_torch(-ar, -br)  # ascending for searchsorted
            at_a = torch.searchsorted(tb, ta, right=True).numpy()    # #{b >= a_k}
            at_b = torch.searchsorted(ta, tb, right=False).numpy()   # #{a > b_l}
            for steps in threads:
                for s, p, q in steps:
                    assert (q == at_a[p]) if s == 0 else (p == at_b[q])


def test_corank_is_the_sequential_merge():
    """The co-rank of every position equals the a count of a sequential merge
    with the same tie rule, duplicates included."""
    rng = np.random.default_rng(3)
    for _ in range(20):
        a = np.sort(rng.integers(0, 6, rng.integers(1, 12)))[::-1].astype(F32)
        b = np.sort(rng.integers(0, 6, len(a)))[::-1].astype(F32)
        p = q = 0
        for k in range(2 * len(a) + 1):
            assert corank(a, b, k, a_first) == p
            if k < 2 * len(a):
                ta = q == len(b) or (p < len(a) and a[p] > b[q])
                p, q = p + ta, q + (not ta)


def test_unsorted_rows_flags_only_unsorted_or_nan_rows():
    a, b, _ = as_torch(*coupling_inputs("random n=33"))
    assert not kmerge.unsorted_rows(a, b).any()
    a[2, 7], b[4, 0] = a[2, 6] + 0.5, float("nan")
    assert kmerge.unsorted_rows(a, b).tolist() == [False, False, True, False, True, False]
