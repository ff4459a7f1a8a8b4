"""The CQT kernel's host-side tile plan (``sot_tpu_torch.ops.kernels.cqt``):
the column permutation, each tile's K range against the real bank's
non-zero entries, the work units, the TF32 split, and a plain emulation of
the tiled sum against ``cqt_project_plain``.

Tolerances: the emulation sums the same products as the plain version over
fewer (all-zero-free) taps in another order, f32: within 1e-6 of the max.
The TF32 split reconstructs each entry to 2^-21 relative (hi keeps 11
significant bits, lo the next 11).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from sot_tpu_torch.ops.cqt import cqt_bank
from sot_tpu_torch.ops.kernels import cqt as kcqt

N_OUT = 570


@pytest.fixture(scope="module")
def bank():
    return cqt_bank(16000, 32.7, 285, 36, 1.0, torch.device("cpu"))


@pytest.fixture(scope="module")
def plan(bank):
    return kcqt.tile_plan(bank, N_OUT)


def test_plan_covers_every_nonzero_and_permutes_all_columns(bank, plan):
    b = bank.numpy()
    flat = plan.perm.ravel()
    assert sorted(flat[flat >= 0].tolist()) == list(range(N_OUT))  # a bijection
    assert plan.n_tiles == 9 and plan.perm.shape == (9, kcqt.BN)
    rows = np.arange(b.shape[0])
    for j in range(plan.n_tiles):
        cols = plan.perm[j][plan.perm[j] >= 0]
        # re and im of one bin share the tile, 32 bins in frequency order
        re = cols[cols < 285]
        assert np.array_equal(np.sort(cols[cols >= 285]) - 285, re)
        assert np.array_equal(re, np.arange(32 * j, min(32 * j + 32, 285)))
        nz_rows = rows[(b[:, cols] != 0).any(axis=1)]
        assert plan.k_lo[j] <= nz_rows.min() and nz_rows.max() < plan.k_hi[j]
        assert plan.k_lo[j] % kcqt.BK == 0 and plan.k_hi[j] % kcqt.BK == 0
        # rounded out by less than one K step on each side
        assert nz_rows.min() - plan.k_lo[j] < kcqt.BK
        assert plan.k_hi[j] - 1 - nz_rows.max() < kcqt.BK
        # the packed rows are the bank's, zeros where a tile column is empty
        packed = plan.packed[plan.offset[j]:plan.offset[j] + plan.k_hi[j] - plan.k_lo[j]]
        valid = plan.perm[j] >= 0
        np.testing.assert_array_equal(packed[:, valid].numpy(),
                                      b[plan.k_lo[j]:plan.k_hi[j], plan.perm[j][valid]])
        assert not packed[:, ~valid].any()
    pos = plan.col_of_out()
    np.testing.assert_array_equal(flat[pos], np.arange(N_OUT))


def test_plan_flops_are_near_the_nonzero_count(bank, plan):
    nnz = int(torch.count_nonzero(bank[:, :N_OUT]))
    ratio = plan.flops(1024) / (2.0 * 1024 * nnz)
    assert 1.0 <= ratio <= 1.5
    dense = 2.0 * 1024 * bank.shape[0] * N_OUT
    assert plan.flops(1024) < dense / 5


@pytest.mark.parametrize("m_rows", [16, 48, 1024, 1040])
def test_work_units_cover_each_tile_range_once(plan, m_rows):
    units, spans = plan.units(m_rows)
    row_tiles = -(-m_rows // kcqt.BM)
    assert spans.shape == (row_tiles * plan.n_tiles, 2)
    chunk = plan.chunk(m_rows)
    assert chunk in kcqt.CHUNKS
    for rt in range(row_tiles):
        for j in range(plan.n_tiles):
            first, count = spans[rt * plan.n_tiles + j]
            mine = units[first:first + count]
            assert (mine[:, 0] == rt * kcqt.BM).all()
            taps = np.concatenate([np.arange(k0, k0 + steps * kcqt.BK)
                                   for _, k0, steps, _ in mine]) if count else np.zeros(0)
            np.testing.assert_array_equal(taps, np.arange(plan.k_lo[j], plan.k_hi[j]))
            assert (mine[:, 2] * kcqt.BK <= chunk).all()
            np.testing.assert_array_equal(mine[:, 3],
                                          plan.offset[j] + mine[:, 1] - plan.k_lo[j])
    assert spans[:, 1].sum() == len(units)
    # serving's 1024 rows fill one wave of resident blocks; a single clip
    # takes the shortest chunk
    if m_rows == 1024:
        assert len(units) <= kcqt.SLOTS
    if m_rows == 16:
        assert chunk == min(kcqt.CHUNKS)


def test_tf32_split_reconstructs_the_bank(plan):
    p = plan.packed
    hi, lo = kcqt.tf32_split(p)
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1FFF).any()  # 10 explicit mantissa bits
    rel = ((hi + lo - p).abs() / p.abs().clamp(min=1e-30))[p != 0]
    assert float(rel.max()) <= 2.0 ** -21
    assert float((hi - p).abs().max()) <= 2.0 ** -11 * float(p.abs().max())


def test_tf32_round_is_nearest_with_ties_away_from_zero():
    one = 1.0
    ulp = 2.0 ** -10  # TF32's unit in the last place at 1.0
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - 2 ** -20,
                      one + 3 * ulp / 2, 3.0, 0.0], dtype=torch.float32)
    want = torch.tensor([one + ulp, -(one + ulp), one, one + 2 * ulp, 3.0, 0.0])
    assert torch.equal(kcqt.tf32_round(x), want)


def test_tiled_sum_equals_plain_projection(bank, plan):
    """The kernel's sum written out in torch: per column tile over its
    [k_lo, k_hi) only, from the packed bank (and from its hi + lo parts),
    then un-permuted."""
    x = np.random.default_rng(0).uniform(-0.9, 0.9, (2, 4095)).astype(np.float32)
    width = bank.shape[0]
    xpad = torch.nn.functional.pad(torch.from_numpy(x), (width // 2, width // 2))
    frames = xpad.unfold(1, width, 256)[:, :16]
    hi, lo = kcqt.tf32_split(plan.packed)
    exact = torch.zeros(2, 16, plan.n_tiles * kcqt.BN)
    split = torch.zeros_like(exact)
    for j in range(plan.n_tiles):
        k_lo, k_hi, off = int(plan.k_lo[j]), int(plan.k_hi[j]), int(plan.offset[j])
        f = frames[..., k_lo:k_hi]
        cols = slice(j * kcqt.BN, (j + 1) * kcqt.BN)
        exact[..., cols] = f @ plan.packed[off:off + k_hi - k_lo]
        split[..., cols] = f @ hi[off:off + k_hi - k_lo] + f @ lo[off:off + k_hi - k_lo]
    pos = torch.from_numpy(plan.col_of_out()).long()
    ref = kcqt.cqt_project_plain(xpad, bank, 256, 16, N_OUT)
    scale = float(ref.abs().max())
    for got in (exact[..., pos], split[..., pos]):
        assert got.shape == ref.shape == (2, 16, N_OUT)
        assert float((got - ref).abs().max()) <= 1e-6 * scale
