"""The unsupervised pitch corrections (``sot_tpu_torch/metrics.py``'s
``octave_correct_pitch`` and ``comb_correct_pitch``, with the trainer's
``apply_*_correction``) against the JAX package's, live on the CPU (both
are plain array code; no Pallas kernel is involved).

Inputs: the predict golden's 64 clips with the SOT-2048-42 checkpoint's
pitches (``sot_tpu_torch/golden/sot2048_seed42_eval.npz``) and the same
pitches times 0.5, 2, 2/3 and 1.5, so that every branch of both rules
fires; a 16-frame pitch track whose two middle values differ (``jnp.median``
takes their midpoint, ``torch.median`` the lower one); pitches whose band
index falls exactly half-way between two bins (``jnp.round`` and
``torch.round`` both round half to even).

Tolerances: the clip factors equal on every clip (a clip that flips is
named, never dropped); the quantities each decision compares (the median
pitch, the spectral peak, the band peaks, the comb scores) within
chip_smoke's DECISION_REL (1e-5) of their max: the two STFTs sum in other
orders.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import chip_smoke  # noqa: E402
from sot_tpu_torch import metrics as tmetrics  # noqa: E402
from sot_tpu_torch.configs import get_experiment  # noqa: E402
from sot_tpu_torch.training import trainer as ttrainer  # noqa: E402
from tests import _torch_golden_eval2048 as golden  # noqa: E402

CFG = get_experiment("SOT-2048")
G = chip_smoke.eval_golden()


def kwargs(kind):
    kw = golden.correction_kwargs(CFG)
    return dict(kw, margin=CFG.comb_correction_margin) if kind == "comb" else kw


def port(kind, x, p):
    fn = tmetrics.octave_factors if kind == "octave" else tmetrics.comb_factors
    factor, quantities = fn(torch.from_numpy(x), torch.from_numpy(p), **kwargs(kind))
    return factor.numpy(), {k: v.numpy() for k, v in quantities.items()}


def assert_same_decisions(what, got, ref):
    (factor, quantities), (ref_factor, ref_quantities) = got, ref
    flips = [f"clip {i}: port x{factor[i]} JAX x{ref_factor[i]}"
             for i in np.flatnonzero(factor != ref_factor)]
    assert not flips, f"{what}: factors flip on " + "; ".join(flips)
    assert set(quantities) == set(ref_quantities)
    for k, v in ref_quantities.items():
        err = np.abs(quantities[k] - v).max() / max(np.abs(v).max(), 1e-30)
        assert err <= chip_smoke.DECISION_REL, f"{what}: {k} differs by {err:.3e} of its max"


@pytest.mark.parametrize("kind", ["octave", "comb"])
@pytest.mark.parametrize("shift", list(golden.SHIFTS))
def test_corrections_match_jax(kind, shift):
    """Live against JAX's own function (its factor) and its steps written
    out (``_torch_golden_eval2048.decisions``: the decision quantities)."""
    p = golden.shifted(G["pitch_hz"], golden.SHIFTS[shift])
    ref = golden.decisions(kind, G["x"], p, **kwargs(kind))
    assert np.array_equal(ref[0], golden.applied_factor(kind, G["x"], p, **kwargs(kind)))
    assert_same_decisions(f"{kind} x{shift}", port(kind, G["x"], p), ref)


@pytest.mark.parametrize("kind", ["octave", "comb"])
def test_correct_pitch_applies_the_clip_factor(kind):
    """The public functions and the trainer's entries scale every frame by
    the clip's factor and map the result to pitch units."""
    x, p = (torch.from_numpy(v) for v in (G["x"], golden.shifted(G["pitch_hz"], 0.5)))
    factor, _ = port(kind, G["x"], p.numpy())
    fn = tmetrics.octave_correct_pitch if kind == "octave" else tmetrics.comb_correct_pitch
    got = fn(x, p, **kwargs(kind))
    assert torch.equal(got, p * torch.from_numpy(factor)[:, None, None])
    mod = ttrainer.build_modules(CFG, device="cpu")
    apply = (ttrainer.apply_octave_correction if kind == "octave"
             else ttrainer.apply_comb_correction)
    hz, unit = apply(mod, x, p)
    assert torch.equal(hz, got)
    np.testing.assert_allclose(unit.numpy(), ttrainer.hz_to_unit(
        got, mod.freq_hz_min, mod.freq_hz_max).numpy())


def median_tie_pitches():
    """Per clip, 8 frames at the model's pitch and 8 at 1.6 times it, in
    shuffled order: the median is their midpoint, 1.3 times it."""
    rng = np.random.default_rng(4)
    base = G["pitch_hz"][:, :1, :]
    frames = np.concatenate([np.repeat(base, 8, 1), np.repeat(base * np.float32(1.6), 8, 1)], 1)
    return rng.permuted(frames, axis=1).astype(np.float32)


def test_median_of_16_frames_is_the_midpoint():
    p = median_tie_pitches()
    got = tmetrics._median_frames(torch.from_numpy(p)).numpy()
    ref = np.asarray(jax.numpy.median(jax.numpy.asarray(p[:, :, 0]), axis=1))
    assert np.array_equal(got, ref)
    assert not np.array_equal(got, torch.median(torch.from_numpy(p[:, :, 0]), 1).values.numpy())


@pytest.mark.parametrize("kind", ["octave", "comb"])
def test_corrections_on_median_ties_match_jax(kind):
    p = median_tie_pitches()
    assert_same_decisions(f"{kind} median ties", port(kind, G["x"], p),
                          golden.decisions(kind, G["x"], p, **kwargs(kind)))


@pytest.mark.parametrize("kind", ["octave", "comb"])
def test_corrections_on_half_bin_pitches_match_jax(kind):
    """Constant pitch tracks at (k + 1/2) bins, k even and odd, over the
    model's range: every band index is a rounding tie."""
    df = CFG.sample_rate / 2048
    k = np.arange(5, 5 + 64 * 7, 7)  # alternating parity
    p = np.repeat(((k + 0.5) * df).astype(np.float32)[:, None, None], 16, 1)
    assert_same_decisions(f"{kind} half-bin pitches", port(kind, G["x"], p),
                          golden.decisions(kind, G["x"], p, **kwargs(kind)))
