"""The port's ``evaluate`` with the SOT-2048-42 weights on the predict
golden's 64 clips, on the CPU, in the three forms that ``sot_tpu/cli.py``'s
``--final-eval`` writes (plain, ``eval_octave_correction``,
``eval_comb_correction``), against the JAX package's ``evaluate`` stored in
``sot_tpu_torch/golden/sot2048_seed42_eval.npz``
(``tests/_torch_golden_eval2048.py``); both corrections' clip factors at
every pitch shift of the golden; ``predict`` with
``inference_comb_correction`` under ``auto`` and the gated preset (the
correction's STFT through kernel 9's plain version here). These are
``chip_smoke.py``'s [eval-2048] phases, run on the CPU.

Tolerances ([eval-512]'s): LSD, MSE, MSS and the loss terms within
EVAL_REL (1e-3) relative; the pitch accuracies and the octave difference
within one frame of the 1024; the factors equal on every clip and the
decision quantities within DECISION_REL (1e-5) of their max; predict's
corrected pitch within 1e-3 relative of JAX's.
"""

from __future__ import annotations

import pytest
import torch

import chip_smoke
from sot_tpu_torch.configs import get_experiment

CFG = get_experiment("SOT-2048")
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def g():
    return chip_smoke.eval_golden()


def test_the_phase_reads_what_the_generator_wrote(g):
    from tests import _torch_golden_eval2048 as golden

    assert chip_smoke.EVAL_FORMS == golden.FORMS
    assert chip_smoke.CORRECTION_SHIFTS == golden.SHIFTS
    assert {f"eval/{f}/loss/total" for f in golden.FORMS} <= set(g)


@pytest.mark.parametrize("form", list(chip_smoke.EVAL_FORMS))
def test_evaluate_matches_jax(g, form):
    chip_smoke.eval_2048_form(CFG, CPU, form, g)


@pytest.mark.parametrize("shift", list(chip_smoke.CORRECTION_SHIFTS))
def test_correction_factors_match_the_golden(g, shift):
    mod = chip_smoke.build_modules(CFG, device=CPU, kernels=chip_smoke.JAX_AUTO)
    chip_smoke.correction_factors_check(mod, g, shift)


@pytest.mark.parametrize("kernels", ["auto", "gated"])
def test_predict_with_the_comb_correction(g, kernels):
    chip_smoke.predict_comb_check(CFG, CPU, g, chip_smoke.GATED if kernels == "gated"
                                  else chip_smoke.JAX_AUTO)
