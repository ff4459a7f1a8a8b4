"""The served outputs against the reference on the CPU, and the serving
control.

* Served outputs at the serving cell's full shapes (64 clips of 4096
  samples, published widths) over thirteen seeds, 63543500 among them:
  each number compared beside its limit.
* The control (the reference in the next lower precision, put in the
  program's place) comes out not correct.
* On the card (``-m cuda``): the served x_hat against the program's own
  float64-phase plain synth at seed 63543500.

The training checks are in ``test_portbench_training.py``, the faults in
``test_portbench_faults.py``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import check, inputs, program, spec
from portbench.adapters import pesto_sot as adapter
from portbench.compare import pesto_sot as compare
from portbench.reference import pesto_sot as ref_model
from portbench.tests.conftest import small_cell

SERVE_SEEDS = [63543500, 1, 7, 42, 123, 456, 789, 2024, 31337, 65535, 999983, 2147483647,
               4294967311]


def _serve_readings(cell, seed, device, lower=False):
    cfg = cell.config
    weights = inputs.weights(ref_model, cfg, seed, device)
    x = inputs.clips(cfg, cell.traffic["request_clips"], seed, "serve", device)
    clips = [x.cpu().numpy()]
    if lower:
        model = ref_model.Model(cfg, device, ref_model.Precision(lower=True))
        with torch.no_grad(), model.precision.active(device):
            served = [{k: (v if k == "x_hat" else v.cpu().numpy())
                       for k, v in model.forward(weights, x).items()}]
    else:
        prog = adapter.Program(cfg, weights, device)
        out = prog.predict(clips[0])
        served = [{k: (v if k == "x_hat" else v.cpu().numpy()) for k, v in out.items()}]
    return compare.serve_readings(cfg, device, weights, clips, served)


@pytest.mark.parametrize("seed", SERVE_SEEDS)
def test_served_outputs_match_the_reference(seed, record_property):
    cell = spec.Cell("sot2048-serve")
    readings = _serve_readings(cell, seed, torch.device("cpu"))
    for k, limit in cell.limits.items():
        record_property(k, f"{readings[k]!r} limit {limit!r}")
    print({k: (readings[k], limit) for k, limit in cell.limits.items()})
    assert check.verdict(readings, cell.limits), readings


def test_the_serving_control_is_not_correct():
    cell = small_cell("sot2048-serve")
    cell.traffic = dict(cell.traffic, request_clips=4)
    readings = _serve_readings(cell, 3, torch.device("cpu"), lower=True)
    assert not check.verdict(readings, cell.limits), readings
    assert readings["xhat_rel"] > cell.limits["xhat_rel"]



@pytest.mark.cuda
def test_card_xhat_is_the_plain_synth_of_its_controls(card):
    """The served x_hat on the card against the program's own plain synth
    (float64 phase) and the reference synth, on the served controls, at
    seed 63543500."""
    from sot_tpu_torch.ops.kernels.synth import synth_render_plain

    cell = spec.Cell("sot2048-serve")
    cfg = cell.config
    program.set_policy()
    weights = inputs.weights(ref_model, cfg, 63543500, card)
    x = inputs.clips(cfg, 64, 63543500, "serve", card)
    prog = adapter.Program(cfg, weights, card)
    out = prog.predict(x.cpu().numpy())
    controls = prog.mod.decoder.get_controls(out["weights"], out["pitch_hz"])
    plain = synth_render_plain(controls["amplitudes"], controls["frequencies"],
                               cfg["n_samples"], cfg["sample_rate"])
    assert check.max_gap(out["x_hat"], plain) < 1e-6
    readings = compare.serve_readings(cfg, card, weights, [x.cpu().numpy()],
                                    [{k: (v if k == "x_hat" else v.cpu().numpy())
                                      for k, v in out.items()}])
    assert check.verdict(readings, cell.limits), readings
    assert np.isfinite(readings["xhat_rel"])
