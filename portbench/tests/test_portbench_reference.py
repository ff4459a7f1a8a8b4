"""The reference against the program on the CPU, the control and the
faults.

* Served outputs at the serving cell's full shapes (64 clips of 4096
  samples, published widths) over thirteen seeds, 63543500 among them:
  each number compared beside its limit.
* Training at the train cells' widths with a batch of 4: a whole run
  comes out correct.
* The control (the reference in the next lower precision, put in the
  program's place) comes out not correct, in serving and in training, and
  so does every fault: the timed path broken underneath a whole run (a
  state left unchanged, half of the batch left out, the synth's output
  altered, the W2 value or its gradient over half of the rows).
* On the card (``-m cuda``): the served x_hat against the program's own
  float64-phase plain synth at seed 63543500.
"""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from portbench import check, inputs, load, program, run, spec
from portbench.reference import model as ref_model
from portbench.tests.conftest import SmallProgram, small_cell

SERVE_SEEDS = [63543500, 1, 7, 42, 123, 456, 789, 2024, 31337, 65535, 999983, 2147483647,
               4294967311]


def _serve_readings(cell, seed, device, lower=False):
    cfg = cell.config
    weights = inputs.weights(cfg, seed, device)
    x = inputs.clips(cfg, cell.traffic["request_clips"], seed, "serve", device)
    clips = [x.cpu().numpy()]
    if lower:
        model = ref_model.Model(cfg, device, ref_model.Precision(lower=True))
        with torch.no_grad(), model.precision.active(device):
            served = [{k: (v if k == "x_hat" else v.cpu().numpy())
                       for k, v in model.forward(weights, x).items()}]
    else:
        prog = program.Program(cfg, weights, device)
        out = prog.predict(clips[0])
        served = [{k: (v if k == "x_hat" else v.cpu().numpy()) for k, v in out.items()}]
    return check.serve_readings(cfg, device, weights, clips, served)


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


@pytest.mark.parametrize("workload, seed", [("sot2048-train", 3), ("sot2048-train", 4),
                                            ("msslin-train", 3), ("msslin-train", 4),
                                            ("msslin-train", 63543500)])
def test_the_training_control_is_not_correct(workload, seed):
    """The reference in the next lower precision in the program's place:
    its three updates read by the cell's comparison."""
    cell = small_cell(workload)
    cfg, dev = cell.config, torch.device("cpu")
    work = load.TrainEpoch(cell, seed, dev, SmallProgram)
    work.setup()
    work.release()
    batches = work.check_batches()
    ref = check.train_reference(cfg, dev, work.weights0, batches, work.dropout_seed)
    tf32 = check.first_update(cfg, dev, work.weights0, batches, work.dropout_seed, lower=True)
    ctl = check.train_reference(cfg, dev, work.weights0, batches, work.dropout_seed, lower=True)
    readings = check.train_compare(ref, tf32, work.weights0, ctl["losses"],
                                   ctl["first_grad"], ctl["params"])
    assert not check.verdict(readings, cell.limits), readings
    assert readings["tf32_share"] > cell.limits["tf32_share"]


@pytest.mark.parametrize("workload, seed", [("sot2048-train", 5), ("msslin-train", 6),
                                            ("msslin-train", 63543500)])
def test_training_matches_the_reference(workload, seed):
    cell = small_cell(workload)
    result = run.run_cell(cell, seed, 0.1, False, "cpu", SmallProgram, time.perf_counter())
    print(result["compared"])
    assert result["correct"], result["compared"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["sot2048-train", "msslin-train"])
def test_card_training_is_correct(workload, card):
    """A whole run of the cell at its full size on the card, a short window."""
    program.set_policy()
    result = run.run_cell(spec.Cell(workload), 2718281828, 1.0, False, "cuda", program.Program,
                          time.perf_counter())
    assert result["correct"], result["compared"]


# -- faults planted in the program, a whole run each --------------------------


class Unchanged(SmallProgram):
    """A step that returns its state unchanged."""

    def train(self, offsets):
        before = {k: v.detach().clone() for k, v in self.mod.encoder.state_dict().items()}
        logs = super().train(offsets)
        self.mod.encoder.load_state_dict(before)
        return logs


class HalfServed(SmallProgram):
    """Half of each request left out."""

    def predict(self, x):
        n = x.shape[0] // 2
        out = super().predict(x[:n])
        return {k: torch.cat([v, torch.zeros_like(v)]) for k, v in out.items()}


def _half_batch_loss(monkeypatch):
    from sot_tpu_torch.training import trainer

    inner = trainer.compute_loss
    monkeypatch.setattr(trainer, "compute_loss",
                        lambda mod, x, **kw: inner(mod, x[:x.shape[0] // 2], **kw))


def _altered_synth(monkeypatch):
    from sot_tpu_torch.models.synths import Sinusoidal

    inner = Sinusoidal.__call__

    def louder(self, amplitudes, frequencies):
        return inner(self, amplitudes, frequencies) * 1.01

    monkeypatch.setattr(Sinusoidal, "__call__", louder)


def _w2_half_rows(monkeypatch, part):
    """The program's W2 over half of its rows: the value (``part`` =
    "value") or the gradient ("grad") of the second half left out."""
    from sot_tpu_torch.ops import wasserstein

    inner = wasserstein.wasserstein_same_grid

    def faulty(*args, **kw):
        w = inner(*args, **kw)
        keep = torch.ones_like(w)
        keep[w.shape[0] // 2:] = 0.0
        if part == "value":
            return (w * keep).detach() + (w - w.detach())
        return w.detach() + (w * keep - (w * keep).detach())

    monkeypatch.setattr(wasserstein, "wasserstein_same_grid", faulty)


@pytest.mark.parametrize("workload, fault", [
    ("sot2048-train", "unchanged"), ("sot2048-train", "half_batch"),
    ("sot2048-train", "altered"), ("sot2048-train", "w2_value"),
    ("sot2048-train", "w2_grad"), ("msslin-train", "unchanged"),
    ("msslin-train", "half_batch"), ("msslin-train", "altered"),
    ("sot2048-serve", "half_batch"), ("sot2048-serve", "altered")])
def test_a_fault_underneath_is_not_correct(workload, fault, monkeypatch):
    cell = small_cell(workload)
    cls = SmallProgram
    if fault == "unchanged":
        cls = Unchanged
    elif fault == "half_batch" and workload.endswith("serve"):
        cls = HalfServed
    elif fault == "half_batch":
        _half_batch_loss(monkeypatch)
    elif fault.startswith("w2_"):
        _w2_half_rows(monkeypatch, fault[3:])
    else:
        _altered_synth(monkeypatch)
    result = run.run_cell(cell, 11, 0.1, False, "cpu", cls, time.perf_counter())
    assert not result["correct"], result["compared"]


@pytest.mark.cuda
def test_card_xhat_is_the_plain_synth_of_its_controls(card):
    """The served x_hat on the card against the program's own plain synth
    (float64 phase) and the reference synth, on the served controls, at
    seed 63543500."""
    from sot_tpu_torch.ops.kernels.synth import synth_render_plain

    cell = spec.Cell("sot2048-serve")
    cfg = cell.config
    program.set_policy()
    weights = inputs.weights(cfg, 63543500, card)
    x = inputs.clips(cfg, 64, 63543500, "serve", card)
    prog = program.Program(cfg, weights, card)
    out = prog.predict(x.cpu().numpy())
    controls = prog.mod.decoder.get_controls(out["weights"], out["pitch_hz"])
    plain = synth_render_plain(controls["amplitudes"], controls["frequencies"],
                               cfg["n_samples"], cfg["sample_rate"])
    assert check._max_gap(out["x_hat"], plain) < 1e-6
    readings = check.serve_readings(cfg, card, weights, [x.cpu().numpy()],
                                    [{k: (v if k == "x_hat" else v.cpu().numpy())
                                      for k, v in out.items()}])
    assert check.verdict(readings, cell.limits), readings
    assert np.isfinite(readings["xhat_rel"])
