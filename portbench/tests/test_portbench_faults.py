"""Faults planted in the program, a whole run each on the CPU: the timed
path broken underneath (a state left unchanged, half of the batch left
out, the synth's output altered, the W2 value or its gradient over half of
the rows) comes out not correct."""

from __future__ import annotations

import time

import pytest
import torch

from portbench import run
from portbench.tests.conftest import SmallProgram, small_cell




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
