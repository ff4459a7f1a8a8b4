"""Training against the reference on the CPU, and the training control.

* Training at the train cells' widths with a batch of 4: a whole run
  comes out correct.
* The control (the reference in the next lower precision, put in the
  program's place, its three updates read by the cell's comparison) comes
  out not correct.
* On the card (``-m cuda``): a whole run of each train cell at its full
  size.
"""

from __future__ import annotations

import time

import pytest
import torch

from portbench import check, load, program, run, spec
from portbench.compare import pesto_sot as compare
from portbench.tests.conftest import SmallProgram, small_cell


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
    ref = compare.train_reference(cfg, dev, work.weights0, batches, work.dropout_seed)
    tf32 = compare.first_update(cfg, dev, work.weights0, batches, work.dropout_seed, lower=True)
    ctl = compare.train_reference(cfg, dev, work.weights0, batches, work.dropout_seed, lower=True)
    readings = compare.train_compare(ref, tf32, work.weights0, ctl["losses"],
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
    cell = spec.Cell(workload)
    result = run.run_cell(cell, 2718281828, 1.0, False, "cuda", program.adapter(cell),
                          time.perf_counter())
    assert result["correct"], result["compared"]
