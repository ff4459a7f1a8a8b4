"""Readings and counts pinned bit for bit: what the harness printed before
each model's reference, adapter, comparison and counts became files of the
model's own (``pinned_readings.json``), which the harness as it stands
must reproduce.

* Readings: a whole run of each cell at ``conftest.small_cell``'s sizes on
  the CPU, on two seeds, every number read (compared or printed). They were
  read with one thread: with more, the later steps' losses, the changes and
  the whole first gradient's gap vary by rounding from one run to the next.
* Counts: those the per-layer metrics read, through the configuration's
  model (``mfu.*``: a train step's and a request's operations;
  ``conv_roofline``'s and ``w2_roofline``'s least seconds a step).
"""

from __future__ import annotations

import importlib.util
import json
import time
from pathlib import Path

import pytest
import torch

from portbench import counts, run
from portbench.tests.conftest import SmallProgram, small_cell

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[1]
PINNED = json.loads((HERE / "pinned_readings.json").read_text())


@pytest.mark.parametrize("key", sorted(PINNED["readings"]))
def test_readings_are_the_pinned_ones(key):
    workload, seed = key.split("/")
    torch.set_num_threads(1)
    result = run.run_cell(small_cell(workload), int(seed), 0.1, False, "cpu", SmallProgram,
                          time.perf_counter())
    assert result["readings"] == PINNED["readings"][key]


def _reader(name):
    s = importlib.util.spec_from_file_location(name, ROOT / "portbench/metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("config", sorted(PINNED["counts"]))
def test_counts_are_the_pinned_ones(config):
    cfg = json.loads((ROOT / "portbench/configs" / f"{config}.json").read_text())
    model = counts.of(cfg)
    got = {"frames_per_clip": model.frames_per_clip(cfg),
           "train_step_flops": model.train_step_flops(cfg, cfg["batch_size"]),
           "forward_flops": model.forward_flops(cfg, 64),
           "conv_least_step_seconds": _reader("conv_roofline").least_step_seconds(cfg)}
    if any(lc["kind"] == "wasserstein" for lc in cfg["losses"]):
        got["w2_least_step_seconds"] = sum(b / counts.PEAK_BYTES
                                           for b in _reader("w2_roofline").w2_bytes(cfg))
    assert got == PINNED["counts"][config]
