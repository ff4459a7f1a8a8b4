"""Shared helpers of the benchmark's tests: cells cut to a CPU-sized run."""

from __future__ import annotations

import copy

import pytest
import torch

from portbench import spec
from portbench.adapters import pesto_sot as adapter


class SmallProgram(adapter.Program):
    """The program at a configuration file's sizes but the cell's batch
    (the registry holds the published batch of 64)."""

    @staticmethod
    def run_config(cfg):
        return adapter.experiment_config(dict(cfg, batch_size=64)).replace(
            batch_size=cfg["batch_size"])


def small_cell(name: str, batch: int = 4, clips: int = 24) -> spec.Cell:
    """A cell of BENCHMARK.json with its batch, dataset and request pool
    cut to run on the CPU in seconds; widths, lengths and losses as
    published."""
    cell = spec.Cell(name)
    cell.config = copy.deepcopy(cell.config)
    cell.config["batch_size"] = batch
    cell.config["generator"]["dataset_size"] = clips
    cell.traffic = dict(cell.traffic, request_clips=2, pool_requests=3, warmup_requests=1,
                        check_requests=2)
    return cell


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none (decided here, never
    while the module is imported)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card: python -m pytest portbench/tests -m cuda)")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(min(saved, 4))
    yield
    torch.set_num_threads(saved)
