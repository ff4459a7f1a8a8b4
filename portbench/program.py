"""The system under test: with the models' adapters (``adapters/<model>.py``)
the only modules of the benchmark that import the program
(``sot_tpu_torch``). It builds the program's CUDA sources, sets its
precision policy, and finds the adapter of a cell's model, which builds
the program's model from a configuration file, loads the benchmark's
weights into it and exposes the entries the windows drive.
"""

from __future__ import annotations

from sot_tpu_torch.device import set_precision_policy
from sot_tpu_torch.ops.kernels import _build

from portbench import spec


def build_kernels() -> float:
    """Build every CUDA source of the program, the nvcc processes started
    together; the seconds it took (0 when all were built in this checkout)."""
    names = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    return max(_build.build(names).values(), default=0.0)


def set_policy() -> None:
    set_precision_policy()


def adapter(cell: spec.Cell) -> type:
    """The ``Program`` class of the cell's model (``adapters/<model>.py``):
    built as ``Program(cfg, weights, device)``."""
    return spec.load_part("adapters", cell.model.name, cell.model.base).Program
