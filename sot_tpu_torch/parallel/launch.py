"""Multi-process launch helpers, port of ``sot_tpu/parallel/launch.py``.

Every process runs the same program. ``initialize_distributed`` wires
``torch.distributed`` from the environment that ``torchrun`` sets
(``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
``LOCAL_RANK``: PyTorch's counterparts of ``JAX_COORDINATOR_ADDRESS``,
``JAX_NUM_PROCESSES`` and ``JAX_PROCESS_ID``) or from explicit arguments.
The backend follows the device: NCCL on ``cuda``, Gloo on ``cpu``; a caller
may name another (Gloo over CUDA tensors, for ranks that share one card).
``global_mesh`` builds the (data, freq) mesh over the whole world, 'data'
outermost: torchrun numbers a host's processes consecutively, so a data row
of ``freq`` ranks stays on one host and the 'data' axis crosses hosts.

Single-process runs are the common case and need none of this:
``initialize_distributed`` returns False and touches nothing.

    torchrun --nproc-per-node=N your_script.py   # initialize_distributed()
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from sot_tpu_torch.device import DeviceLike, resolve_device
from sot_tpu_torch.parallel.mesh import Mesh, make_mesh


def initialize_distributed(backend: Optional[str] = None, device: DeviceLike = None,
                           init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None) -> bool:
    """Initialise the default process group if a multi-process environment
    is present (``MASTER_ADDR`` set, or an explicit ``init_method``).

    ``device`` is this rank's device (default: the GPU; raises if there is
    none): a ``cuda`` device without an index becomes ``cuda:LOCAL_RANK``
    and is made current. ``backend`` defaults to NCCL on ``cuda`` and Gloo
    on ``cpu``. Returns True if the group was initialised; in a single
    process with none of the variables, False, touching nothing."""
    if init_method is None and "MASTER_ADDR" not in os.environ:
        return False
    world_size = world_size if world_size is not None else _int_env("WORLD_SIZE")
    rank = rank if rank is not None else _int_env("RANK")
    if world_size is None or rank is None:
        raise ValueError("a multi-process launch needs WORLD_SIZE and RANK (or world_size, rank)")
    device = resolve_device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", _int_env("LOCAL_RANK") or 0)
        torch.cuda.set_device(device)
    dist.init_process_group(backend or ("nccl" if device.type == "cuda" else "gloo"),
                            init_method=init_method or "env://",
                            world_size=world_size, rank=rank)
    return True


def _int_env(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v is not None else None


def global_mesh(freq: int = 1, device: DeviceLike = None) -> Mesh:
    """Mesh over the whole world: ('data' across hosts, 'freq' within one)."""
    return make_mesh(freq=freq, device=device)
