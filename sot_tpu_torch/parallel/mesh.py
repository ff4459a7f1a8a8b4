"""The (data, freq) process mesh, port of ``sot_tpu/parallel/mesh.py``.

One mesh, two axes:
  * 'data' — batch data parallelism, the outer axis (it crosses hosts)
  * 'freq' — intra-sample sharding: the loss STFT's frames, the SOT rows,
    the synth's samples, the spectra's bins

A ``Mesh`` is a small object over the first ``n`` ranks of the default
process group: rank r sits at (r // freq, r % freq), the row-major layout of
JAX's ``devices.reshape(n // freq, freq)``. It holds one process group per
axis (the ranks that share this rank's other coordinate) and one over all
of its ranks. Each rank holds its local blocks; ``shard`` says which block
of an axis of global size ``size`` is this rank's.

Without a process group, ``make_mesh`` gives the layout alone (shape and no
groups), as a JAX mesh of virtual devices gives its shape: the shape logic
is testable in one process.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from sot_tpu_torch.device import DeviceLike, resolve_device


class Mesh:
    """The (data, freq) layout of ``n`` ranks and this rank's place in it.

    ``shape`` — {"data": n // freq, "freq": freq}; ``rank`` — this
    process's rank in the mesh, or None outside it (or with no process
    group); ``device`` — the device of this rank's tensors; ``groups`` —
    the process groups of "data", "freq" and "all" (None without a process
    group)."""

    def __init__(self, shape: Dict[str, int], device: torch.device, rank: Optional[int] = None,
                 groups: Optional[Dict[str, dist.ProcessGroup]] = None):
        self.shape = shape
        self.device = device
        self.rank = rank
        self.groups = groups

    @property
    def size(self) -> int:
        return self.shape["data"] * self.shape["freq"]

    @property
    def coords(self) -> Dict[str, int]:
        """This rank's (data, freq) coordinates."""
        rank = self._member()
        return {"data": rank // self.shape["freq"], "freq": rank % self.shape["freq"]}

    def group(self, axis: str) -> dist.ProcessGroup:
        """The process group of ``axis`` ("data", "freq" or "all") that
        holds this rank."""
        self._member()
        return self.groups[axis]

    def index(self, axes: Sequence[str]) -> Tuple[int, int]:
        """(this rank's linear index, the number of blocks) over ``axes``,
        the first axis outermost."""
        coords = self.coords
        index, count = 0, 1
        for axis in axes:
            index = index * self.shape[axis] + coords[axis]
            count *= self.shape[axis]
        return index, count

    def _member(self) -> int:
        if self.groups is None:
            raise RuntimeError("this mesh is a layout only: no process group is initialised")
        if self.rank is None:
            raise RuntimeError(f"rank {dist.get_rank()} is not in this mesh of {self.size} ranks")
        return self.rank

    def __repr__(self) -> str:
        return f"Mesh(shape={self.shape}, rank={self.rank}, device={self.device})"


def make_mesh(n_devices: Optional[int] = None, freq: int = 1, device: DeviceLike = None) -> Mesh:
    """Mesh of shape (data = n / freq, freq) over the first ``n_devices``
    ranks of the default process group (default: all of them; 1 without a
    group). ``device`` is this rank's device (default: the current GPU;
    raises if there is none).

    With a process group every rank of the world must call this, in the
    same order (each group is made collectively); a rank past
    ``n_devices`` gets a mesh it is not in. Without one, ``n_devices`` may
    exceed 1 and the mesh is the layout alone."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    initialised = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialised else 1
    if n_devices is None:
        n_devices = world
    if n_devices % freq != 0:
        raise ValueError(f"n_devices ({n_devices}) not divisible by freq ({freq})")
    shape = {"data": n_devices // freq, "freq": freq}
    if not initialised:
        return Mesh(shape, device)
    if n_devices > world:
        raise ValueError(f"n_devices ({n_devices}) exceeds the world size ({world})")
    if dist.get_backend() == "nccl" and device.type != "cuda":
        raise ValueError(f"the NCCL process group needs CUDA tensors, not {device}")
    rank = dist.get_rank()
    groups: Dict[str, dist.ProcessGroup] = {}
    for d in range(shape["data"]):  # one 'freq' group per data row
        group = dist.new_group(list(range(d * freq, (d + 1) * freq)))
        if d * freq <= rank < (d + 1) * freq:
            groups["freq"] = group
    for f in range(freq):  # one 'data' group per freq column
        group = dist.new_group(list(range(f, n_devices, freq)))
        if rank < n_devices and rank % freq == f:
            groups["data"] = group
    groups["all"] = (dist.group.WORLD if n_devices == world
                     else dist.new_group(list(range(n_devices))))
    if rank >= n_devices:
        return Mesh(shape, device, None, groups)
    return Mesh(shape, device, rank, groups)


def shard(mesh: Mesh, size: int, axes: Sequence[str] = ("data",)) -> slice:
    """This rank's block of an axis of global ``size`` split evenly over the
    mesh ``axes`` (the first outermost); raises if it does not divide."""
    index, count = mesh.index(axes)
    if size % count != 0:
        raise ValueError(f"size {size} does not divide over the {count} shards of {tuple(axes)}")
    block = size // count
    return slice(index * block, (index + 1) * block)


def data_sharding(mesh: Mesh, batch: int) -> slice:
    """This rank's rows of a global batch of ``batch`` rows: the leading
    axis split over 'data', replicated over 'freq'."""
    return shard(mesh, batch, ("data",))


def replicated(mesh: Mesh, tensors: Sequence[torch.Tensor]) -> Sequence[torch.Tensor]:
    """Make ``tensors`` (on the mesh's device) equal on every rank of the
    mesh: each is broadcast in place from the mesh's first rank."""
    group = mesh.group("all")
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t, src=0, group=group)
    return tensors
