"""The multi-rank training step, port of ``sot_tpu/parallel/train.py``:
batch data parallelism over the mesh's 'data' axis and, with
``shard_loss``, the loss's frame-sharded STFT and row-sharded SOT solve
over its 'freq' axis.

Each rank runs the port's eager ``train_step`` body on its rows of the
global batch: the parameters are broadcast from the mesh's first rank when
the step is made, the gradients are all-reduced to their mean over the mesh
before Adam, and every rank then applies the same update, so the
parameters stay equal. With a 46K-parameter encoder the gradients are ~184
KB.

The invariant. Every term of the loss is a mean over rows (MSS over clips,
frames and bins, the SOT term over spectrum rows, the odd-ratio prior over
frames), and each rank's loss is the mean over its own equal-sized share of
every term's rows. So the mean over the mesh of the ranks' losses is the
single-process loss of the global batch, and the mean of their gradients is
its gradient:
  * DP (the ranks of a data row see the same clips): each rank's loss is
    that of its clips; the mean over data rows is the global mean.
  * ``shard_loss``: the ranks of a data row run the same encoder and synth
    forward on the same clips, and the same MSS and prior (each its
    ``freq`` copy of one replicated value). Only the loss STFT's frames and
    the SOT rows are split: the rank's SOT term is the mean over its frames.
    The mean over 'freq' of the replicated terms is the term, and that of
    the frame shares is the data row's SOT mean. Each rank holds the whole
    synthesised clip, so it frames its time chunk with the halo sliced from
    that clip (no collective), and the halo's cotangent reaches the
    parameters through the rank's own synth backward.
The logs are the mesh means of the ranks' logs, ``grad_norm`` the norm of
the reduced gradients.

Dropout: each rank draws the mask of the whole global batch from its
generator and keeps its rows (``GeneratorDropout.shard``), so the DP step
draws the single-process step's masks (the ranks' generators start
equal).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F

from sot_tpu_torch.features import STFT
from sot_tpu_torch.ops.numerics import safe_log
from sot_tpu_torch.ops.stft import stft_magnitude
from sot_tpu_torch.parallel.mesh import Mesh, data_sharding, replicated, shard
from sot_tpu_torch.parallel.sharded_ops import all_gather
from sot_tpu_torch.training.trainer import Modules, TrainState, train_step


@dataclasses.dataclass(frozen=True)
class _FrameShardedSTFT:
    """Drop-in for ``features.STFT`` whose frames ride the mesh's 'freq'
    axis: given this rank's whole clips [batch, T] (the synth runs
    replicated over 'freq'), it frames its own time chunk and the next
    ``n_fft - hop`` samples (zeros past the end: ``pad_end``) and returns its
    frames [batch, frames / freq, bins] of ``stft_magnitude(...,
    pad_end=True)`` of the clips; ``reduce`` averages over all the frames."""

    inner: STFT
    mesh: Mesh

    def __call__(self, audio: torch.Tensor, reduce: bool = False,
                 log: bool = False) -> torch.Tensor:
        n_fft, hop = self.inner.n_fft, self.inner.hop_length
        chunk = shard(self.mesh, audio.shape[-1], ("freq",))
        ext = F.pad(audio, (0, n_fft - hop))[..., chunk.start:chunk.stop + n_fft - hop]
        x = stft_magnitude(ext, size=n_fft, overlap=1.0 - hop / n_fft,
                           window=self.inner.window, pad_end=False)
        if reduce:
            x = all_gather(torch.mean(x, dim=1), self.mesh, "freq").mean(0)
        if log or self.inner.log:
            x = safe_log(x)
        return x

    def get_frequencies(self):
        return self.inner.get_frequencies()


def shard_loss_modules(mod: Modules, mesh: Mesh) -> Modules:
    """``mod`` with its loss path on the mesh: the frame-sharded loss STFT.
    The SOT rows (clips x frames) follow the frames: the rank's spectra hold
    only its frames, so every ``Wasserstein1D`` solves only the rank's rows,
    on its own kernel gates (``sharded_ops.wasserstein_same_grid_row_sharded``
    is the same solve). Only for an STFT loss domain; any other ``mod`` comes
    back as it is. The encoder and the loss functions are shared."""
    if not isinstance(mod.transform, STFT):
        return mod
    return dataclasses.replace(mod, transform=_FrameShardedSTFT(mod.transform, mesh))


def mean_logs(logs: Dict[str, torch.Tensor], mesh: Mesh) -> Dict[str, torch.Tensor]:
    """The mesh mean of each rank's logs (one all-reduce)."""
    keys = sorted(logs)
    flat = torch.stack([logs[k].detach().to(torch.float32).reshape(()) for k in keys])
    dist.all_reduce(flat, group=mesh.group("all"))
    flat = flat / mesh.size
    return {k: flat[i] for i, k in enumerate(keys)}


def mean_grads(grads: Sequence[torch.Tensor], mesh: Mesh) -> None:
    """Replace each gradient by its mean over the mesh, in place (one
    all-reduce of the gradients flattened into one buffer)."""
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=mesh.group("all"))
    flat = flat / mesh.size
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def make_sharded_train_step(mod: Modules, mesh: Mesh, shard_loss: Optional[bool] = None
                            ) -> Callable[[TrainState, torch.Tensor], Dict[str, torch.Tensor]]:
    """The data-parallel train step over ``mesh``: ``step(state, x_global)
    -> logs``, where ``x_global`` [batch, n_samples] is the same global
    batch on every rank and the logs are global.

    Broadcasts the encoder's parameters from the mesh's first rank (once,
    here). The ``TrainState`` must be the same on every rank: ``init_state``
    with one seed (the dropout generator) or one checkpoint's restore.
    ``shard_loss`` (default: a 'freq' axis above 1 and an STFT loss domain)
    puts the loss STFT and the SOT rows on 'freq' (``shard_loss_modules``).
    Raises when the batch, the loss frames or the samples do not divide
    over the mesh."""
    if mesh.device.type != mod.device.type:
        raise ValueError(f"the mesh's device {mesh.device} is not the model's {mod.device}")
    freq = mesh.shape["freq"]
    if shard_loss is None:
        shard_loss = freq > 1 and isinstance(mod.transform, STFT)
    if shard_loss and isinstance(mod.transform, STFT):
        hop = mod.transform.hop_length
        if mod.config.n_samples % (hop * freq) != 0:
            raise ValueError(f"n_samples={mod.config.n_samples}: its {hop}-sample loss frames "
                             f"do not divide over freq={freq}")
        mod = shard_loss_modules(mod, mesh)
    replicated(mesh, list(mod.encoder.parameters()))
    dropout = mod.encoder.dropout
    reduce_grads = functools.partial(mean_grads, mesh=mesh)

    def step(state: TrainState, x_global: torch.Tensor) -> Dict[str, torch.Tensor]:
        rows = data_sharding(mesh, x_global.shape[0])
        dropout.shard = mesh.index(("data",))
        try:
            logs = train_step(mod, state, x_global[rows], reduce_grads=reduce_grads)
        finally:
            dropout.shard = None
        grad_norm = logs.pop("grad_norm")
        logs = mean_logs(logs, mesh)
        logs["grad_norm"] = grad_norm
        return logs

    return step
