"""Worker ranks for ``tests/test_torch_parallel.py``: the port's sharded ops
and train steps over a Gloo process group on the CPU.

    python -m tests._torch_parallel_worker cases RANK WORLD INIT_METHOD DIR
    python -m tests._torch_parallel_worker env DIR

``cases``: one of WORLD (4) ranks. It reads the inputs the test wrote into
DIR (``inputs.pt``: the encoder's parameters and the global batch), runs
every case on its mesh (the 2-rank cases on a mesh of the first two ranks)
and writes its local blocks to ``DIR/rank<RANK>.pt``. ``env``: one rank of
a launch wired from ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
``RANK`` and ``LOCAL_RANK``, as ``torchrun`` sets them; it prints
``LAUNCH OK rank=<RANK>``.

Imports only ``sot_tpu_torch``: JAX runs in the test process alone.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from sot_tpu_torch.ops.stft import stft_magnitude
from sot_tpu_torch.parallel import dryrun
from sot_tpu_torch.parallel.launch import global_mesh, initialize_distributed
from sot_tpu_torch.parallel.mesh import make_mesh, shard
from sot_tpu_torch.parallel.sharded_ops import (oscillator_bank_sample_sharded,
                                                stft_magnitude_frame_sharded,
                                                wasserstein_1d_freq_sharded,
                                                wasserstein_same_grid_row_sharded)
from sot_tpu_torch.parallel.train import make_sharded_train_step, mean_logs, shard_loss_modules
from sot_tpu_torch.training import trainer

# the frame-sharded STFT cases: (shards, n_fft, hop); (4, 2048, 256) has a
# halo of two chunks
STFT_CASES = ((2, 512, 128), (4, 2048, 256), (4, 512, 64))
# the sample-sharded oscillator cases: (shards, data rows)
OSC_CASES = ((2, 1), (4, 1), (2, 2))
# the train steps: the 'freq' size of the 4-rank mesh (1: the DP step)
STEP_FREQS = (1, 2, 4)


def stft_audio() -> np.ndarray:
    return np.random.default_rng(0).standard_normal((3, 4096)).astype(np.float32)


def flattop_audio() -> np.ndarray:
    return np.random.default_rng(1).standard_normal((2, 4096)).astype(np.float32)


def osc_inputs():
    """JAX's test's envelopes: 8 partials of f0 in [100, 900] Hz at 8 kHz
    (the top partials cross Nyquist: the in-shard masking runs)."""
    rng = np.random.default_rng(7)
    batch, t, n_sin = 2, 2048, 8
    f0 = rng.uniform(100.0, 900.0, (batch, 1, 1)).astype(np.float32)
    ratios = np.arange(1, n_sin + 1, dtype=np.float32)
    freqs = np.ascontiguousarray(np.broadcast_to(f0 * ratios, (batch, t, n_sin)))
    amps = rng.uniform(0.1, 1.0, (batch, t, n_sin)).astype(np.float32)
    return freqs, amps


def osc_grad_inputs():
    rng = np.random.default_rng(8)
    batch, t, n_sin = 2, 1024, 4
    freqs = (rng.uniform(100.0, 2000.0, (batch, 1, n_sin)).astype(np.float32)
             * np.ones((1, t, 1), np.float32))
    amps = rng.uniform(0.1, 1.0, (batch, t, n_sin)).astype(np.float32)
    return freqs, amps


def w_inputs():
    """JAX's test's rows: u of mass 0.95, v of mass 1.3, a sorted random grid."""
    rng = np.random.default_rng(2)
    rows, bins = 16, 256
    grid = np.sort(rng.uniform(0, 1, bins)).astype(np.float32)
    uw = rng.uniform(0, 1, (rows, bins)).astype(np.float32)
    vw = rng.uniform(0, 1, (rows, bins)).astype(np.float32)
    uw = uw / uw.sum(1, keepdims=True) * 0.95
    vw = vw / vw.sum(1, keepdims=True) * 1.3
    return grid, uw, vw


def w_grad_inputs():
    rng = np.random.default_rng(3)
    rows, bins = 8, 128
    grid = np.linspace(0, 1, bins).astype(np.float32)
    uw = rng.uniform(0.1, 1, (rows, bins)).astype(np.float32)
    vw = rng.uniform(0.1, 1, (rows, bins)).astype(np.float32)
    return grid, uw, vw


def sot_rows_inputs():
    """Rows for the row-sharded same-grid solve: 16 rows of 257 bins."""
    rng = np.random.default_rng(4)
    grid = np.linspace(0, 1, 257).astype(np.float32)
    uw = rng.uniform(0, 1, (16, 257)).astype(np.float32) ** 4
    vw = rng.uniform(0, 1, (16, 257)).astype(np.float32) ** 4
    return grid, uw / uw.sum(1, keepdims=True), vw / uw.sum(1, keepdims=True)


def fresh(cfg, params):
    mod = trainer.build_modules(cfg, device="cpu")
    mod.encoder.load_state_dict(params)
    return mod, trainer.init_state(mod)


def flat(tensors) -> torch.Tensor:
    return torch.cat([t.detach().reshape(-1) for t in tensors])


def t(a: np.ndarray, grad: bool = False) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(grad)


def cases(rank: int, world: int, init_method: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    assert initialize_distributed(device="cpu", init_method=init_method, world_size=world,
                                  rank=rank)
    inputs = torch.load(os.path.join(out_dir, "inputs.pt"))
    out = {}

    # (ranks, freq) -> mesh; every rank makes every mesh, in this order
    meshes = {(n, freq): make_mesh(n, freq=freq, device="cpu")
              for n, freq in ((2, 2), (4, 4), (4, 2), (4, 1))}

    def member(mesh):
        return mesh.rank is not None

    audio = t(stft_audio())
    for n, size, hop in STFT_CASES:
        mesh = meshes[(n, n)]
        if member(mesh):
            chunk = shard(mesh, audio.shape[-1], ("freq",))
            out[f"stft/{n}/{size}/{hop}"] = stft_magnitude_frame_sharded(
                audio[:, chunk], mesh, size=size, hop_length=hop)

    mesh = meshes[(4, 4)]
    audio = flattop_audio()
    chunk = t(audio[:, shard(mesh, audio.shape[-1], ("freq",))], True)
    spec = stft_magnitude_frame_sharded(chunk, mesh, size=2048, hop_length=256,
                                        window="flattop")
    (spec ** 2).sum().backward()
    out["flattop/spec"], out["flattop/grad"] = spec.detach(), chunk.grad

    freqs, amps = osc_inputs()
    for n, data in OSC_CASES:
        mesh = meshes[(n * data, n)]
        if member(mesh):
            rows = shard(mesh, freqs.shape[0], ("data",))
            chunk = shard(mesh, freqs.shape[1], ("freq",))
            out[f"osc/{n}/{data}"] = oscillator_bank_sample_sharded(
                t(freqs)[rows, chunk], t(amps)[rows, chunk], mesh, sample_rate=8000)

    mesh = meshes[(4, 4)]
    freqs, amps = osc_grad_inputs()
    chunk = shard(mesh, freqs.shape[1], ("freq",))
    f_l, a_l = t(freqs[:, chunk], True), t(amps[:, chunk], True)
    audio = oscillator_bank_sample_sharded(f_l, a_l, mesh)
    (audio ** 2).sum().backward()
    out["osc_grad/audio"] = audio.detach()
    out["osc_grad/f"], out["osc_grad/a"] = f_l.grad, a_l.grad

    # the freq-sharded W on the (2, 2) mesh: rows over 'data', bins over 'freq'
    mesh = meshes[(4, 2)]
    for name, (grid, uw, vw), kw in (("w", w_inputs(), dict(p=2, limit_quantile_range=True)),
                                     ("w_grad", w_grad_inputs(), dict(p=2))):
        rows = shard(mesh, uw.shape[0], ("data",))
        bins = shard(mesh, uw.shape[1], ("freq",))
        v_l = t(vw[rows, bins], True)
        w = wasserstein_1d_freq_sharded(t(grid)[bins], t(uw)[rows, bins], v_l, mesh, **kw)
        # the ranks of a data row hold the same rows' W: each backpropagates
        # its share, so the mesh's sum counts every row once
        (w.sum() / mesh.shape["freq"]).backward()
        out[f"{name}/w"], out[f"{name}/grad_v"] = w.detach(), v_l.grad

    # the row-sharded same-grid solve on the (2, 2) mesh: rows over both axes
    grid, uw, vw = sot_rows_inputs()
    rows = shard(mesh, uw.shape[0], ("data", "freq"))
    v_l = t(vw[rows], True)
    w = wasserstein_same_grid_row_sharded(t(grid), t(uw[rows]), v_l, p=2.0,
                                          limit_quantile_range=True, target_constant=True)
    w.sum().backward()
    out["rows/w"], out["rows/grad_v"] = w.detach(), v_l.grad

    # the train steps in training mode, then the eval-mode sharded loss
    cfg = dryrun.tiny_config(8)
    x = inputs["x"]
    for freq in STEP_FREQS:
        mesh = meshes[(4, freq)]
        mod, state = fresh(cfg, inputs["params"])
        step = make_sharded_train_step(mod, mesh, shard_loss=freq > 1)
        logs = step(state, x)
        params = list(mod.encoder.parameters())
        out[f"step/{freq}/logs"] = {k: v.detach() for k, v in logs.items()}
        out[f"step/{freq}/params"] = flat(params)
        out[f"step/{freq}/grads"] = flat(p.grad for p in params)
        if freq == 1:  # a batch that does not divide over 'data' raises before any collective
            try:
                step(state, x[:6])
                out["step/uneven_batch_raises"] = False
            except ValueError:
                out["step/uneven_batch_raises"] = True

    mesh = meshes[(4, 2)]
    mod, _ = fresh(cfg, inputs["params"])
    smod = shard_loss_modules(mod, mesh)
    with torch.no_grad():
        _, (logs, _) = trainer.compute_loss(smod, x[shard(mesh, x.shape[0], ("data",))])
    out["eval/logs"] = mean_logs(logs, mesh)

    # the dry run's sequence on this group: meshes (2, 2) and (1, 4), the ops
    out["dryrun"] = dryrun._sequence(rank, world, torch.device("cpu"), cfg, "auto",
                                     x.numpy()[None], False, 0)

    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def env_launch(out_dir: str) -> None:
    """One rank of a 2-process launch from torchrun's variables."""
    torch.set_num_threads(1)
    assert initialize_distributed(device="cpu") is True, "the environment did not initialise"
    rank = dist.get_rank()
    assert dist.get_world_size() == 2 and dist.get_backend() == "gloo"
    mesh = global_mesh(freq=1, device="cpu")
    assert mesh.shape == {"data": 2, "freq": 1} and mesh.coords == {"data": rank, "freq": 0}
    ones = torch.ones(8)
    dist.all_reduce(ones, group=mesh.group("data"))
    assert bool((ones == 2.0).all()), ones

    mesh = global_mesh(freq=2, device="cpu")
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 1024)).astype(np.float32))
    spec = stft_magnitude_frame_sharded(x[:, shard(mesh, 1024, ("freq",))], mesh, size=512,
                                        hop_length=128)
    ref = stft_magnitude(x, size=512, overlap=0.75)[:, shard(mesh, 8, ("freq",))]
    assert float((spec - ref).abs().max()) <= 1e-5
    torch.save({"spec": spec}, os.path.join(out_dir, f"env{rank}.pt"))
    dist.destroy_process_group()
    print(f"LAUNCH OK rank={rank}", flush=True)


if __name__ == "__main__":
    if sys.argv[1] == "cases":
        cases(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
    else:
        env_launch(sys.argv[2])
