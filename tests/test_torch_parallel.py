"""The port's multi-rank package (``sot_tpu_torch/parallel/``) on the CPU over
Gloo, at the JAX dryrun's tiny shapes, against the port's single-process
ops and step and, where JAX runs them here (its 8-device virtual CPU mesh),
against the JAX package's sharded functions: every case of
``tests/test_parallel.py``.

One spawn of 4 ranks (``tests/_torch_parallel_worker.py``, importing only
the port; ``init_method=file://`` under the test's tmp dir) computes every
4-rank and 2-rank case (the 2-rank ones on a mesh of the first two ranks)
and the dry run's sequence; a module fixture hands their local blocks to
the tests. One more launch of 2 ranks from torchrun's environment
variables on a free port; the one-rank dry run in the test process.

Tolerances:
  * frame-sharded STFT: atol 2e-5 against the single-device op (JAX's
    test's; the frames are the same samples, rfft on other batch shapes),
    and against JAX's sharded op; flattop: the summed squares rtol 1e-5,
    the gradient atol 1e-3 (JAX's)
  * sample-sharded oscillator: atol 1.5e-3 (JAX's: its phase is stitched
    mod 2pi at the ranks' chunk boundaries, the single-device op's at
    every 1000 samples: f32 rounding of the phase, not bit-exact); its
    gradients atol 5e-3 of their max, the summed squares rtol 1e-4
  * freq-sharded W: rtol 1e-5, atol 1e-7 on the rows whose float64 CDF
    stays 1e-4 from the quantile cut (JAX's); its gradient atol 1e-5
  * row-sharded same-grid W: bit-equal per row, value and gradient (rows
    are independent)
  * train steps in training mode (dropout on, the single-process step's
    masks): losses rel 1e-4 (``tests/test_torch_train.py``'s), parameters
    after the update atol 2.5e-4 (Adam's first step moves an element by
    ~lr = 1e-4 along sign(g); a near-zero gradient whose sign rounds the
    other way moves it by 2 lr), the reduced gradient within 2e-3 of its
    max and ``grad_norm`` rel 1e-3: this step's gradient sits on rounding
    kinks (the SOT quantile cap, the MSS L1 sign), so the single-process
    step's own gradient moves by 6.1e-4 of its max between 1 and 8 CPU
    threads; the ranks' parameters, gradients and logs bit-equal to each
    other
  * the sharded eval-mode loss: rel 1e-4 against JAX's ``compute_loss`` on
    its ``shard_loss_modules`` (``tests/test_torch_train.py``'s loss
    tolerance), rel 1e-5 against the port's single-process loss
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from sot_tpu.configs import get_experiment as jax_get_experiment  # noqa: E402
from sot_tpu.parallel.mesh import make_mesh as jax_make_mesh  # noqa: E402
from sot_tpu.parallel.sharded_ops import (  # noqa: E402
    stft_magnitude_frame_sharded as jax_stft_frame_sharded)
from sot_tpu.parallel.train import shard_loss_modules as jax_shard_loss_modules  # noqa: E402
from sot_tpu.training import trainer as jtrainer  # noqa: E402
from sot_tpu_torch import data as tdata  # noqa: E402
from sot_tpu_torch.convert import params_from_flax  # noqa: E402
from sot_tpu_torch.features import STFT  # noqa: E402
from sot_tpu_torch.ops.oscillator import oscillator_bank  # noqa: E402
from sot_tpu_torch.ops.stft import stft_magnitude  # noqa: E402
from sot_tpu_torch.ops.wasserstein import (wasserstein_1d_same_grid,  # noqa: E402
                                           wasserstein_same_grid)
from sot_tpu_torch.parallel import dryrun  # noqa: E402
from sot_tpu_torch.parallel.launch import global_mesh, initialize_distributed  # noqa: E402
from sot_tpu_torch.parallel.mesh import Mesh, make_mesh  # noqa: E402
from sot_tpu_torch.parallel.train import (_FrameShardedSTFT,  # noqa: E402
                                          make_sharded_train_step, shard_loss_modules)
from sot_tpu_torch.training import trainer  # noqa: E402
from tests import _torch_parallel_worker as worker  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
TIMEOUT = 240
GATES = ("SOT_TPU_W2_MERGE", "SOT_TPU_W2_MERGE_SMALL", "SOT_TPU_SYNTH_PALLAS",
         "SOT_TPU_CQT_PALLAS", "SOT_TPU_CONV_BF16", "SOT_TPU_STFT_PALLAS",
         "SOT_TPU_CONV_PALLAS", "SOT_TPU_FORCE_GENERAL")


def _jax_config():
    cfg = jax_get_experiment("SOT-2048", batch_size=8, n_samples=1024, cqt_fmin=261.6,
                             transform_n_fft=512, transform_hop=128)
    return cfg.replace(losses=tuple(
        lc if lc.kind != "mss" else type(lc)(**{**lc.__dict__, "fft_sizes": (512, 128)})
        for lc in cfg.losses))


def _worker_env(extra=None):
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS", "MASTER_ADDR", "MASTER_PORT")}
    env["PYTHONPATH"] = os.pathsep.join([ROOT] + [p for p in env.get("PYTHONPATH", "").split(
        os.pathsep) if p])
    env.update(extra or {})
    return env


def _run_ranks(commands, envs):
    procs = [subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd, env in zip(commands, envs)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out[-4000:]}"
    return outs


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """JAX's initial parameters of the tiny SOT-2048 (as the port's state
    dict), the global batch (8 clips of the port's data module), then the
    4 ranks' blocks."""
    out_dir = str(tmp_path_factory.mktemp("torch_parallel"))
    with pytest.MonkeyPatch.context() as mp:
        for k in GATES:
            mp.delenv(k, raising=False)
        jmod = jtrainer.build_modules(_jax_config())
        jparams = jtrainer.init_state(jmod, jax.random.key(0)).params
    signals, _, _ = tdata.generate_sinusoid_dataset(seed=0, size=8, n_samples=1024,
                                                    render_batch=8, device="cpu")
    x = torch.from_numpy(tdata.peak_normalize(signals))
    params = params_from_flax(jparams)
    torch.save({"params": params, "x": x}, os.path.join(out_dir, "inputs.pt"))
    init = f"file://{os.path.join(out_dir, 'store')}"
    _run_ranks([[sys.executable, "-m", "tests._torch_parallel_worker", "cases", str(r),
                 str(WORLD), init, out_dir] for r in range(WORLD)], [_worker_env()] * WORLD)
    ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt")) for r in range(WORLD)]
    return {"jmod": jmod, "jparams": jparams, "params": params, "x": x, "ranks": ranks}


def _cat(ranks, key, members, dim):
    return torch.cat([ranks[r][key] for r in members], dim=dim).numpy()


# -- the mesh and the launch ------------------------------------------------


def test_mesh_shapes():
    mesh = make_mesh(8, freq=2, device="cpu")
    assert mesh.shape == {"data": 4, "freq": 2}
    mesh = make_mesh(8, device="cpu")
    assert mesh.shape == {"data": 8, "freq": 1}
    with pytest.raises(ValueError):
        make_mesh(8, freq=3, device="cpu")
    with pytest.raises(RuntimeError, match="layout only"):
        mesh.group("data")


def test_initialize_distributed_noop_single_process(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    # returns before it resolves the device: no GPU needed, nothing touched
    assert initialize_distributed() is False
    assert not torch.distributed.is_initialized()
    assert global_mesh(device="cpu").shape == {"data": 1, "freq": 1}


def test_two_process_launch_from_torchrun_environment(tmp_path):
    """A real 2-process Gloo launch wired from MASTER_ADDR / MASTER_PORT /
    WORLD_SIZE / RANK / LOCAL_RANK on a free port: ``global_mesh`` puts
    each process on its own data row, an all-reduce crosses them, and the
    frame-sharded STFT over the two processes equals the single-device
    STFT."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    envs = [_worker_env({"MASTER_ADDR": "localhost", "MASTER_PORT": str(port),
                         "WORLD_SIZE": "2", "RANK": str(r), "LOCAL_RANK": str(r)})
            for r in range(2)]
    outs = _run_ranks([[sys.executable, "-m", "tests._torch_parallel_worker", "env",
                        str(tmp_path)]] * 2, envs)
    for rank, out in enumerate(outs):
        assert f"LAUNCH OK rank={rank}" in out, out[-3000:]
    spec = np.concatenate([torch.load(tmp_path / f"env{r}.pt")["spec"].numpy()
                           for r in range(2)], axis=1)
    x = np.random.default_rng(0).standard_normal((2, 1024)).astype(np.float32)
    np.testing.assert_allclose(spec, stft_magnitude(torch.from_numpy(x), size=512,
                                                    overlap=0.75).numpy(), atol=1e-5)


def test_dryrun_sequence_on_four_ranks(setup):
    """The dry run's sequence on the 4 ranks' group: the sharded step on
    meshes (2, 2) and (1, 4) against the single process (loss) and the
    ranks' mean gradient computed in one process (reduced gradient,
    grad_norm), the ranks' parameters and gradients bit-equal,
    the two meshes' losses within 1e-3, the standalone ops within their
    limits (the row-sharded solve bit-equal)."""
    readings = setup["ranks"][0]["dryrun"]
    assert [m["mesh"] for m in readings["meshes"]] == [{"data": 2, "freq": 2},
                                                       {"data": 1, "freq": 4}]
    for m in readings["meshes"]:
        (step,) = m["steps"]
        assert step["ranks_bit_equal"] and step["loss_rel"] <= dryrun.LOSS_REL
        assert step["grad_rel"] <= dryrun.GRAD_REL and step["grad_norm_rel"] <= dryrun.GRAD_REL
    ops = readings["ops"]
    assert set(ops) == {"stft", "w_rel", "rows_rel", "rows_grad_rel", "rows_bit_equal",
                        "synth_max_abs"}
    assert ops["rows_bit_equal"] and ops["synth_max_abs"] <= dryrun.SYNTH_ATOL
    assert dryrun.mesh_freqs(4) == [2, 4] and dryrun.mesh_freqs(8) == [2, 4]
    assert dryrun.mesh_freqs(1) == [1] and dryrun.mesh_freqs(2) == [1, 2]
    assert dryrun.mesh_freqs(6) == [2]


def test_dryrun_one_rank_is_the_single_process_step():
    """``run(1)`` in this process over a Gloo group of one: the sharded
    step bit-equal to ``train_step`` (parameters, Adam's state, the
    generator, the logs); the group is gone afterwards."""
    readings = dryrun.run(1, device="cpu")
    assert readings["backend"] == "gloo" and readings["ranks"] == 1
    (mesh,) = readings["meshes"]
    assert mesh["mesh"] == {"data": 1, "freq": 1}
    assert mesh["steps"][0]["bit_equal"] and mesh["steps"][0]["params_max_abs"] == 0.0
    assert not torch.distributed.is_initialized()


# -- the sharded ops --------------------------------------------------------


@pytest.mark.parametrize("n_shards,size,hop", worker.STFT_CASES)
def test_frame_sharded_stft_matches_single_device(setup, n_shards, size, hop):
    sharded = _cat(setup["ranks"], f"stft/{n_shards}/{size}/{hop}", range(n_shards), 1)
    audio = worker.stft_audio()
    single = stft_magnitude(torch.from_numpy(audio), size=size, overlap=1 - hop / size).numpy()
    assert sharded.shape == single.shape
    np.testing.assert_allclose(sharded, single, atol=2e-5)
    jax_sharded = np.asarray(jax_stft_frame_sharded(
        jnp.asarray(audio), jax_make_mesh(n_shards, freq=n_shards), size=size, hop_length=hop))
    np.testing.assert_allclose(sharded, jax_sharded, atol=2e-5)


def test_frame_sharded_stft_flattop_and_grad(setup):
    spec = _cat(setup["ranks"], "flattop/spec", range(WORLD), 1)
    grad = _cat(setup["ranks"], "flattop/grad", range(WORLD), 1)
    audio = torch.from_numpy(worker.flattop_audio()).requires_grad_(True)
    single = stft_magnitude(audio, size=2048, overlap=1 - 256 / 2048, window="flattop")
    (single ** 2).sum().backward()
    np.testing.assert_allclose(float((spec.astype(np.float64) ** 2).sum()),
                               float((single.detach().double() ** 2).sum()), rtol=1e-5)
    np.testing.assert_allclose(grad, audio.grad.numpy(), atol=1e-3)


def _osc_members(n, data):
    """Rank r of an (data, n) mesh holds rows r // n, chunk r % n."""
    return [[d * n + f for f in range(n)] for d in range(data)]


@pytest.mark.parametrize("n_shards,data_rows", worker.OSC_CASES)
def test_sample_sharded_oscillator_matches_single_device(setup, n_shards, data_rows):
    ranks = setup["ranks"]
    sharded = np.concatenate([_cat(ranks, f"osc/{n_shards}/{data_rows}", row, 1)
                              for row in _osc_members(n_shards, data_rows)], axis=0)
    freqs, amps = worker.osc_inputs()
    single = oscillator_bank(torch.from_numpy(freqs), torch.from_numpy(amps), sample_rate=8000,
                             use_angular_cumsum=True).numpy()
    assert sharded.shape == single.shape
    np.testing.assert_allclose(sharded, single, atol=1.5e-3)


def test_sample_sharded_oscillator_grad(setup):
    ranks = setup["ranks"]
    audio = _cat(ranks, "osc_grad/audio", range(WORLD), 1)
    gf, ga = (_cat(ranks, k, range(WORLD), 1) for k in ("osc_grad/f", "osc_grad/a"))
    freqs, amps = (torch.from_numpy(a).requires_grad_(True) for a in worker.osc_grad_inputs())
    single = oscillator_bank(freqs, amps, use_angular_cumsum=True)
    (single ** 2).sum().backward()
    np.testing.assert_allclose(float((audio.astype(np.float64) ** 2).sum()),
                               float((single.detach().double() ** 2).sum()), rtol=1e-4)
    for got, ref in ((ga, amps.grad.numpy()), (gf, freqs.grad.numpy())):
        scale = float(np.abs(ref).max()) + 1e-9
        np.testing.assert_allclose(got / scale, ref / scale, atol=5e-3)


def _freq_row_blocks(ranks, key):
    """Rows of a (2, 2) mesh's replicated-over-'freq' output: data row d
    from rank 2 d, checked equal to its 'freq' neighbour's copy."""
    for d in range(2):
        assert torch.equal(ranks[2 * d][key], ranks[2 * d + 1][key])
    return _cat(ranks, key, (0, 2), 0)


def test_freq_sharded_wasserstein_matches_single_device(setup):
    sharded = _freq_row_blocks(setup["ranks"], "w/w")
    grid, uw, vw = worker.w_inputs()
    single = wasserstein_1d_same_grid(torch.from_numpy(grid), torch.from_numpy(uw),
                                      torch.from_numpy(vw), p=2,
                                      limit_quantile_range=True).numpy()
    hazard = np.abs(np.cumsum(vw.astype(np.float64), axis=1) - 1.0).min(axis=1) < 1e-4
    assert hazard.sum() < len(hazard), "degenerate test data: every row at the kink"
    np.testing.assert_allclose(sharded[~hazard], single[~hazard], rtol=1e-5, atol=1e-7)


def test_freq_sharded_wasserstein_grad(setup):
    ranks = setup["ranks"]
    _freq_row_blocks(ranks, "w_grad/w")
    grad = np.concatenate([_cat(ranks, "w_grad/grad_v", (2 * d, 2 * d + 1), 1)
                           for d in range(2)], axis=0)
    grid, uw, vw = worker.w_grad_inputs()
    v = torch.from_numpy(vw).requires_grad_(True)
    wasserstein_1d_same_grid(torch.from_numpy(grid), torch.from_numpy(uw), v, p=2).sum().backward()
    np.testing.assert_allclose(grad, v.grad.numpy(), atol=1e-5)


def test_row_sharded_same_grid_matches_single_device(setup):
    ranks = setup["ranks"]
    w = _cat(ranks, "rows/w", range(WORLD), 0)
    grad = _cat(ranks, "rows/grad_v", range(WORLD), 0)
    grid, uw, vw = worker.sot_rows_inputs()
    v = torch.from_numpy(vw).requires_grad_(True)
    single = wasserstein_same_grid(torch.from_numpy(grid), torch.from_numpy(uw), v, p=2.0,
                                   limit_quantile_range=True, target_constant=True)
    single.sum().backward()
    np.testing.assert_array_equal(w, single.detach().numpy())
    np.testing.assert_array_equal(grad, v.grad.numpy())


# -- the train steps and the sharded loss -----------------------------------


@pytest.fixture(scope="module")
def single_step(setup):
    """The single-process step in training mode from the same parameters on
    the same global batch."""
    mod = trainer.build_modules(dryrun.tiny_config(8), device="cpu")
    mod.encoder.load_state_dict(setup["params"])
    state = trainer.init_state(mod)
    logs = trainer.train_step(mod, state, setup["x"])
    params = list(mod.encoder.parameters())
    return {"logs": logs, "params": worker.flat(params).numpy(),
            "grads": worker.flat(p.grad for p in params).numpy()}


@pytest.mark.parametrize("freq", worker.STEP_FREQS, ids=["dp", "freq2", "freq4"])
def test_sharded_train_step_matches_single_process(setup, single_step, freq):
    """DP (mesh (4, 1)) and the freq-sharded loss step (meshes (2, 2) and
    (1, 4)) against one process on the same global batch, dropout on."""
    ranks = setup["ranks"]
    key = f"step/{freq}"
    for r in range(1, WORLD):
        assert torch.equal(ranks[r][f"{key}/params"], ranks[0][f"{key}/params"])
        assert torch.equal(ranks[r][f"{key}/grads"], ranks[0][f"{key}/grads"])
        for k, v in ranks[0][f"{key}/logs"].items():
            assert torch.equal(ranks[r][f"{key}/logs"][k], v), k
    logs, ref = ranks[0][f"{key}/logs"], single_step["logs"]
    assert set(logs) == set(ref)
    for k in ref:
        np.testing.assert_allclose(float(logs[k]), float(ref[k]),
                                   rtol=1e-3 if k == "grad_norm" else 1e-4, err_msg=k)
    grads = ranks[0][f"{key}/grads"].numpy()
    scale = float(np.abs(single_step["grads"]).max())
    np.testing.assert_allclose(grads / scale, single_step["grads"] / scale, atol=2e-3)
    np.testing.assert_allclose(ranks[0][f"{key}/params"].numpy(), single_step["params"],
                               atol=2.5e-4)
    assert ranks[0]["step/uneven_batch_raises"]


def test_sharded_eval_loss_matches_jax(setup, monkeypatch):
    """The freq-sharded loss in eval mode on the (2, 2) mesh (the mesh mean
    of the ranks' losses) against JAX's ``compute_loss`` on its
    ``shard_loss_modules`` over a (2, 2) mesh of its virtual devices, with
    the same parameters, and against the port's single-process loss."""
    for k in GATES:
        monkeypatch.delenv(k, raising=False)
    logs = setup["ranks"][0]["eval/logs"]
    for r in range(1, WORLD):
        for k, v in logs.items():
            assert torch.equal(setup["ranks"][r]["eval/logs"][k], v), k
    smod = jax_shard_loss_modules(setup["jmod"], jax_make_mesh(4, freq=2))
    jlogs = jax.jit(lambda p, x: jtrainer.compute_loss(smod, p, x)[1][0])(
        setup["jparams"], jnp.asarray(setup["x"].numpy()))
    mod = trainer.build_modules(dryrun.tiny_config(8), device="cpu")
    mod.encoder.load_state_dict(setup["params"])
    with torch.no_grad():
        _, (single, _) = trainer.compute_loss(mod, setup["x"])
    assert set(logs) == set(jlogs) == set(single)
    for k in logs:
        np.testing.assert_allclose(float(logs[k]), float(jlogs[k]), rtol=1e-4, err_msg=k)
        np.testing.assert_allclose(float(logs[k]), float(single[k]), rtol=1e-5, err_msg=k)


def test_shard_loss_modules_rebinds_the_loss_path():
    """On an STFT loss domain: the frame-sharded transform (same
    frequencies); the loss functions (the SOT rows follow the frames) and
    the encoder untouched. Any other domain: unchanged. The step refuses
    loss frames that do not divide over 'freq'."""
    mesh = make_mesh(8, freq=2, device="cpu")  # a layout: rebinding needs no group
    mod = trainer.build_modules(dryrun.tiny_config(8), device="cpu")
    smod = shard_loss_modules(mod, mesh)
    assert isinstance(smod.transform, _FrameShardedSTFT) and isinstance(mod.transform, STFT)
    np.testing.assert_array_equal(smod.transform.get_frequencies(),
                                  mod.transform.get_frequencies())
    assert smod.encoder is mod.encoder and smod.loss_fns is mod.loss_fns
    lin = trainer.build_modules(dryrun.tiny_config(8).replace(transform="identity"),
                                device="cpu")
    assert shard_loss_modules(lin, mesh) is lin
    with pytest.raises(ValueError, match="do not divide"):
        make_sharded_train_step(mod, make_mesh(3, freq=3, device="cpu"))


@pytest.mark.parametrize("freq,n_fft,hop", worker.STFT_CASES + ((2, 2048, 256),),
                         ids=lambda v: str(v))
def test_frame_sharded_transform_frames_its_chunk(freq, n_fft, hop):
    """The train step's ``_FrameShardedSTFT`` on each rank of a 'freq' axis
    (no group: it slices its halo from the clip it holds) gives that rank's
    frames of the whole clip's STFT bit for bit (``pad_end`` zeros past
    the end), the halo spanning two chunks at (4, 2048, 256); log and
    ``get_frequencies`` as the wrapped transform's."""
    inner = STFT(n_fft=n_fft, hop_length=hop, window="flattop", log=True)
    audio = torch.from_numpy(worker.stft_audio())
    want = inner(audio)
    blocks = []
    for r in range(freq):
        mesh = Mesh({"data": 1, "freq": freq}, torch.device("cpu"), rank=r, groups={})
        blocks.append(_FrameShardedSTFT(inner, mesh)(audio))
    torch.testing.assert_close(torch.cat(blocks, dim=1), want, rtol=0, atol=0)
