"""``python -m sot_tpu_torch.cli predict`` on the CPU."""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from sot_tpu_torch import cli
from sot_tpu_torch.models.encoder import PESTOEncoder

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture()
def ckpt_and_clips(tmp_path):
    ckpt = tmp_path / "encoder.pt"
    torch.save(PESTOEncoder(generator=torch.Generator().manual_seed(0)).state_dict(), ckpt)
    rng = np.random.default_rng(0)
    t = np.arange(4096) / 16000.0
    clips = np.sin(2 * np.pi * rng.uniform(80, 800, (3, 1)) * t).astype(np.float32)
    np.save(tmp_path / "clips.npy", clips)
    return ckpt, tmp_path / "clips.npy"


def test_cli_predict_writes_npz(tmp_path, ckpt_and_clips):
    ckpt, clips = ckpt_and_clips
    out = tmp_path / "out" / "preds.npz"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run(
        [sys.executable, "-m", "sot_tpu_torch.cli", "predict", "--ckpt", str(ckpt),
         "--input", str(clips), "--output", str(out), "--device", "cpu",
         "--set", "batch_size=2"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    with np.load(out) as z:
        shapes = {k: z[k].shape for k in z.files}
        assert np.isfinite(z["pitch_hz"]).all()
    assert shapes == {"pitch_hz": (3, 16), "pitch_unit": (3, 16), "weights": (3, 16, 20)}


def test_cli_predict_prints_json(capsys, ckpt_and_clips):
    ckpt, clips = ckpt_and_clips
    assert cli.main(["predict", "--ckpt", str(ckpt), "--input", str(clips),
                     "--device", "cpu"]) == 0
    import json

    pitch = np.asarray(json.loads(capsys.readouterr().out)["pitch_hz"])
    assert pitch.shape == (3, 16) and (pitch > 0).all()


def test_cli_predict_without_device_or_cuda_raises(monkeypatch, ckpt_and_clips):
    ckpt, clips = ckpt_and_clips
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["predict", "--ckpt", str(ckpt), "--input", str(clips)])


def _reference_ckpt(tmp_path, n_bins: int = 285) -> str:
    """A reference Lightning checkpoint ('encoder.' prefix, a state_dict
    entry and extra entries) with seeded weights."""
    from tests._torch_parity import reference_layout

    path = str(tmp_path / f"reference-{n_bins}.ckpt")
    sd = {k: torch.from_numpy(v) for k, v in reference_layout(seed=5, n_bins=n_bins,
                                                               prefix="encoder.").items()}
    torch.save({"state_dict": sd, "epoch": 11, "global_step": 4321}, path)
    return path


def _imported(cfg, path):
    from sot_tpu_torch.models.import_torch import load_from_reference_ckpt
    from sot_tpu_torch.training import trainer

    mod = trainer.build_modules(cfg, device="cpu")
    mod.encoder.load_state_dict(load_from_reference_ckpt(mod.encoder, path))
    return mod


def test_cli_predict_takes_a_reference_checkpoint(tmp_path):
    from sot_tpu_torch import data as tdata
    from sot_tpu_torch.configs import get_experiment
    from sot_tpu_torch.training import trainer

    ckpt = _reference_ckpt(tmp_path)
    sig, _, _ = tdata.generate_sinusoid_dataset(seed=6, size=16, render_batch=16, device="cpu")
    x = tdata.peak_normalize(sig).astype(np.float32)
    np.save(tmp_path / "clips.npy", x)
    out = str(tmp_path / "preds.npz")
    assert cli.main(["predict", "--ckpt", ckpt, "--input", str(tmp_path / "clips.npy"),
                     "--output", out, "--no-normalize", "--set", "batch_size=16",
                     "--device", "cpu"]) == 0
    want = trainer.predict(_imported(get_experiment("SOT-2048", batch_size=16), ckpt), x)
    with np.load(out) as z:
        np.testing.assert_array_equal(z["pitch_hz"], want["pitch_hz"].numpy()[..., 0])
        np.testing.assert_array_equal(z["pitch_unit"], want["pitch_unit"].numpy()[..., 0])
        np.testing.assert_array_equal(z["weights"], want["weights"].numpy())


TINY_KW = dict(n_samples=1024, cqt_fmin=261.6, batch_size=8, transform_n_fft=512,
               transform_hop=128, dataset_size=32)


def test_cli_evaluate_and_analyze_take_a_reference_checkpoint(tmp_path, capsys):
    import json

    from sot_tpu_torch import data as tdata
    from sot_tpu_torch.analysis import pitch_error_report
    from sot_tpu_torch.configs import get_experiment
    from sot_tpu_torch.training import trainer

    cfg = get_experiment("SOT-512", **TINY_KW)
    ckpt = _reference_ckpt(tmp_path, trainer.build_modules(cfg, device="cpu").encoder.n_bins_in)
    mod = _imported(cfg, ckpt)
    flags = (["--experiment", "SOT-512", "--split", "val", "--ckpt", ckpt, "--device", "cpu",
              "--dataset-size", "32"]
             + [a for k, v in TINY_KW.items() if k != "dataset_size"
                for a in ("--set", f"{k}={v}")])
    split = tdata.dataset_from_config(cfg, device="cpu")["val"]

    assert cli.main(["evaluate"] + flags) == 0
    got = json.loads(capsys.readouterr().out)["val_metrics"]
    assert got == trainer.evaluate(mod, trainer.make_eval_step(mod), split, cfg.batch_size)

    assert cli.main(["analyze"] + flags) == 0
    report = json.loads(capsys.readouterr().out)
    with torch.no_grad():
        pitch = trainer.forward(mod, torch.from_numpy(split.x))["pitch_hz"].numpy()[:, :, 0]
    assert report == json.loads(json.dumps(pitch_error_report(pitch, split.frequency[:, 0])))
