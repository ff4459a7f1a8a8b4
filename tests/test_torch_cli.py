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
