"""``python -m sot_tpu_torch.cli`` train -> resume -> evaluate -> analyze ->
predict on a tiny config on the CPU, mirroring ``tests/test_cli.py``, with
the outputs held to the JAX package's: the run directory's file names, the
resolved config, the log records' keys (JAX's traced by ``jax.eval_shape``,
no compile), ``analyze``'s report (``sot_tpu.analysis.pitch_error_report``
on the same pitches), ``list`` and ``generate-data``. Also the
``chip_smoke.py`` [train-run] phase at this size.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from sot_tpu import cli as jcli  # noqa: E402
from sot_tpu.analysis import pitch_error_report as jax_pitch_error_report  # noqa: E402
from sot_tpu.configs import get_experiment as jax_get_experiment  # noqa: E402
from sot_tpu.training import trainer as jtrainer  # noqa: E402
from sot_tpu_torch import cli  # noqa: E402
from sot_tpu_torch import data as tdata  # noqa: E402
from sot_tpu_torch.analysis import pitch_error_report  # noqa: E402
from sot_tpu_torch.configs import get_experiment  # noqa: E402
from sot_tpu_torch.training import checkpoint as ckpt_lib  # noqa: E402
from sot_tpu_torch.training import trainer as ttrainer  # noqa: E402

TINY_KW = dict(n_samples=1024, cqt_fmin=261.6, batch_size=8, transform_n_fft=512,
               transform_hop=128)
TINY = [a for k, v in TINY_KW.items() for a in ("--set", f"{k}={v}")] + ["--dataset-size", "32"]
CPU = ["--device", "cpu"]
RUN_FILES = ["best_metrics.json", "checkpoints", "log.jsonl", "test_metrics.json",
             "test_metrics_comb.json", "test_metrics_octcorr.json", "train_config.json"]


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("cli_run"))
    assert cli.main(["train", "--experiment", "SOT-512", "--steps", "2", "--eval-every", "2",
                     "--final-eval", "--out", out] + TINY + CPU) == 0
    return out


def _records(path):
    with open(path) as fh:
        return [json.loads(line) for line in fh]


def _jax_record_keys():
    """The keys of JAX's train and val records at TINY, from the traced
    train and eval steps (``sot_tpu/training/trainer.py:654-668``)."""
    jmod = jtrainer.build_modules(jax_get_experiment("SOT-512", **TINY_KW))
    state = jtrainer.init_state(jmod, jax.random.key(0))
    x = jnp.zeros((16, 1024), jnp.float32)
    _, logs = jax.eval_shape(jtrainer.make_train_steps_scan(jmod), state, x,
                             jnp.zeros((2,), jnp.int32), jax.random.key(1))
    metrics = jax.eval_shape(jtrainer.make_eval_step(jmod), state.params, x[:8],
                             jnp.zeros((8, 1), jnp.float32))
    return ({"split", "step", "samples_per_sec", *logs}, {"split", "step", *metrics})


def test_train_outputs_have_jax_names_and_keys(run_dir):
    assert sorted(os.listdir(run_dir)) == RUN_FILES
    assert sorted(os.listdir(os.path.join(run_dir, "checkpoints"))) == ["best-lsd", "last"]
    with open(os.path.join(run_dir, "train_config.json")) as fh:
        saved = json.load(fh)
    jcfg = jax_get_experiment("SOT-512", dataset_size=32, eval_every_steps=2, **TINY_KW)
    assert saved == json.loads(json.dumps(dataclasses.asdict(jcfg), default=str))
    train_keys, val_keys = _jax_record_keys()
    records = _records(os.path.join(run_dir, "log.jsonl"))
    assert [(r["split"], r["step"]) for r in records] == [("train", 2.0), ("val", 2.0)]
    assert set(records[0]) == train_keys and set(records[1]) == val_keys
    with open(os.path.join(run_dir, "best_metrics.json")) as fh:
        best = json.load(fh)
    assert best == {k: v for k, v in records[1].items() if k not in ("split", "step")}
    for name in ("test_metrics.json", "test_metrics_octcorr.json", "test_metrics_comb.json"):
        with open(os.path.join(run_dir, name)) as fh:
            m = json.load(fh)["test_metrics"]
        assert set(m) == val_keys - {"split", "step"}
        assert all(np.isfinite(v) for v in m.values())


def test_resume_continues(run_dir, tmp_path):
    out2 = str(tmp_path / "resumed")
    assert cli.main(["train", "--experiment", "SOT-512", "--steps", "4", "--eval-every", "4",
                     "--out", out2, "--resume",
                     os.path.join(run_dir, "checkpoints", "best-lsd")] + TINY + CPU) == 0
    records = _records(os.path.join(out2, "log.jsonl"))
    # resumed from step 2: one epoch of 2 steps, in JAX's restarted order
    assert [(r["split"], int(r["step"])) for r in records] == [("train", 4), ("val", 4)]
    assert ckpt_lib.load(os.path.join(out2, "checkpoints", "last"))["step"] == 4


def test_saved_config_round_trip_coercion():
    out = cli._coerce_saved_config("SOT-2048", {
        "evaluation_metrics": ["mse", "raw_pitch_accuracy"],
        "temperature_schedule": [1.0, 0.1, 1500], "batch_size": 8,
        "dataset_path": "/tmp/x.pth"})
    assert out == jcli._coerce_saved_config("SOT-2048", {
        "evaluation_metrics": ["mse", "raw_pitch_accuracy"],
        "temperature_schedule": [1.0, 0.1, 1500], "batch_size": 8,
        "dataset_path": "/tmp/x.pth"})
    assert out["temperature_schedule"] == (1.0, 0.1, 1500)
    with pytest.raises(ValueError, match="did not round-trip"):
        cli._coerce_saved_config("SOT-2048", {"batch_size": "64"})
    with pytest.raises(ValueError, match="not an ExperimentConfig"):
        cli._coerce_saved_config("SOT-2048", {"no_such_field": 1})


def _val_pitches(run_dir, correction=None):
    """The val split's per-frame pitch of the run's best-lsd weights."""
    tcfg = get_experiment("SOT-512", dataset_size=32, **TINY_KW)
    mod = ttrainer.build_modules(tcfg, device="cpu")
    mod.encoder.load_state_dict(ckpt_lib.encoder_state(
        os.path.join(run_dir, "checkpoints", "best-lsd")))
    split = tdata.dataset_from_config(tcfg, device="cpu")["val"]
    x = torch.from_numpy(tdata.peak_normalize(split.x))
    with torch.no_grad():
        pitch = ttrainer.forward(mod, x)["pitch_hz"]
        if correction == "comb":
            pitch, _ = ttrainer.apply_comb_correction(mod, x, pitch)
    return pitch.numpy()[:, :, 0], split.frequency[:, 0]


def test_evaluate_and_analyze(run_dir, capsys):
    best_ckpt = os.path.join(run_dir, "checkpoints", "best-lsd")
    # the config travels with the checkpoint (the run's train_config.json)
    assert cli.main(["evaluate", "--split", "val", "--ckpt", best_ckpt] + CPU) == 0
    got = json.loads(capsys.readouterr().out)["val_metrics"]
    with open(os.path.join(run_dir, "best_metrics.json")) as fh:
        best = json.load(fh)
    assert set(got) == set(best)
    for k in best:
        assert abs(got[k] - best[k]) <= 1e-5 * max(abs(best[k]), 1e-3), k

    for correction in ("none", "comb"):
        assert cli.main(["analyze", "--split", "val", "--correction", correction,
                         "--ckpt", best_ckpt] + CPU) == 0
        report = json.loads(capsys.readouterr().out)
        pitch, f0 = _val_pitches(run_dir, correction)
        assert report == json.loads(json.dumps(jax_pitch_error_report(pitch, f0)))
        assert report["clip_failures"]["n_clips"] == len(f0)


def test_pitch_error_report_is_jax_on_seeded_pitches():
    rng = np.random.default_rng(3)
    f0 = rng.uniform(40, 1950, 50)
    ratio = rng.choice([1.0, 2.0, 0.5, 1.5, 2 / 3, 3.0, 1.01], size=(50, 1))
    pitch = f0[:, None] * ratio * rng.uniform(0.99, 1.01, (50, 16))
    assert pitch_error_report(pitch, f0) == jax_pitch_error_report(pitch, f0)


def test_predict_from_a_run_checkpoint(run_dir, tmp_path):
    sig, _, _ = tdata.generate_sinusoid_dataset(seed=5, size=6, n_samples=1024,
                                                render_batch=6, device="cpu")
    inp = str(tmp_path / "audio.npy")
    np.save(inp, sig)
    outp = str(tmp_path / "pred.npz")
    assert cli.main(["predict", "--ckpt", os.path.join(run_dir, "checkpoints", "best-lsd"),
                     "--input", inp, "--output", outp,
                     "--set", "inference_comb_correction=true"] + CPU) == 0
    with np.load(outp) as z:
        assert z["pitch_hz"].shape == (6, 4) and z["weights"].shape == (6, 4, 20)
        assert np.isfinite(z["pitch_hz"]).all() and (z["pitch_hz"] > 0).all()


def test_list_prints_the_nine_presets(capsys):
    assert cli.main(["list"]) == 0
    ours = capsys.readouterr().out
    jcli.main(["list"])
    assert ours == capsys.readouterr().out
    assert len(ours.splitlines()) == 10


def test_generate_data_writes_jax_keys_and_draws(tmp_path, capsys):
    ours, ref = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    assert cli.main(["generate-data", "--out", ours, "--seed", "5", "--size", "6"] + CPU) == 0
    assert jcli.main(["generate-data", "--out", ref, "--seed", "5", "--size", "6"]) == 0
    with np.load(ours) as a, np.load(ref) as b:
        assert sorted(a.files) == sorted(b.files) == ["frequency", "signals", "weights"]
        assert {k: a[k].shape for k in a.files} == {k: b[k].shape for k in b.files}
        assert {k: a[k].dtype for k in a.files} == {k: b[k].dtype for k in b.files}
        np.testing.assert_array_equal(a["frequency"], b["frequency"])
        np.testing.assert_array_equal(a["weights"], b["weights"])


@pytest.mark.parametrize("flag", ["--figures", "--profile"])
def test_unported_train_flags_raise(flag, tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP A7"):
        cli.main(["train", flag, "--out", str(tmp_path)] + TINY + CPU)


def test_train_without_device_or_cuda_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["train", "--steps", "1", "--out", str(tmp_path)] + TINY)


def test_config_files_json_and_yaml(tmp_path, monkeypatch):
    base = tmp_path / "base.json"
    base.write_text(json.dumps({"batch_size": 4, "seed": 3}))
    master = tmp_path / "master.json"
    master.write_text(json.dumps({"configs": ["base.json"], "seed": 7}))
    assert cli._load_config_files([str(master)]) == {"batch_size": 4, "seed": 7}
    assert cli._load_config_files([str(master)]) == jcli._load_config_files([str(master)])
    monkeypatch.setitem(sys.modules, "yaml", None)
    yml = tmp_path / "over.yaml"
    yml.write_text("seed: 3\n")
    with pytest.raises(RuntimeError, match="PyYAML"):
        cli._load_config_files([str(yml)])


def test_chip_smoke_train_run_phase_on_cpu():
    """``chip_smoke.py``'s [train-run] phase at the TINY size on the CPU:
    the run's records, checkpoints, round trip, two resumes (bit-equal
    here), evaluate, predict, the probes and MSS-LogLin."""
    import chip_smoke

    chip_smoke.check_train_run(torch.device("cpu"), TINY_KW, 32)
