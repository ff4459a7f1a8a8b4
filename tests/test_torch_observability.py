"""The port's figure gallery (``sot_tpu_torch/training/observability.py``,
``trainer.make_viz_step``, ``train(figure_dir=...)``, ``cli train
--figures``) against the JAX package's, on the CPU.

  * ``FigureLogger`` writes the JAX package's file set for the same
    outputs (the gallery and the quantile figure), writes nothing when
    disabled, and raises naming matplotlib when it cannot import it
  * ``make_viz_step`` with the SOT-2048 seed-42 weights on two clips of the
    predict golden against JAX's: the same keys and shapes, x equal, the
    spectra and the probabilities within max|d| <= 1e-3 * max|ref| (the
    predict golden's limit: float32 CQT, conv stack and FFTs in two
    libraries; pitch_hz per element within 1e-3 relative), x_hat within the
    synth's limits (max|d| <= 2e-2, correlation > 0.9999)
  * a tiny ``train(figure_dir=...)`` writes the gallery of each evaluation,
    and ``chip_smoke.py``'s [figures] phase at a tiny size runs ``cli train
    --figures`` (the JAX package's file names)
"""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("matplotlib")
import jax.numpy as jnp  # noqa: E402

from sot_tpu.configs import get_experiment as jax_get_experiment  # noqa: E402
from sot_tpu.training import observability as jobs  # noqa: E402
from sot_tpu.training import trainer as jtrainer  # noqa: E402
from sot_tpu_torch.configs import get_experiment  # noqa: E402
from sot_tpu_torch.convert import flax_tree_from_flat, params_from_flax  # noqa: E402
from sot_tpu_torch.training import observability as tobs  # noqa: E402
from sot_tpu_torch.training import trainer as ttrainer  # noqa: E402
from tests import _torch_golden  # noqa: E402
from tests._torch_parity import corr, rel_max_err  # noqa: E402

TINY_KW = dict(n_samples=1024, cqt_fmin=261.6, batch_size=8, transform_n_fft=512,
               transform_hop=128)


def _tree(root: str):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def _outputs(seed: int = 0):
    rng = np.random.default_rng(seed)
    return {"x": rng.uniform(-1, 1, (2, 1024)).astype(np.float32),
            "x_hat": rng.uniform(-1, 1, (2, 1024)).astype(np.float32),
            "spec_x": rng.uniform(0, 1, (2, 9, 65)).astype(np.float32),
            "spec_x_hat": rng.uniform(0, 1, (2, 9, 65)).astype(np.float32),
            "probabilities": rng.uniform(0, 1, (2, 60)).astype(np.float32),
            "true_frequency_unit": np.array([0.4], np.float32),
            "gain": rng.uniform(0, 1, (2, 9)).astype(np.float32),
            "loudness": rng.uniform(0, 1, (2, 9)).astype(np.float32)}


def _draw(module, out_dir, step=3):
    outs = _outputs()
    logger = module.FigureLogger(out_dir)
    logger.plot_and_log(step, "val", outs,
                        transform_frequencies=np.linspace(0, 8000, 65, dtype=np.float32),
                        feature_frequencies=np.geomspace(30, 4000, 60).astype(np.float32))
    q = np.linspace(0, 1, 20, dtype=np.float32)
    logger.log_quantiles(step, "val", q[None], np.sort(np.random.default_rng(1).uniform(
        0, 1, (1, 20))), q[None] ** 2)
    return logger


def test_figure_logger_writes_jax_files(tmp_path):
    _draw(jobs, str(tmp_path / "jax"))
    _draw(tobs, str(tmp_path / "port"))
    got, ref = _tree(str(tmp_path / "port")), _tree(str(tmp_path / "jax"))
    assert got == ref
    assert "figures/step3/Signal_val_Quantile_Functions.png" in got
    assert "figures/step3/Signal_val_Loudness.png" in got


def test_figure_logger_disabled_writes_nothing(tmp_path):
    assert not tobs.FigureLogger(None).enabled
    logger = tobs.FigureLogger(str(tmp_path), enabled=False)
    assert not logger.enabled
    logger.plot_and_log(1, "val", _outputs())
    logger.log_quantiles(1, "val", np.zeros(3), np.zeros(3), np.zeros(3))
    assert os.listdir(tmp_path) == []


def test_figure_logger_without_matplotlib_names_it(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # import raises ImportError
    with pytest.raises(RuntimeError, match="matplotlib"):
        tobs.FigureLogger(str(tmp_path))
    tobs.FigureLogger(None)  # disabled: never imports it
    with pytest.raises(RuntimeError, match="matplotlib"):
        ttrainer.train(get_experiment("SOT-512", **TINY_KW, dataset_size=32), max_steps=1,
                       figure_dir=str(tmp_path), device="cpu")


def test_make_viz_step_matches_jax(monkeypatch):
    for k in ("SOT_TPU_W2_MERGE", "SOT_TPU_SYNTH_PALLAS", "SOT_TPU_CQT_PALLAS",
              "SOT_TPU_CONV_BF16", "SOT_TPU_STFT_PALLAS"):
        monkeypatch.delenv(k, raising=False)
    with np.load(_torch_golden.GOLDEN) as z:
        params = flax_tree_from_flat({k: z[k] for k in z.files if k.startswith("params/")})
        x = z["x"][:2]
    mod = ttrainer.build_modules(get_experiment("SOT-2048"), device="cpu")
    mod.encoder.load_state_dict(params_from_flax(params))
    got = {k: v.numpy() for k, v in ttrainer.make_viz_step(mod)(torch.from_numpy(x)).items()}
    jmod = jtrainer.build_modules(jax_get_experiment("SOT-2048"))
    ref = {k: np.asarray(v) for k, v in jtrainer.make_viz_step(jmod)(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x)).items()}
    assert sorted(got) == sorted(ref)  # jit returns the dict sorted by key
    assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in ref.items()}
    np.testing.assert_array_equal(got["x"], ref["x"])
    assert float(np.max(np.abs(got["pitch_hz"] - ref["pitch_hz"]) / ref["pitch_hz"])) <= 1e-3
    for k in ("spec_x", "spec_x_hat", "probabilities"):
        assert rel_max_err(got[k], ref[k]) <= 1e-3, k
    # the synth's own limits: the phases of ~1e4 rad summed in float64 here,
    # in f32 blocks there
    assert np.abs(got["x_hat"] - ref["x_hat"]).max() <= 2e-2
    assert corr(got["x_hat"], ref["x_hat"]) > 0.9999


def test_train_with_figure_dir_writes_the_gallery(tmp_path):
    import chip_smoke

    cfg = get_experiment("SOT-512", **TINY_KW, dataset_size=24, eval_every_steps=2)
    ttrainer.train(cfg, max_steps=4, figure_dir=str(tmp_path), device="cpu")
    assert sorted(os.listdir(tmp_path / "figures")) == ["step2", "step4"]
    for step in ("step2", "step4"):
        assert sorted(os.listdir(tmp_path / "figures" / step)) == sorted(chip_smoke.FIGURE_FILES)


def test_gallery_names_are_jax_names(tmp_path):
    """``chip_smoke.FIGURE_FILES`` (the names the card's [figures] phase
    requires) are the files JAX's ``FigureLogger`` writes for one
    evaluation of a Wasserstein model: the gallery and the quantile
    figure, without gain and loudness."""
    import chip_smoke

    outs = {k: v for k, v in _outputs().items() if k not in ("gain", "loudness")}
    logger = jobs.FigureLogger(str(tmp_path))
    logger.plot_and_log(1, "val", outs)
    logger.log_quantiles(1, "val", np.linspace(0, 1, 5), np.zeros(5), np.ones(5))
    assert sorted(os.listdir(tmp_path / "figures" / "step1")) == sorted(chip_smoke.FIGURE_FILES)


def test_chip_smoke_figures_phase_on_cpu():
    """``chip_smoke.py``'s [figures] phase at a tiny size on the CPU: ``cli
    train --figures`` writes the JAX package's files (the viz step's golden
    comparison needs the full width, which
    ``test_make_viz_step_matches_jax`` covers against JAX)."""
    import chip_smoke

    chip_smoke.check_figures(torch.device("cpu"), TINY_KW, 32)
