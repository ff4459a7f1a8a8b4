"""The serving slice as a whole: the port's build_modules + predict against
``sot_tpu.training.trainer.predict`` with the same parameters, and against
the golden file of the trained SOT-2048 seed-42 checkpoint."""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
from sot_tpu_torch import metrics as tmetrics  # noqa: E402
from sot_tpu_torch.configs import get_experiment  # noqa: E402
from sot_tpu_torch.convert import flax_tree_from_flat, params_from_flax  # noqa: E402
from sot_tpu_torch.training import trainer as ttrainer  # noqa: E402
from tests import _torch_golden  # noqa: E402
from tests._torch_parity import corr, jax_init_params, rel_max_err  # noqa: E402


def _port(params, cfg_name="SOT-2048", **overrides):
    mod = ttrainer.build_modules(get_experiment(cfg_name, **overrides), device="cpu")
    mod.encoder.load_state_dict(params_from_flax(params))
    return mod


def _check_outputs(got, ref, x_hat=True):
    for k in ("pitch_hz", "pitch_unit"):
        assert got[k].shape == ref[k].shape, k
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, err_msg=k)
    assert got["weights"].shape == ref["weights"].shape
    assert rel_max_err(got["weights"], ref["weights"]) <= 1e-4
    if x_hat:
        np.testing.assert_allclose(got["x_hat"], ref["x_hat"], atol=2e-2)
        assert corr(got["x_hat"], ref["x_hat"]) > 0.9999


def test_predict_matches_jax_at_full_width(monkeypatch):
    from sot_tpu import data as jdata
    from sot_tpu.configs import get_experiment as jax_get_experiment
    from sot_tpu.training import trainer as jtrainer

    for gate in ("SOT_TPU_CQT_PALLAS", "SOT_TPU_SYNTH_PALLAS", "SOT_TPU_CONV_BF16"):
        monkeypatch.delenv(gate, raising=False)
    params = jax_init_params(seed=3)
    signals, _, _ = jdata.generate_sinusoid_dataset(seed=11, size=4, render_batch=4)
    x = jdata.peak_normalize(signals).astype(np.float32)

    jmod = jtrainer.build_modules(jax_get_experiment("SOT-2048"))
    ref = jtrainer.predict(jmod, jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    ref = {k: np.asarray(v) for k, v in ref.items()}
    mod = _port(params)
    assert (mod.freq_hz_min, mod.freq_hz_max) == (jmod.freq_hz_min, jmod.freq_hz_max)
    got = {k: v.numpy() for k, v in ttrainer.predict(mod, x).items()}
    assert set(got) == set(ref)
    assert got["x_hat"].shape == (4, 4096) and got["weights"].shape == (4, 16, 20)
    _check_outputs(got, ref)
    assert rel_max_err(got["frequency_logits"], ref["frequency_logits"]) <= 1e-4


@pytest.fixture(scope="module")
def golden():
    with np.load(_torch_golden.GOLDEN) as z:
        return {k: z[k] for k in z.files}


def test_golden_params_equal_a_fresh_restore(golden):
    params, step = _torch_golden.restore_params()
    flat = _torch_golden.flatten(params["params"])
    assert int(golden["step"]) == step
    assert set(flat) == {k for k in golden if k.startswith("params/")}
    for k, v in flat.items():
        np.testing.assert_array_equal(golden[k], v, err_msg=k)


def test_port_reproduces_golden_outputs_on_cpu(golden):
    mod = _port(flax_tree_from_flat(golden))
    out = {k: v.numpy() for k, v in ttrainer.predict(mod, golden["x"]).items()}
    _check_outputs(out, golden, x_hat=False)

    def share(pitch):  # frames within 50 cents of the true f0
        cents = 1200.0 * np.abs(np.log2(pitch / golden["f0"][:, None, :]))
        return float((cents < 50.0).mean())

    assert abs(share(out["pitch_hz"]) - share(golden["pitch_hz"])) <= 1.0 / 1024


def test_golden_file_is_small_and_complete(golden):
    assert os.path.getsize(_torch_golden.GOLDEN) < 2 * 1024 * 1024
    assert golden["x"].shape == (64, 4096) and golden["f0"].shape == (64, 1)
    assert golden["pitch_hz"].shape == (64, 16, 1) and golden["weights"].shape == (64, 16, 20)
    peak = np.abs(golden["x"]).max(axis=-1)
    np.testing.assert_allclose(peak, 0.9, rtol=1e-5)


def test_serving_entry_without_device_or_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrainer.build_modules(get_experiment("SOT-2048"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrainer.build_modules(get_experiment("SOT-2048"), device="cuda")


@pytest.mark.parametrize("override", [{"inference_octave_correction": True},
                                      {"inference_comb_correction": True}])
def test_inference_corrections_are_not_ported_yet(override):
    """Ported now (ROADMAP A1): ``predict`` rewrites the pitch it returns by
    the correction's clip factors, and the pitch units with it."""
    cfg = get_experiment("SOT-2048", **override)
    mod, base = (ttrainer.build_modules(c, device="cpu") for c in (cfg, get_experiment("SOT-2048")))
    for m in (mod, base):
        chip_smoke.load_golden_weights(m)
    with np.load(chip_smoke.GOLDEN) as z:
        x = torch.from_numpy(z["x"][:16])
    out, plain = ttrainer.predict(mod, x), ttrainer.predict(base, x)
    kwargs = ttrainer.correction_kwargs(mod)
    factors = (tmetrics.comb_factors(x, plain["pitch_hz"], margin=cfg.comb_correction_margin,
                                     **kwargs)
               if cfg.inference_comb_correction else
               tmetrics.octave_factors(x, plain["pitch_hz"], **kwargs))[0]
    assert torch.equal(out["pitch_hz"], plain["pitch_hz"] * factors[:, None, None])
    assert torch.equal(out["pitch_unit"], ttrainer.hz_to_unit(out["pitch_hz"], mod.freq_hz_min,
                                                              mod.freq_hz_max))
    assert torch.equal(out["weights"], plain["weights"])
