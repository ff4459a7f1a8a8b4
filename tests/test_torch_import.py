"""The reference-checkpoint import of the port (``sot_tpu_torch/models/
import_torch.py``) against the JAX package's (``sot_tpu/models/
import_torch.py``): a reference-layout state dict at full width (the
SOT-2048 encoder, ~46K parameters), drawn from a numpy seed, goes through
JAX's ``import_encoder_params`` then ``convert.params_from_flax``, and
through the port's ``import_encoder_state``; every tensor bit-equal, and
``predict`` on both sides within ``test_torch_predict.py``'s limits. The
``encoder.`` prefix, a Lightning file with extra entries, a missing key and
a wrong shape, on both sides."""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from sot_tpu.models import import_torch as jimport  # noqa: E402
from sot_tpu_torch.configs import get_experiment  # noqa: E402
from sot_tpu_torch.convert import params_from_flax  # noqa: E402
from sot_tpu_torch.models import import_torch as timport  # noqa: E402
from sot_tpu_torch.models.encoder import PESTOEncoder  # noqa: E402
from sot_tpu_torch.training import trainer as ttrainer  # noqa: E402
from tests._torch_parity import reference_layout  # noqa: E402
from tests.test_torch_predict import _check_outputs  # noqa: E402


@pytest.fixture(scope="module")
def imported():
    """The seeded reference state dict, a flax template of JAX's encoder
    (the SOT-2048 widths, its defaults) and JAX's import of it, made once
    for the module."""
    from sot_tpu.models.encoder import PESTOEncoder as JaxEncoder

    ref = reference_layout(seed=21)
    template = JaxEncoder().init(jax.random.key(3), jnp.zeros((2, 285)))
    return ref, template, jimport.import_encoder_params(template, ref)


def _assert_same(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == torch.float32, k
        assert torch.equal(got[k], want[k]), k


def test_import_equals_jax_bit_for_bit(imported):
    ref, _, jax_params = imported
    want = params_from_flax(jax.tree.map(np.asarray, jax_params))
    encoder = PESTOEncoder()
    got = timport.import_encoder_state(encoder, ref)
    _assert_same(got, want)
    assert sum(v.numel() for v in got.values()) == 46012
    encoder.load_state_dict(got)  # strict: every key, every shape
    # the encoder. prefix of a LightningModule's state dict is dropped
    _assert_same(timport.import_encoder_state(encoder, reference_layout(seed=21,
                                                                        prefix="encoder.")),
                 want)


def test_predict_with_imported_weights_matches_jax(imported, monkeypatch):
    from sot_tpu import data as jdata
    from sot_tpu.configs import get_experiment as jax_get_experiment
    from sot_tpu.training import trainer as jtrainer

    for gate in ("SOT_TPU_CQT_PALLAS", "SOT_TPU_SYNTH_PALLAS", "SOT_TPU_CONV_BF16"):
        monkeypatch.delenv(gate, raising=False)
    ref, _, jax_params = imported
    signals, _, _ = jdata.generate_sinusoid_dataset(seed=12, size=4, render_batch=4)
    x = jdata.peak_normalize(signals).astype(np.float32)
    jmod = jtrainer.build_modules(jax_get_experiment("SOT-2048"))
    want = {k: np.asarray(v) for k, v in jtrainer.predict(jmod, jax_params,
                                                          jnp.asarray(x)).items()}
    mod = ttrainer.build_modules(get_experiment("SOT-2048"), device="cpu")
    mod.encoder.load_state_dict(timport.import_encoder_state(mod.encoder, ref))
    got = {k: v.numpy() for k, v in ttrainer.predict(mod, x).items()}
    _check_outputs(got, want)


def test_lightning_file_with_extra_entries(imported, tmp_path):
    ref, _, jax_params = imported
    blob = {"state_dict": {k: torch.from_numpy(v) for k, v in
                           reference_layout(seed=21, prefix="encoder.").items()},
            "epoch": 3, "global_step": 1234, "optimizer_states": [{"step": torch.tensor(5)}]}
    blob["state_dict"]["encoder.unused.buffer"] = torch.zeros(3)  # ignored, as in JAX
    path = tmp_path / "reference.ckpt"
    torch.save(blob, path)
    sd = timport.load_reference_state_dict(str(path))
    assert set(sd) == set(blob["state_dict"])
    want = params_from_flax(jax.tree.map(
        np.asarray, jimport.load_from_reference_ckpt(imported[1], str(path))))
    _assert_same(timport.load_from_reference_ckpt(PESTOEncoder(), str(path)), want)
    _assert_same(want, params_from_flax(jax.tree.map(np.asarray, jax_params)))


@pytest.mark.parametrize("name", ["conv4.3.bias", "linear.frequency.0.weight", "layernorm.weight"])
def test_missing_key_raises_key_error(imported, name):
    ref = dict(imported[0])
    del ref[name]
    with pytest.raises(KeyError):
        jimport.import_encoder_params(imported[1], ref)
    with pytest.raises(KeyError, match=name):
        timport.import_encoder_state(PESTOEncoder(), ref)


@pytest.mark.parametrize("name,shape", [("prefilt_list.0.0.weight", (40, 40, 13)),
                                        ("linear.frequency.0.weight", (1139,)),
                                        ("layernorm.bias", (285, 1)),
                                        ("linear.weights.0.weight", (855, 20))])
def test_wrong_shape_raises_value_error(imported, name, shape):
    ref = dict(imported[0])
    ref[name] = np.zeros(shape, np.float32)
    with pytest.raises(ValueError):
        jimport.import_encoder_params(imported[1], ref)
    with pytest.raises(ValueError, match=name):
        timport.import_encoder_state(PESTOEncoder(), ref)
