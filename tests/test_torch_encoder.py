"""Port encoder, pitch head, numerics and weight conversion against the JAX
package (f32 on the CPU, same parameters)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from sot_tpu.models import encoder as jenc  # noqa: E402
from sot_tpu.ops import numerics as jnum  # noqa: E402
from sot_tpu_torch.convert import (flax_tree_from_flat, params_from_flax,  # noqa: E402
                                   params_to_flax)
from sot_tpu_torch.models import encoder as tenc  # noqa: E402
from sot_tpu_torch.ops import numerics as tnum  # noqa: E402
from tests._torch_parity import jax_init_params, rel_max_err  # noqa: E402


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def params():
    return jax_init_params(seed=3)


def test_params_round_trip_exactly(params):
    sd = params_from_flax(params)
    back = _leaves(params_to_flax(sd))
    orig = _leaves(params)
    assert back.keys() == orig.keys()
    for k in orig:
        assert back[k].dtype == orig[k].dtype, k
        np.testing.assert_array_equal(back[k], orig[k], err_msg=k)
    # the converted dict is exactly the encoder's state (keys and shapes)
    model = tenc.PESTOEncoder()
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == {
        k: tuple(v.shape) for k, v in sd.items()}
    assert sum(v.numel() for v in sd.values()) == sum(p.numel() for p in model.parameters())
    # flattened .npz-style keys rebuild the same tree
    flat = {k[1:]: v for k, v in orig.items()}  # "params/conv1/Conv_0/kernel", ...
    rebuilt = _leaves(flax_tree_from_flat(flat))
    assert rebuilt.keys() == orig.keys()
    for k in orig:
        np.testing.assert_array_equal(rebuilt[k], orig[k])


def test_parameter_count_and_default_init():
    g = torch.Generator().manual_seed(0)
    model = tenc.PESTOEncoder(generator=g)
    n = sum(p.numel() for p in model.parameters())
    assert 45_000 < n < 47_000
    bound = 1.0 / np.sqrt(15 * 40)
    w = model.prefilt[0].weight.detach().numpy()
    assert np.abs(w).max() <= bound and np.abs(w).max() > 0.9 * bound
    again = tenc.PESTOEncoder(generator=torch.Generator().manual_seed(0))
    for a, b in zip(model.parameters(), again.parameters()):
        assert torch.equal(a, b)


def test_encoder_matches_jax(params):
    rng = np.random.default_rng(0)
    feats = np.abs(rng.standard_normal((12, 285))).astype(np.float32)
    ref = jenc.PESTOEncoder(n_bins_in=285, output_size=285, n_modes=20).apply(
        jax.tree.map(jnp.asarray, params), jnp.asarray(feats), train=False)
    model = tenc.PESTOEncoder().eval()
    model.load_state_dict(params_from_flax(params))
    with torch.no_grad():
        got = model(torch.from_numpy(feats))
    for key in ("frequency", "weights"):
        assert got[key].shape == ref[key].shape
        assert rel_max_err(got[key].numpy(), ref[key]) <= 1e-4, key


@pytest.mark.parametrize("estimation_type",
                         ["soft-argmax", "kernel-soft-argmax", "regression"])
def test_predict_pitch_matches_jax(estimation_type):
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((10, 285)).astype(np.float32)
    ref = jenc.predict_pitch(jnp.asarray(logits), estimation_type=estimation_type,
                             temperature=0.1)
    got = tenc.predict_pitch(torch.from_numpy(logits), estimation_type=estimation_type,
                             temperature=0.1)
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].shape == ref[k].shape, k
        assert rel_max_err(got[k].numpy(), ref[k]) <= 1e-4, k


def test_soft_argmax_mask_matches_jax():
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((6, 285)).astype(np.float32)
    mask = (rng.uniform(size=(6, 285)) > 0.3).astype(np.float32)
    ref = jenc.predict_pitch(jnp.asarray(logits), temperature=0.5, mask=jnp.asarray(mask))
    got = tenc.predict_pitch(torch.from_numpy(logits), temperature=0.5,
                             mask=torch.from_numpy(mask))
    assert rel_max_err(got["pitch_unit"].numpy(), ref["pitch_unit"]) <= 1e-4


def test_pitch_maps_and_nonlinearities_match_jax():
    rng = np.random.default_rng(3)
    hz = rng.uniform(20.0, 8000.0, 64).astype(np.float32)
    unit = rng.uniform(0.0, 1.0, 64).astype(np.float32)
    x = rng.standard_normal(64).astype(np.float32)
    pairs = [
        (tnum.hz_to_unit(torch.from_numpy(hz), 32.7, 7902.1),
         jnum.hz_to_unit(jnp.asarray(hz), 32.7, 7902.1)),
        (tnum.unit_to_hz(torch.from_numpy(unit), 32.7, 7902.1),
         jnum.unit_to_hz(jnp.asarray(unit), 32.7, 7902.1)),
        (tnum.hz_to_midi(torch.from_numpy(hz)), jnum.hz_to_midi(jnp.asarray(hz))),
        (tnum.exp_sigmoid(torch.from_numpy(x)), jnum.exp_sigmoid(jnp.asarray(x))),
        (tnum.safe_log(torch.from_numpy(np.abs(x) * 1e-5)),
         jnum.safe_log(jnp.asarray(np.abs(x) * 1e-5))),
        (tnum.safe_divide(torch.from_numpy(x), torch.from_numpy(np.abs(x) * 1e-7)),
         jnum.safe_divide(jnp.asarray(x), jnp.asarray(np.abs(x) * 1e-7))),
    ]
    for got, ref in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-6, atol=1e-6)
    assert tnum.get_cqt_n_bins(16000, 32.7, 3) == jnum.get_cqt_n_bins(16000, 32.7, 3) == 285
