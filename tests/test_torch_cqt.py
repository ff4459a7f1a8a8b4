"""Port CQT (sot_tpu_torch.ops.cqt) against the JAX package's CQT."""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from sot_tpu.ops import cqt as jcqt  # noqa: E402
from sot_tpu_torch.features import CQT as TorchCQT  # noqa: E402
from sot_tpu_torch.ops import cqt as tcqt  # noqa: E402
from tests._torch_parity import rel_max_err, tone_batch  # noqa: E402


def test_kernel_bank_exactly_equal():
    j = jcqt.build_cqt_kernels(16000, 32.7, 285, 36)
    t = tcqt.build_cqt_kernels(16000, 32.7, 285, 36)
    for a, b in zip(j, t):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(tcqt.cqt_frequencies(), jcqt.cqt_frequencies())


def test_device_bank_layout():
    bank = tcqt.cqt_bank(16000, 32.7, 285, 36, 1.0, torch.device("cpu")).numpy()
    k_real, k_imag, _, width, _ = tcqt.build_cqt_kernels(16000, 32.7, 285, 36)
    assert bank.shape == (width, 640)
    np.testing.assert_array_equal(bank[:, :285], k_real)
    np.testing.assert_array_equal(bank[:, 285:570], k_imag)
    assert not bank[:, 570:].any()


def test_cqt_magnitude_matches_jax_f32(monkeypatch):
    """f32 against f32 (32768-term sums in another order): max|d|/max <= 1e-4."""
    monkeypatch.delenv("SOT_TPU_CQT_PALLAS", raising=False)
    x = tone_batch(2, seed=1)
    ref = np.asarray(jcqt.cqt_magnitude(jnp.asarray(x), n_bins=285, hop_length=256))
    got = tcqt.cqt_magnitude(torch.from_numpy(x), n_bins=285, hop_length=256).numpy()
    assert got.shape == ref.shape == (2, 16, 285)
    assert rel_max_err(got, ref) <= 1e-4


def test_cqt_matches_pallas_kernel_in_interpret_mode(monkeypatch):
    """The TPU kernel casts its operands to bf16; the port stays f32. The
    JAX package holds its own kernel to the f32 path within 8e-3."""
    monkeypatch.setenv("SOT_TPU_CQT_PALLAS", "1")
    monkeypatch.setenv("SOT_TPU_PALLAS_INTERPRET", "1")
    x = tone_batch(8, seed=3)
    assert jcqt._use_pallas_cqt(8, 32768, 256, 16)
    ref = np.asarray(jcqt.cqt_magnitude(jnp.asarray(x), n_bins=285, hop_length=256))
    got = tcqt.cqt_magnitude(torch.from_numpy(x), n_bins=285, hop_length=256).numpy()
    assert rel_max_err(got, ref) <= 8e-3


@pytest.mark.parametrize("log,reduce", [(False, False), (True, False), (True, True)])
def test_feature_extractor_matches_jax(monkeypatch, log, reduce):
    from sot_tpu.features import CQT as JaxCQT

    monkeypatch.delenv("SOT_TPU_CQT_PALLAS", raising=False)
    x = tone_batch(2, n_samples=2048, seed=4)
    ref = np.asarray(JaxCQT(log=log)(jnp.asarray(x), reduce=reduce))
    got = TorchCQT(log=log)(torch.from_numpy(x), reduce=reduce).numpy()
    assert got.shape == ref.shape
    if log:
        # 20*log amplifies f32 noise in near-silent bins without bound:
        # compare the magnitudes the logs encode
        got, ref = np.exp(got / 20.0), np.exp(np.asarray(ref, np.float64) / 20.0)
    assert rel_max_err(got, ref) <= 1e-4
    np.testing.assert_array_equal(TorchCQT().get_frequencies(), JaxCQT().get_frequencies())


def test_complex_abs_gradient_is_zero_at_zero():
    from sot_tpu_torch.ops.stft import _complex_abs

    re = torch.tensor([0.0, 3.0], requires_grad=True)
    im = torch.tensor([0.0, 4.0], requires_grad=True)
    _complex_abs(re, im).sum().backward()
    np.testing.assert_allclose(re.grad.numpy(), [0.0, 0.6], rtol=1e-6)
    np.testing.assert_allclose(im.grad.numpy(), [0.0, 0.8], rtol=1e-6)
