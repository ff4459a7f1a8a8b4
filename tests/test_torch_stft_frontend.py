"""Kernel B9 (the fused STFT frontend: pad_end framing, window, real-DFT
projection) against ``sot_tpu.ops.pallas.stft``: the windowed basis, the
projection's plain version and its gradient against
``stft_frontend_projection`` (interpret mode, as the JAX package's own tests
run it), and ``stft_magnitude(frontend=True)`` against the JAX package's
under ``SOT_TPU_STFT_PALLAS=1``, at small shapes that engage the frontend
(hop 128, T = 1024).

Tolerances: the basis bit for bit (the same numpy arithmetic); the
projection, the magnitudes and the audio gradients within 1e-5 of their max
(f32 sums over n_fft taps in another order; JAX's matmul at HIGHEST).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from sot_tpu.ops import stft as jstft  # noqa: E402
from sot_tpu.ops.pallas import stft as jpstft  # noqa: E402
from sot_tpu_torch.ops import stft as tstft  # noqa: E402
from sot_tpu_torch.ops.kernels import stft as kstft  # noqa: E402
from sot_tpu_torch.ops.windows import get_window, hann_window  # noqa: E402
from test_torch_plane import _assert_close  # noqa: E402

# (n_fft, hop, window): the loss STFT's kind (flattop) and the MSS's (hann)
CASES = [(512, 128, "flattop"), (256, 128, "hann")]


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setenv("SOT_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("SOT_TPU_STFT_PALLAS", "1")


def _window(name, n):
    return get_window(name, n) if name != "hann" else hann_window(n)


def _audio(batch=3, t=1024, seed=0):
    return np.random.default_rng(seed).uniform(-0.9, 0.9, (batch, t)).astype(np.float32)


@pytest.mark.parametrize("n_fft,hop,window", CASES)
def test_frontend_projection_and_gradient_match_jax(n_fft, hop, window):
    win = _window(window, n_fft)
    n_cols = 2 * (n_fft // 2 + 1)
    basis = kstft._windowed_dft(n_fft, win)  # zero columns to a multiple of 128, JAX's of 256
    np.testing.assert_array_equal(basis[:, :n_cols],
                                  jpstft._windowed_dft(n_fft, tuple(win.tolist()))[:, :n_cols])
    assert basis.shape[1] % 128 == 0 and not np.any(basis[:, n_cols:])
    audio = _audio()
    dproj = np.random.default_rng(1).standard_normal((3, 1024 // hop, n_cols)).astype(np.float32)
    proj_ref, vjp = jax.vjp(lambda a: jpstft.stft_frontend_projection(
        a, n_fft, hop, tuple(win.tolist())), jnp.asarray(audio))
    (grad_ref,) = vjp(jnp.asarray(dproj))

    at = torch.from_numpy(audio).requires_grad_(True)
    before = kstft.launches
    proj = kstft.stft_frontend_projection(at, n_fft, hop, win)
    assert kstft.launches == before  # a CPU tensor takes the plain version
    assert proj.shape == (3, 1024 // hop, n_cols)
    _assert_close(proj.detach().numpy(), np.asarray(proj_ref), 1e-5)
    proj.backward(torch.from_numpy(dproj))
    _assert_close(at.grad.numpy(), np.asarray(grad_ref), 1e-5)
    # the overlap-add alone: the same sums in the same order as JAX's
    dframes = np.random.default_rng(2).standard_normal((3, 1024 // hop, n_fft)).astype(np.float32)
    np.testing.assert_array_equal(
        kstft.overlap_add(torch.from_numpy(dframes), hop, 1024).numpy(),
        np.asarray(jpstft._ola(jnp.asarray(dframes), n_fft // hop, hop, 1024)))


@pytest.mark.parametrize("n_fft,hop,window", CASES)
def test_stft_magnitude_frontend_matches_jax(n_fft, hop, window):
    """The dispatch in ``stft_magnitude``: magnitudes and their gradient
    against the JAX package's with the frontend gate set, and against the
    port's own FFT path."""
    audio = _audio(seed=3)
    dmag = np.random.default_rng(4).standard_normal((3, 1024 // hop, n_fft // 2 + 1))
    dmag = dmag.astype(np.float32)
    kw = dict(size=n_fft, overlap=1.0 - hop / n_fft, window=window if window != "hann" else None)
    assert jpstft.frontend_applicable(n_fft, hop, 1024, True, False)
    mag_ref, vjp = jax.vjp(lambda a: jstft.stft_magnitude(a, **kw), jnp.asarray(audio))
    (grad_ref,) = vjp(jnp.asarray(dmag))

    at = torch.from_numpy(audio).requires_grad_(True)
    mag = tstft.stft_magnitude(at, frontend=True, **kw)
    _assert_close(mag.detach().numpy(), np.asarray(mag_ref), 1e-5)
    _assert_close(tstft.stft_magnitude(at, **kw).detach().numpy(), np.asarray(mag_ref), 1e-5)
    mag.backward(torch.from_numpy(dmag))
    _assert_close(at.grad.numpy(), np.asarray(grad_ref), 1e-5)


@pytest.mark.parametrize("n_fft,hop,t,pad_end,center", [
    (2048, 256, 4096, True, False), (2048, 512, 4096, True, False),
    (512, 128, 4096, True, False), (256, 64, 4096, True, False),
    (64, 16, 4096, True, False), (512, 128, 4000, True, False),
    (384, 256, 4096, True, False), (512, 128, 4096, False, False),
    (512, 128, 4096, True, True)])
def test_frontend_applies_where_jax_applies_it(n_fft, hop, t, pad_end, center):
    """JAX's conditions (``stft.py:182-194``) with its gate on: the same
    STFTs go to the frontend, at T = 4096 the loss STFT 2048/256 and the
    MSS scales 2048/512, 1024/256 and 512/128, not 256, 128 and 64."""
    assert (kstft.frontend_applicable(n_fft, hop, t, pad_end, center)
            == jpstft.frontend_applicable(n_fft, hop, t, pad_end, center))


def test_frontend_wrapper_raises_on_non_cuda_devices():
    audio = torch.empty((2, 1024), device="meta")
    basis = torch.empty((512, 640), device="meta")
    with pytest.raises(ValueError, match="stft_frontend"):
        kstft.stft_frontend_kernel(audio, 512, 128, basis)
