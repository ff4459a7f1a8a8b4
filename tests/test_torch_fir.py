"""The FIR chain of the port (``sot_tpu_torch/ops/fir.py``) against the JAX
package's (``sot_tpu/ops/fir.py``) on seeded inputs.

Tolerance: max|d| <= 1e-5 * max|ref| wherever an FFT is involved (f32
transforms of up to 8192 points in two libraries, which sum in other
orders); the roll-off curve and the IR windowing (a product and a gather)
within 1e-6 relative.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from sot_tpu.ops import fir as jfir  # noqa: E402
from sot_tpu_torch.ops import fir as tfir  # noqa: E402

FFT_REL = 1e-5


def _rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("decay,n,f_ref", [(6.0, 65, 500.0), (3.0, 129, 1000.0), (12.0, 33, 250.0)])
def test_slope_frequency_response(decay, n, f_ref):
    ref = np.asarray(jfir.slope_frequency_response(jnp.asarray(decay), n, f_ref))
    got = tfir.slope_frequency_response(decay, n, f_ref).numpy()
    assert got.shape == ref.shape == (1, 1, n) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=1e-6)


@pytest.mark.parametrize("shape,ws,causal", [((2, 128), 0, False), ((2, 3, 128), 0, False),
                                             ((2, 128), 64, False), ((1, 2, 64), 33, False),
                                             ((2, 65), 0, True), ((3, 2, 128), 50, True)])
def test_apply_window_to_impulse_response(shape, ws, causal):
    ir = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    ref = np.asarray(jfir.apply_window_to_impulse_response(jnp.asarray(ir), ws, causal))
    got = tfir.apply_window_to_impulse_response(torch.from_numpy(ir), ws, causal).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("shape,ws", [((2, 65), 0), ((3, 4, 33), 0), ((2, 129), 101)])
def test_frequency_impulse_response(shape, ws):
    mags = np.random.default_rng(1).uniform(0, 1, shape).astype(np.float32)
    ref = np.asarray(jfir.frequency_impulse_response(jnp.asarray(mags), ws))
    got = tfir.frequency_impulse_response(torch.from_numpy(mags), ws).numpy()
    assert got.shape == ref.shape
    assert _rel(got, ref) <= FFT_REL


def test_get_fft_size_and_crop():
    for frame, ir in ((4096, 128), (100, 29), (1000, 65), (1, 1)):
        assert tfir.get_fft_size(frame, ir) == jfir.get_fft_size(frame, ir)
    audio = np.random.default_rng(2).standard_normal((2, 300)).astype(np.float32)
    for padding, delay in (("same", -1), ("same", 5), ("valid", -1), ("valid", 0)):
        ref = np.asarray(jfir.crop_and_compensate_delay(jnp.asarray(audio), 200, 65, padding,
                                                        delay))
        got = tfir.crop_and_compensate_delay(torch.from_numpy(audio), 200, 65, padding,
                                             delay).numpy()
        np.testing.assert_array_equal(got, ref)
    with pytest.raises(ValueError, match="Padding"):
        tfir.crop_and_compensate_delay(torch.from_numpy(audio), 200, 65, "full", -1)


@pytest.mark.parametrize("ir_shape,t,padding,cross_fade", [
    ((2, 65), 4096, "same", False),       # LTI, the roll-off's shape
    ((2, 65), 4096, "valid", False),
    ((2, 4, 65), 4096, "same", False),    # time-varying
    ((2, 4, 65), 4096, "same", True),     # with the cross-fade
    ((3, 5, 33), 1001, "valid", True),    # frames that do not divide the audio
    ((2, 1, 300), 250, "same", False),    # an IR longer than the frame
])
def test_fft_convolve(ir_shape, t, padding, cross_fade):
    rng = np.random.default_rng(3)
    audio = rng.standard_normal((ir_shape[0], t)).astype(np.float32)
    ir = rng.standard_normal(ir_shape).astype(np.float32)
    ref = np.asarray(jfir.fft_convolve(jnp.asarray(audio), jnp.asarray(ir), padding=padding,
                                       cross_fade=cross_fade))
    got = tfir.fft_convolve(torch.from_numpy(audio), torch.from_numpy(ir), padding=padding,
                            cross_fade=cross_fade).numpy()
    assert got.shape == ref.shape
    assert _rel(got, ref) <= FFT_REL
    with pytest.raises(ValueError, match="Batch size"):
        tfir.fft_convolve(torch.from_numpy(audio), torch.from_numpy(ir[:1]))


@pytest.mark.parametrize("window_size,cross_fade", [(0, False), (33, True)])
def test_frequency_filter_and_its_gradient(window_size, cross_fade):
    """The filter and its VJP to the audio (autograd against ``jax.vjp``)."""
    rng = np.random.default_rng(4)
    audio = rng.standard_normal((2, 4096)).astype(np.float32)
    mags = rng.uniform(0, 1, (2, 4, 65) if cross_fade else (2, 65)).astype(np.float32)
    cot = rng.standard_normal((2, 4096)).astype(np.float32)
    ref, vjp = jax.vjp(lambda a: jfir.frequency_filter(a, jnp.asarray(mags), window_size,
                                                       cross_fade=cross_fade),
                       jnp.asarray(audio))
    (ref_grad,) = vjp(jnp.asarray(cot))
    a = torch.from_numpy(audio).requires_grad_(True)
    got = tfir.frequency_filter(a, torch.from_numpy(mags), window_size, cross_fade=cross_fade)
    (grad,) = torch.autograd.grad(got, a, torch.from_numpy(cot))
    assert _rel(got.detach().numpy(), ref) <= FFT_REL
    assert _rel(grad.numpy(), ref_grad) <= FFT_REL
