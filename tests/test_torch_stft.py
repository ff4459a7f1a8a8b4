"""The port's loss-domain STFT against ``sot_tpu.ops.stft``.

Inputs come from a seed with numpy. Values and gradients (a vector-Jacobian
product with a random cotangent) are compared in f32 on the CPU. Tolerances:
values max|d| <= 1e-5 * max|ref| (two FFT implementations, pocketfft and
XLA's, sum in other orders: ~1e-7 relative); gradients the same bound (the
transposed FFTs plus the overlap-add of up to 8 frame cotangents per
sample in another order).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from sot_tpu.features import STFT as JaxSTFT  # noqa: E402
from sot_tpu.ops import numerics as jnum  # noqa: E402
from sot_tpu.ops import stft as jstft  # noqa: E402
from sot_tpu_torch.features import STFT  # noqa: E402
from sot_tpu_torch.ops import numerics as tnum  # noqa: E402
from sot_tpu_torch.ops import stft as tstft  # noqa: E402
from tests._torch_parity import rel_max_err  # noqa: E402

MSS_SIZES = (2048, 1024, 512, 256, 128, 64)


def _audio(batch=2, t=4096, seed=0):
    return np.random.default_rng(seed).uniform(-0.9, 0.9, (batch, t)).astype(np.float32)


def _value_and_vjp_jax(x, ct, **kw):
    def value_and_vjp(a, c):
        y, vjp = jax.vjp(lambda b: jstft.stft_magnitude(b, **kw), a)
        return y, vjp(c)[0]

    y, g = jax.jit(value_and_vjp)(jnp.asarray(x), jnp.asarray(ct))
    return np.asarray(y), np.asarray(g)


def _value_and_vjp_port(x, ct, **kw):
    xt = torch.from_numpy(x).requires_grad_(True)
    y = tstft.stft_magnitude(xt, **kw)
    y.backward(torch.from_numpy(ct))
    return y.detach().numpy(), xt.grad.numpy()


@pytest.mark.parametrize("size,overlap,window", [
    (2048, 1.0 - 256 / 2048, "flattop"),  # the SOT loss transform
    *[(s, 0.75, None) for s in MSS_SIZES],  # the MSS scales (hann)
])
def test_stft_magnitude_value_and_gradient(size, overlap, window):
    x = _audio(seed=size)
    hop = int(size * (1 - overlap))
    shape = (2, -(-4096 // hop), size // 2 + 1)
    ct = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    y_ref, g_ref = _value_and_vjp_jax(x, ct, size=size, overlap=overlap, window=window)
    y, g = _value_and_vjp_port(x, ct, size=size, overlap=overlap, window=window)
    assert y.shape == y_ref.shape == shape
    assert rel_max_err(y, y_ref) <= 1e-5
    assert rel_max_err(g, g_ref) <= 1e-5


def test_zero_signal_has_a_finite_zero_gradient():
    """|z| at z = 0: the clamped backward gives 0, not NaN, in both."""
    x = np.zeros((1, 1024), np.float32)
    ct = np.ones((1, 8, 257), np.float32)  # 1024 / hop 128 = 8 frames
    _, g_ref = _value_and_vjp_jax(x, ct, size=512, overlap=0.75)
    _, g = _value_and_vjp_port(x, ct, size=512, overlap=0.75)
    assert np.all(g == 0.0) and np.all(g_ref == 0.0)


@pytest.mark.parametrize("normalized,time_major,pad_end", [
    (False, True, True), (True, False, True), (True, True, False)])
def test_stft_options_match(normalized, time_major, pad_end):
    x = _audio(batch=1, t=3000, seed=4)[0]  # 1-D input, T not a multiple of hop
    kw = dict(size=512, overlap=0.75, window="ones", normalized=normalized,
              time_major=time_major, pad_end=pad_end)
    ref = np.asarray(jstft.stft_magnitude(jnp.asarray(x), **kw))
    got = tstft.stft_magnitude(torch.from_numpy(x), **kw).numpy()
    assert got.shape == ref.shape
    assert rel_max_err(got, ref) <= 1e-5


def test_center_is_the_unported_loudness_path():
    with pytest.raises(NotImplementedError, match="loudness"):
        tstft.stft_magnitude(torch.zeros(1, 1024), size=256, center=True)


@pytest.mark.parametrize("t,frame,hop", [(4096, 2048, 256), (4096, 64, 16), (3000, 512, 128),
                                         (100, 256, 64)])
def test_framing_matches(t, frame, hop):
    assert tnum.pad_for_stft_length(t, frame, hop) == jnum.pad_for_stft_length(t, frame, hop)
    x = np.arange(2 * t, dtype=np.float32).reshape(2, t)
    for pad_end in (True, False) if t >= frame else (True,):
        ref = np.asarray(jstft.frame_signal(jnp.asarray(x), frame, hop, pad_end=pad_end))
        got = tstft.frame_signal(torch.from_numpy(x), frame, hop, pad_end=pad_end).numpy()
        np.testing.assert_array_equal(got, ref)


def test_stft_feature_matches():
    kw = dict(n_fft=2048, hop_length=256, sample_rate=16000, window="flattop")
    np.testing.assert_array_equal(STFT(**kw).get_frequencies(),
                                  JaxSTFT(**kw).get_frequencies())
    x = _audio(batch=2, t=4096, seed=9)
    for reduce, log in ((False, False), (True, True)):
        ref = np.asarray(JaxSTFT(**kw)(jnp.asarray(x), reduce=reduce, log=log))
        got = STFT(**kw)(torch.from_numpy(x), reduce=reduce, log=log).numpy()
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("size,overlap,window", [(2048, 1 - 256 / 2048, "flattop"),
                                                 (512, 0.75, None), (8192, 0.75, None)])
def test_dft_matmul_gate_matches_jax(size, overlap, window, monkeypatch):
    """``KernelGates.dft_matmul`` against the JAX package under
    ``SOT_TPU_DFT_MATMUL=1``: |rfft| as one f32 matmul against the real-DFT
    matrix for n_fft <= 4096 (8192 falls back to the FFT on both sides),
    values and VJP within this module's bound, through ``stft_magnitude``,
    the loss transform and the MSS loss."""
    from sot_tpu.losses import MSSLoss as JaxMSSLoss
    from sot_tpu_torch.kernel_gates import KernelGates
    from sot_tpu_torch.losses import MSSLoss

    monkeypatch.setenv("SOT_TPU_DFT_MATMUL", "1")
    x = _audio(t=8192 if size == 8192 else 4096, seed=5)
    ct = np.random.default_rng(6).standard_normal(
        jstft.stft_magnitude(jnp.asarray(x), size=size, overlap=overlap, window=window).shape
    ).astype(np.float32)
    y_ref, g_ref = _value_and_vjp_jax(x, ct, size=size, overlap=overlap, window=window)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = tstft.stft_magnitude(xt, size=size, overlap=overlap, window=window, dft_matmul=True)
    (g,) = torch.autograd.grad(y, xt, torch.from_numpy(ct))
    assert rel_max_err(y.detach().numpy(), y_ref) <= 1e-5
    assert rel_max_err(g.numpy(), g_ref) <= 1e-5
    fft = tstft.stft_magnitude(torch.from_numpy(x), size=size, overlap=overlap, window=window)
    assert torch.equal(fft, y.detach()) == (size > 4096)  # the matmul ran where it applies

    gates = KernelGates(dft_matmul=True)
    feat = STFT(n_fft=size, hop_length=int(size * (1 - overlap)), window=window, kernels=gates)
    jfeat = JaxSTFT(n_fft=size, hop_length=int(size * (1 - overlap)), window=window)
    assert rel_max_err(feat(torch.from_numpy(x)).numpy(), np.asarray(jfeat(jnp.asarray(x)))) <= 1e-5
    x_hat = _audio(t=x.shape[1], seed=7)
    got = float(MSSLoss(fft_sizes=MSS_SIZES, mag_weight=1.0, kernels=gates)(
        torch.from_numpy(x), torch.from_numpy(x_hat)))
    ref = float(JaxMSSLoss(fft_sizes=MSS_SIZES, mag_weight=1.0)(jnp.asarray(x), jnp.asarray(x_hat)))
    assert abs(got - ref) <= 1e-5 * abs(ref)
