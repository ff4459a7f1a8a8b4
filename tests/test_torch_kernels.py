"""The port's kernel wrappers.

On a CPU tensor each wrapper runs its plain PyTorch version and launches
nothing; on any other non-CUDA device it raises (no fallback). The tests
marked ``cuda`` build the CUDA sources and hold each kernel against its
plain version at the serving and training shapes, and check that no
wrapper returns a result cut from the autograd graph; they skip on a
machine without a GPU. Tolerances are those of ``chip_smoke.py``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import chip_smoke
from sot_tpu_torch.device import set_precision_policy
from sot_tpu_torch.ops.cqt import cqt_bank
from sot_tpu_torch.ops.kernels import conv as kconv
from sot_tpu_torch.ops.kernels import cqt as kcqt
from sot_tpu_torch.ops.kernels import merge as kmerge
from sot_tpu_torch.ops.kernels import plane as kplane
from sot_tpu_torch.ops.kernels import refgrad as krefgrad
from sot_tpu_torch.ops.kernels import stft as kstft
from sot_tpu_torch.ops.kernels import synth as ksynth
from sot_tpu_torch.ops.wasserstein import clipped_cdfs


def _cqt_inputs(device, batch=2, seed=0):
    bank = cqt_bank(16000, 32.7, 285, 36, 1.0, torch.device(device))
    width = bank.shape[0]
    x = np.random.default_rng(seed).uniform(-0.9, 0.9, (batch, 4095)).astype(np.float32)
    xpad = torch.nn.functional.pad(torch.from_numpy(x), (width // 2, width // 2))
    return xpad.to(device).contiguous(), bank


def _synth_inputs(device, batch=2, seed=0):
    rng = np.random.default_rng(seed)
    f0 = rng.uniform(40.0, 2000.0, (batch, 16, 1)).astype(np.float32)
    freqs = f0 * np.arange(1, 21, dtype=np.float32)
    amps = np.where(freqs >= 8000.0, 0.0,
                    rng.uniform(0.0, 2.0, (batch, 16, 20))).astype(np.float32)
    return torch.from_numpy(amps).to(device), torch.from_numpy(freqs).to(device)


def test_cqt_wrapper_takes_plain_version_on_cpu():
    xpad, bank = _cqt_inputs("cpu")
    before = kcqt.launches
    got = kcqt.cqt_project(xpad, bank, 256, 16, 570)
    assert kcqt.launches == before
    assert torch.equal(got, kcqt.cqt_project_plain(xpad, bank, 256, 16, 570))
    assert got.shape == (2, 16, 570)


def test_synth_wrapper_takes_plain_version_on_cpu():
    amps, freqs = _synth_inputs("cpu")
    before = ksynth.launches
    got = ksynth.synth_render(amps, freqs, 4096, 16000)
    assert ksynth.launches == before
    assert torch.equal(got, ksynth.synth_render_plain(amps, freqs, 4096, 16000))
    with pytest.raises(ValueError, match="CUDA kernel"):
        ksynth.synth_render(amps, freqs, 4096, 16000, debug_envelopes=True)


def test_wrappers_raise_on_non_cuda_devices():
    """A tensor that is neither on the CPU nor on a GPU never reaches a plain
    version."""
    xpad = torch.empty((2, 36863), device="meta")
    bank = torch.empty((32768, 640), device="meta")
    with pytest.raises(ValueError, match="cqt_project"):
        kcqt.cqt_project(xpad, bank, 256, 16, 570)
    amps = torch.empty((2, 16, 20), device="meta")
    with pytest.raises(ValueError, match="synth_render"):
        ksynth.synth_render(amps, amps, 4096, 16000)


def _dft_4q(v: np.ndarray) -> np.ndarray:
    """The kernel's in-register DFT of R = 4Q points (last axis): four-point
    DFTs over n1 of v[Q n1 + n2], the twiddles W_R^(n2 k1), then Q-point DFTs
    over n2, X[k1 + 4 k2]. R = 2 and 4 are plain butterflies."""
    r = v.shape[-1]
    if r == 2:
        return np.stack([v[..., 0] + v[..., 1], v[..., 0] - v[..., 1]], axis=-1)
    q = max(r // 4, 1)
    w4 = np.array([[1, 1, 1, 1], [1, -1j, -1, 1j], [1, -1, 1, -1], [1, 1j, -1, -1j]],
                  np.complex64)
    y = np.einsum("kn,...nm->...km", w4, v.reshape(v.shape[:-1] + (4, q)))  # y[k1, n2]
    k1, n2 = np.meshgrid(np.arange(4), np.arange(q), indexing="ij")
    y = y * np.exp(-2j * np.pi * k1 * n2 / r).astype(np.complex64)
    wq = np.exp(-2j * np.pi * np.outer(np.arange(q), np.arange(q)) / q).astype(np.complex64)
    x = np.einsum("...kn,mn->...mk", y, wq)  # x[k2, k1] = X[k1 + 4 k2]
    return x.reshape(v.shape).astype(np.complex64)


def stockham_rfft(frames: np.ndarray, table: np.ndarray) -> np.ndarray:
    """csrc/stft.cu's algorithm in numpy, complex64 arithmetic: pack the
    windowed frames [rows, n] two samples to a complex point, run the
    Stockham passes of an n/2-point FFT with the kernel's radices (P while
    it divides what is left, then the rest; P = 16 from n = 1024, 8 below)
    and the real
    post-twiddle two bins (k, n/2 - k) at a time; [rows, n + 2] re | im."""
    n = frames.shape[1]
    half = n // 2
    tw = (table[:, 0] + 1j * table[:, 1]).astype(np.complex64)
    z = (frames[:, 0::2] + 1j * frames[:, 1::2]).astype(np.complex64)
    p, radices, size = (16 if half >= 512 else 8), [], 1
    while size * p <= half:
        radices, size = radices + [p], size * p
    radices += [half // size] if size < half else []
    ns = 1
    for r in radices:
        j = np.arange(half // r)
        k = j & (ns - 1)
        v = np.stack([z[:, j + q * (half // r)] for q in range(r)], axis=-1)
        if ns > 1:
            v = v * tw[np.outer(k * (2 * half // (r * ns)), np.arange(r))]
        v = _dft_4q(v)
        d = (j - k) * r + k
        o = np.empty_like(z)
        for q in range(r):
            o[:, d + q * ns] = v[..., q]
        z, ns = o, ns * r
    assert ns == half
    k = np.arange(half // 2 + 1)
    zk, zn = z[:, k % half], z[:, (half - k) % half]
    e = np.float32(0.5) * (zk + np.conj(zn))
    t = tw[k] * (np.complex64(-0.5j) * (zk - np.conj(zn)))
    x = np.empty((len(z), half + 1), np.complex64)
    x[:, half - k] = np.conj(e - t)
    x[:, k] = e + t
    return np.concatenate([x.real, x.imag], axis=1).astype(np.float32)


@pytest.mark.parametrize("n_fft", kstft.FFT_SIZES)
def test_fft_twiddle_table_against_float64(n_fft):
    table = kstft._twiddles(n_fft)
    assert table.dtype == np.float32 and table.shape == (n_fft, 2)
    ang = 2.0 * np.pi * np.arange(n_fft) / n_fft
    want = np.stack([np.cos(ang), -np.sin(ang)], axis=1)
    # rounded once: each entry the f32 nearest to its float64 value
    np.testing.assert_array_equal(table, want.astype(np.float32))
    assert np.abs(table - want).max() <= 2.0 ** -25
    assert table[0, 0] == 1.0 and table[n_fft // 2, 0] == -1.0


@pytest.mark.parametrize("n_fft", kstft.FFT_SIZES)
def test_fft_frontend_algebra_matches_dense_projection(n_fft):
    """The packing, the Stockham passes and the separation of the kernel,
    emulated in numpy, against the frames times the windowed basis (within
    1e-5 of the max, as chip_smoke's FRONTEND_LIMIT) and against a float64
    rfft."""
    win = chip_smoke.get_window("flattop", n_fft)
    frames = np.random.default_rng(n_fft).uniform(-0.9, 0.9, (16, n_fft)).astype(np.float32)
    got = stockham_rfft(frames * win, kstft._twiddles(n_fft))
    dense = frames @ kstft._windowed_dft(n_fft, win)[:, :n_fft + 2]
    assert float(np.abs(got - dense).max()) <= 1e-5 * float(np.abs(dense).max())
    exact = np.fft.rfft(frames.astype(np.float64) * win.astype(np.float64), axis=1)
    exact = np.concatenate([exact.real, exact.imag], axis=1)
    assert float(np.abs(got - exact).max()) <= 1e-6 * float(np.abs(exact).max())


def test_frontend_kernel_wrapper_takes_plain_version_on_cpu():
    win = chip_smoke.hann_window(512)
    x = torch.from_numpy(np.random.default_rng(5).uniform(-0.9, 0.9, (2, 1024))
                         .astype(np.float32))
    before = kstft.launches
    got = kstft.stft_frontend_kernel(x, 512, 128, kstft.window_tensor(win, x.device))
    assert kstft.launches == before
    basis = kstft.windowed_dft(512, win, x.device)
    assert torch.equal(got, kstft.stft_frontend_projection_plain(x, 512, 128, basis))
    assert got.shape == (2, 8, 514)


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 3, 64])
def test_cqt_kernel_matches_plain_on_card(batch):
    """Within 1e-4 of the plain version; against a float64 product no more
    than 2x the plain f32 version's error; two launches bit-equal. Batches
    of 16, 48 and 1024 rows: part-filled row tiles and the serving shape."""
    _need_cuda()
    xpad, bank = _cqt_inputs("cuda", batch=batch)
    before = kcqt.launches
    got = kcqt.cqt_project(xpad, bank, 256, 16, 570)
    again = kcqt.cqt_project(xpad, bank, 256, 16, 570)
    ref = kcqt.cqt_project_plain(xpad, bank, 256, 16, 570)
    ref64 = torch.matmul(xpad.double().unfold(1, bank.shape[0], 256)[:, :16],
                         bank[:, :570].double())
    torch.cuda.synchronize()
    assert kcqt.launches == before + 2
    assert float((got - ref).abs().max() / ref.abs().max()) <= 1e-4
    assert chip_smoke.f64_rel(got, ref64) <= 2.0 * chip_smoke.f64_rel(ref, ref64)
    assert torch.equal(got, again)


@pytest.mark.cuda
def test_synth_kernel_matches_plain_on_card():
    _need_cuda()
    amps, freqs = _synth_inputs("cuda", batch=64)
    audio, env_f, env_a, phase = ksynth.synth_render(amps, freqs, 4096, 16000,
                                                     debug_envelopes=True)
    ref_f, ref_a = ksynth.synth_envelopes_plain(amps, freqs, 4096, 16000)
    ref = ksynth.synth_render_plain(amps, freqs, 4096, 16000)
    torch.cuda.synchronize()
    assert torch.equal(env_f, ref_f) and torch.equal(env_a, ref_a)
    assert float((audio - ref).abs().max()) <= 2e-2
    assert np.corrcoef(audio.cpu().numpy().ravel(), ref.cpu().numpy().ravel())[0, 1] > 0.9999


@pytest.mark.cuda
def test_synth_kernel_phase_bit_equal_to_plain_on_card():
    """The kernel's rounded phase (split into chunks and lanes) against the
    plain float64 cumsum, and the normal launch's audio against the debug
    launch's."""
    _need_cuda()
    amps, freqs = _synth_inputs("cuda", batch=64)
    audio, env_f, _, phase = ksynth.synth_render(amps, freqs, 4096, 16000,
                                                 debug_envelopes=True)
    plain = ksynth.synth_phase_plain(ksynth.synth_envelopes_plain(amps, freqs, 4096, 16000)[0],
                                     16000)
    torch.cuda.synchronize()
    assert torch.equal(phase, plain)
    assert torch.equal(audio, ksynth.synth_render(amps, freqs, 4096, 16000))


@pytest.mark.cuda
def test_synth_kernels_bit_equal_across_launches_on_card():
    _need_cuda()
    amps, freqs = _synth_inputs("cuda", batch=64)
    dout = torch.randn(64, 4096, device="cuda", generator=torch.Generator("cuda").manual_seed(1))
    first = ksynth.synth_render(amps, freqs, 4096, 16000)
    again = ksynth.synth_render(amps, freqs, 4096, 16000)
    grads = ksynth.synth_backward(amps, freqs, dout, 4096, 16000)
    grads_again = ksynth.synth_backward(amps, freqs, dout, 4096, 16000)
    torch.cuda.synchronize()
    assert torch.equal(first, again)
    assert all(torch.equal(x, y) for x, y in zip(grads, grads_again))


# (batch, n_frames, n_samples, K): every n_frames of 2-128, n_samples of
# 256-8192 (hops 2-3072, part-filled last segments and backward rows), K of
# 1, 3, 20 and 33 (two harmonic tiles), batch 1 and 64
SYNTH_SWEEP = [(1, 2, 256, 1), (64, 8, 1024, 3), (64, 16, 4096, 20), (1, 32, 8192, 33),
               (64, 128, 8192, 20), (1, 128, 256, 3), (64, 2, 6144, 33), (1, 16, 1792, 20),
               (64, 32, 768, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("batch,n_frames,n_samples,n_sin", SYNTH_SWEEP)
def test_synth_kernels_shape_sweep_on_card(batch, n_frames, n_samples, n_sin):
    """Envelopes and phase bit-equal, audio within chip_smoke's limits, the
    backward within 1e-4 / 1e-3 of autograd through the plain version."""
    _need_cuda()
    rng = np.random.default_rng(n_samples + n_sin)
    f0 = rng.uniform(40.0, 2000.0, (batch, n_frames, 1)).astype(np.float32)
    freqs = f0 * np.arange(1, n_sin + 1, dtype=np.float32)
    amps = np.where(freqs >= 8000.0, 0.0,
                    rng.uniform(0.0, 2.0, (batch, n_frames, n_sin))).astype(np.float32)
    amps, freqs = torch.from_numpy(amps).cuda(), torch.from_numpy(freqs).cuda()
    dout = torch.from_numpy(rng.standard_normal((batch, n_samples)).astype(np.float32)).cuda()
    audio, env_f, env_a, phase = ksynth.synth_render(amps, freqs, n_samples, 16000,
                                                     debug_envelopes=True)
    ref_f, ref_a = ksynth.synth_envelopes_plain(amps, freqs, n_samples, 16000)
    ref = ksynth.synth_render_plain(amps, freqs, n_samples, 16000)
    d_amps, d_freqs = ksynth.synth_backward(amps, freqs, dout, n_samples, 16000)
    a = amps.clone().requires_grad_(True)
    f = freqs.clone().requires_grad_(True)
    ref_da, ref_df = torch.autograd.grad(ksynth.synth_render_plain(a, f, n_samples, 16000),
                                         (a, f), dout)
    torch.cuda.synchronize()
    assert torch.equal(env_f, ref_f) and torch.equal(env_a, ref_a)
    assert torch.equal(phase, ksynth.synth_phase_plain(ref_f, 16000))
    assert float((audio - ref).abs().max()) <= 2e-2
    assert np.corrcoef(audio.cpu().numpy().ravel(), ref.cpu().numpy().ravel())[0, 1] > 0.9999
    assert float((d_amps - ref_da).abs().max() / ref_da.abs().max()) <= 1e-4
    assert float((d_freqs - ref_df).abs().max() / ref_df.abs().max()) <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("batch,n_frames,n_samples,n_sin", [
    (2, 16, 4000, 20), (2, 16, 8448, 20), (2, 1, 4096, 20), (2, 256, 8192, 20),
    (2, 24, 4096, 20), (2, 16, 4096, 0), (0, 16, 4096, 20)])
def test_synth_kernels_raise_outside_their_shapes_on_card(batch, n_frames, n_samples, n_sin):
    """n_samples not a multiple of 256 or above 8192, n_frames outside 2-128
    or not dividing n_samples, K or batch 0: a ValueError before any launch."""
    _need_cuda()
    amps = torch.ones((batch, n_frames, n_sin), device="cuda")
    dout = torch.zeros((batch, n_samples), device="cuda")
    before = (ksynth.launches, ksynth.backward_launches)
    with pytest.raises(ValueError, match="synth_render"):
        ksynth.synth_render(amps, amps * 100.0, n_samples, 16000)
    with pytest.raises(ValueError, match="synth_render"):
        ksynth.synth_backward(amps, amps * 100.0, dout, n_samples, 16000)
    assert (ksynth.launches, ksynth.backward_launches) == before


def _sot_inputs(device, rows=1024, n=1025, seed=0):
    """SOT-shaped rows: spectra-like weights with empty bins, the target
    self-normalised and the estimate at another mass, clipped at the cap."""
    rng = np.random.default_rng(seed)
    u = rng.random((rows, n)).astype(np.float32) ** 8
    v = rng.random((rows, n)).astype(np.float32) ** 8
    u[:, ::7] = 0.0
    v[:, ::5] = 0.0
    u /= u.sum(-1, keepdims=True)
    v /= v.sum(-1, keepdims=True) / 1.3
    grid = np.linspace(0.0, 1.0, n, dtype=np.float32)
    return clipped_cdfs(*(torch.from_numpy(a).to(device) for a in (grid, u, v)), True)


@pytest.mark.cuda
def test_merge_coupling_kernel_matches_plain_on_card():
    _need_cuda()
    alpha, beta, gaug = _sot_inputs("cuda")
    cap = alpha[:, -1:]
    a, b = (cap - alpha[:, :-1]).contiguous(), (cap - beta[:, :-1]).contiguous()
    x = (gaug[1:] - gaug[:-1]).contiguous()
    before = kmerge.launches
    got = kmerge.coupling(a, b, x)
    ref = kmerge.coupling_plain(a, b, x)
    torch.cuda.synchronize()
    assert kmerge.launches == before + 1
    assert float(((got - ref).abs() / ref.abs().clamp(min=1e-30)).max()) <= 1e-5


@pytest.mark.cuda
def test_refgrad_kernel_matches_plain_on_card():
    _need_cuda()
    alpha, beta, gaug = _sot_inputs("cuda")
    wbar = torch.rand(alpha.shape[0], device="cuda") + 0.5
    before = krefgrad.launches
    got = krefgrad.ref_grad_beta(alpha, beta, gaug, wbar)
    ref = krefgrad.ref_grad_beta_plain(alpha, beta, gaug, wbar)
    torch.cuda.synchronize()
    assert krefgrad.launches == before + 1
    assert float((got - ref).abs().max()) <= 2e-5 * float(ref.abs().max())


@pytest.mark.cuda
def test_synth_backward_kernel_matches_autograd_of_plain_on_card():
    _need_cuda()
    amps, freqs = _synth_inputs("cuda", batch=64)
    dout = torch.randn(64, 4096, device="cuda", generator=torch.Generator("cuda").manual_seed(0))
    before = ksynth.backward_launches
    d_amps, d_freqs = ksynth.synth_backward(amps, freqs, dout, 4096, 16000)
    a = amps.clone().requires_grad_(True)
    f = freqs.clone().requires_grad_(True)
    ref_a, ref_f = torch.autograd.grad(ksynth.synth_render_plain(a, f, 4096, 16000), (a, f), dout)
    torch.cuda.synchronize()
    assert ksynth.backward_launches == before + 1
    assert float((d_amps - ref_a).abs().max() / ref_a.abs().max()) <= 1e-4
    assert float((d_freqs - ref_f).abs().max() / ref_f.abs().max()) <= 1e-3


@pytest.mark.cuda
def test_synth_render_carries_its_backward_on_card():
    """The wrapper's result on a CUDA input that requires grad has a grad_fn,
    and backward() runs the backward kernel."""
    _need_cuda()
    amps, freqs = _synth_inputs("cuda", batch=4)
    amps.requires_grad_(True)
    freqs.requires_grad_(True)
    out = ksynth.synth_render(amps, freqs, 4096, 16000)
    assert out.grad_fn is not None
    before = ksynth.backward_launches
    out.square().sum().backward()
    torch.cuda.synchronize()
    assert ksynth.backward_launches == before + 1
    assert amps.grad is not None and freqs.grad is not None
    assert bool(torch.isfinite(amps.grad).all() and torch.isfinite(freqs.grad).all())


@pytest.mark.cuda
def test_cqt_refuses_inputs_that_need_a_gradient_on_card():
    _need_cuda()
    xpad, bank = _cqt_inputs("cuda")
    with pytest.raises(RuntimeError, match="no backward"):
        kcqt.cqt_project(xpad.requires_grad_(True), bank, 256, 16, 570)
    with torch.no_grad():  # grad mode off: the kernel runs
        assert kcqt.cqt_project(xpad, bank, 256, 16, 570).shape == (2, 16, 570)


def _plane_on(device, arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays)


def _plane_pair(alpha, beta, g, wbar, p):
    """(kernel outputs, plain outputs): W, (dalpha, dbeta), dbeta without alpha."""
    outs = []
    for fwd, bwd in ((kplane.sot_plane_forward, kplane.sot_plane_backward),
                     (kplane.sot_plane_forward_plain, kplane.sot_plane_backward_plain)):
        da, db = bwd(alpha, beta, g, p, wbar, True)
        outs.append((fwd(alpha, beta, g, p), da, db, bwd(alpha, beta, g, p, wbar, False)[1]))
    return outs


@pytest.mark.cuda
@pytest.mark.parametrize("n", [258, 1026])
@pytest.mark.parametrize("p", [2.0, 3.0])
def test_plane_kernels_bit_equal_on_dyadic_rows_on_card(n, p):
    """Kernels 6 and 7 against their plain versions on rows where every
    product and sum is exact: bit for bit, the tie convention included."""
    _need_cuda()
    arrays = _plane_on("cuda", chip_smoke.dyadic_plane_rows(np.random.default_rng(n), 1024, n))
    before = (kplane.launches, kplane.backward_launches)
    got, ref = _plane_pair(*arrays, p)
    torch.cuda.synchronize()
    assert (kplane.launches, kplane.backward_launches) == (before[0] + 1, before[1] + 2)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("sort", [True, False])
def test_plane_kernels_match_plain_on_random_rows_on_card(sort):
    """Sorted rows (the band) and unsorted rows (the full scan), within
    chip_smoke's PLANE_LIMITS."""
    _need_cuda()
    rows, n = (1024, 1026) if sort else (64, 258)
    arrays = _plane_on("cuda", chip_smoke.random_plane_rows(np.random.default_rng(1), rows, n,
                                                            sort=sort))
    got, ref = _plane_pair(*arrays, 2.0)
    torch.cuda.synchronize()
    w_lim, d_lim = chip_smoke.PLANE_LIMITS
    assert float(((got[0] - ref[0]).abs() / ref[0].abs().clamp(min=1e-30)).max()) <= w_lim
    for a, b in zip(got[1:], ref[1:]):
        assert float((a - b).abs().max()) <= d_lim * float(b.abs().max())


def _plane_within_limits(got, ref):
    w_lim, d_lim = chip_smoke.PLANE_LIMITS
    assert all(bool(torch.isfinite(t).all()) for t in got)
    assert float(((got[0] - ref[0]).abs() / ref[0].abs().clamp(min=1e-30)).max()) <= w_lim
    for a, b in zip(got[1:], ref[1:]):
        assert float((a - b).abs().max()) <= d_lim * float(b.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [258, 1026])
def test_plane_kernels_bit_equal_across_launches_on_card(n):
    """Two launches of kernels 6 and 7 on the same rows: every output
    bit-equal (fixed summation orders, no atomics)."""
    _need_cuda()
    arrays = _plane_on("cuda", chip_smoke.random_plane_rows(np.random.default_rng(n), 1024, n))
    first, _ = _plane_pair(*arrays, 2.0)
    again, _ = _plane_pair(*arrays, 2.0)
    torch.cuda.synchronize()
    for a, b in zip(first, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [258, 1026])
def test_plane_kernels_match_plain_on_stress_rows_on_card(n):
    """chip_smoke.stress_plane_rows (a spike against a spread spectrum both
    ways, beta = alpha, a zero-mass stretch), within PLANE_LIMITS."""
    _need_cuda()
    got, ref = _plane_pair(*_plane_on("cuda", chip_smoke.stress_plane_rows(256, n)), 2.0)
    torch.cuda.synchronize()
    _plane_within_limits(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 8192])
def test_plane_kernels_at_the_edge_widths_on_card(n):
    """The narrowest rows and the widest the wrapper takes (the most shared
    memory a block needs), bit for bit on dyadic rows."""
    _need_cuda()
    rows = 8 if n == 8192 else 64
    if n == 1:
        arrays = (np.full((rows, 1), 0.5, np.float32), np.full((rows, 1), 0.25, np.float32),
                  np.zeros(1, np.float32), np.ones(rows, np.float32))
    else:
        arrays = chip_smoke.dyadic_plane_rows(np.random.default_rng(n), rows, n)
    got, ref = _plane_pair(*_plane_on("cuda", arrays), 2.0)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_plane_kernels_refuse_wider_rows_on_card():
    _need_cuda()
    a = torch.zeros((2, 8193), device="cuda")
    with pytest.raises(ValueError, match="n <= 8192"):
        kplane.sot_plane_forward(a, a, torch.zeros(8193, device="cuda"), 2.0)


@pytest.mark.cuda
def test_plane_launch_counters_count_kernel_launches_on_card():
    """Each wrapper call on the card adds one to its counter; the plain
    versions add none."""
    _need_cuda()
    alpha, beta, g, wbar = _plane_on("cuda", chip_smoke.random_plane_rows(
        np.random.default_rng(5), 64, 258))
    before = (kplane.launches, kplane.backward_launches)
    kplane.sot_plane_forward(alpha, beta, g, 2.0)
    kplane.sot_plane_backward(alpha, beta, g, 2.0, wbar, False)
    kplane.sot_plane_backward(alpha, beta, g, 2.0, wbar, True)
    kplane.sot_plane_forward_plain(alpha, beta, g, 2.0)
    kplane.sot_plane_backward_plain(alpha, beta, g, 2.0, wbar, True)
    torch.cuda.synchronize()
    assert (kplane.launches, kplane.backward_launches) == (before[0] + 1, before[1] + 2)


def _refgrad_rows(kind, n):
    """(alpha, beta, g, wbar) float32 numpy for the kernel 5 and 4 cases."""
    rng = np.random.default_rng(n)
    if kind == "random":
        return chip_smoke.random_plane_rows(rng, 1024 if n <= 1026 else 8, n)
    if kind == "stress":
        return chip_smoke.stress_plane_rows(256, n)
    if kind == "dyadic":
        return chip_smoke.dyadic_plane_rows(rng, 64 if n <= 1026 else 8, n)
    alpha, beta, g, wbar = chip_smoke.random_plane_rows(rng, 64, n)
    return alpha, rng.permuted(beta, axis=-1), g, wbar  # beta unsorted


@pytest.mark.cuda
@pytest.mark.parametrize("kind,n", [("random", 258), ("random", 1026), ("stress", 258),
                                    ("stress", 1026), ("dyadic", 1026), ("beta unsorted", 258),
                                    ("dyadic", 1), ("dyadic", 2), ("dyadic", 8192),
                                    ("dyadic", 8193), ("random", 16384)])
def test_refgrad_kernel_equal_to_plain_on_card(kind, n):
    """Kernel 5 against its plain version: equal (torch.equal) and bit for
    bit wherever the result is not a zero, on sorted rows, rows whose beta
    is not sorted and the narrowest and widest rows the wrapper takes."""
    _need_cuda()
    if n == 1:
        arrays = (np.full((64, 1), 0.5, np.float32), np.full((64, 1), 0.25, np.float32),
                  np.zeros(1, np.float32), np.ones(64, np.float32))
    else:
        arrays = _refgrad_rows(kind, n)
    alpha, beta, g, wbar = (torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in arrays)
    got = krefgrad.ref_grad_beta(alpha, beta, g, wbar)
    ref = krefgrad.ref_grad_beta_plain(alpha, beta, g, wbar)
    torch.cuda.synchronize()
    nonzero = ref != 0
    assert torch.equal(got, ref)
    assert torch.equal(got.view(torch.int32)[nonzero], ref.view(torch.int32)[nonzero])


@pytest.mark.cuda
@pytest.mark.parametrize("kind,n", [("random", 258), ("random", 1026), ("stress", 258),
                                    ("stress", 1026), ("a unsorted", 258), ("b unsorted", 258),
                                    ("both unsorted", 1026), ("dyadic", 2), ("dyadic", 3),
                                    ("dyadic", 8193)])
def test_coupling_kernel_matches_plain_on_card(kind, n):
    """Kernel 4 against its plain version within chip_smoke's 1e-5 per row:
    the walk on sorted rows, the all-pairs sum on rows unsorted on either
    side (permuted complements of sorted rows: the coupling's inputs are
    >= 0), m = 1, 2 and 8192 (the most shared memory a block needs)."""
    _need_cuda()
    rows = _refgrad_rows("random" if "unsorted" in kind else kind, n)
    a, b, x = chip_smoke.complements(*(torch.from_numpy(np.ascontiguousarray(t)) for t in rows[:3]))
    rng = np.random.default_rng(0)
    if kind in ("a unsorted", "both unsorted"):  # permuted complements stay >= 0
        a = torch.from_numpy(rng.permuted(a.numpy(), axis=-1))
    if kind in ("b unsorted", "both unsorted"):
        b = torch.from_numpy(rng.permuted(b.numpy(), axis=-1))
    a, b, x = a.cuda(), b.cuda(), x.cuda()
    got = kmerge.coupling(a, b, x)
    ref = kmerge.coupling_plain(a, b, x)
    torch.cuda.synchronize()
    scale = ref.abs().clamp(min=1e-12 * float(ref.abs().max()))
    assert bool(torch.isfinite(got).all())
    assert float(((got - ref).abs() / scale).max()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("n", [258, 1026])
def test_rank_kernels_bit_equal_across_launches_on_card(n):
    """Two launches of kernels 4 and 5 on the same rows: bit-equal (fixed
    summation orders, no atomics)."""
    _need_cuda()
    alpha, beta, g, wbar = (torch.from_numpy(a).cuda()
                            for a in chip_smoke.random_plane_rows(np.random.default_rng(n), 1024,
                                                                  n))
    a, b, x = chip_smoke.complements(alpha, beta, g)
    runs = [(kmerge.coupling(a, b, x), krefgrad.ref_grad_beta(alpha, beta, g, wbar))
            for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])


def test_plane_wrappers_take_plain_version_on_cpu():
    arrays = _plane_on("cpu", chip_smoke.dyadic_plane_rows(np.random.default_rng(0), 16, 40))
    before = (kplane.launches, kplane.backward_launches)
    kplane.sot_plane_forward(*arrays[:3], 2.0)
    da, db = kplane.sot_plane_backward(*arrays[:3], 2.0, arrays[3], alpha_grads=False)
    assert da is None and db.shape == (16, 40)
    assert (kplane.launches, kplane.backward_launches) == before


def test_plane_wrappers_raise_on_non_cuda_devices():
    a = torch.empty((4, 8), device="meta")
    g = torch.empty((8,), device="meta")
    with pytest.raises(ValueError, match="sot_plane_forward"):
        kplane.sot_plane_forward(a, a, g, 2.0)
    with pytest.raises(ValueError, match="sot_plane_backward"):
        kplane.sot_plane_backward(a, a, g, 2.0, torch.empty((4,), device="meta"))


@pytest.mark.cuda
@pytest.mark.parametrize("rows", ["dyadic", "random", "unsorted"])
def test_coupling_grads_kernel_matches_plain_on_card(rows):
    """Kernel 8, alpha_grads both ways: bit for bit on dyadic tie rows, within
    chip_smoke's COUPLING_GRAD_LIMIT on random sorted and unsorted rows."""
    _need_cuda()
    rng = np.random.default_rng(3)
    arrays = {"dyadic": lambda: chip_smoke.dyadic_plane_rows(rng, 1024, 1026),
              "random": lambda: chip_smoke.random_plane_rows(rng, 1024, 1026),
              "unsorted": lambda: chip_smoke.random_plane_rows(rng, 64, 258, sort=False)}[rows]()
    a, b, x = chip_smoke.complements(*_plane_on("cuda", arrays[:3]))
    before = kmerge.grad_launches
    for alpha_grads in (True, False):
        got = kmerge.coupling_grads(a, b, x, alpha_grads)
        ref = kmerge.coupling_grads_plain(a, b, x, alpha_grads)
        torch.cuda.synchronize()
        assert (got[0] is None) == (not alpha_grads)
        for g, r in zip(got, ref):
            if g is None:
                continue
            if rows == "dyadic":
                assert torch.equal(g, r)
            assert float((g - r).abs().max()) <= chip_smoke.COUPLING_GRAD_LIMIT * float(
                r.abs().max())
    assert kmerge.grad_launches == before + 2


def _grad_rows(kind, m):
    """(a, b, x) float32 numpy of kernel 8's row families: the stress kinds
    and dyadic rows on dyadic grid deltas, and permuted complements of
    random sorted rows on one side or both."""
    if kind in chip_smoke.GRAD_STRESS_KINDS:
        return chip_smoke.grad_stress_rows(kind, 256, m)
    rng = np.random.default_rng(m)
    rows = (chip_smoke.dyadic_plane_rows(rng, 64 if m <= 1025 else 8, m + 1) if kind == "dyadic"
            else chip_smoke.random_plane_rows(rng, 64, m + 1))
    a, b, x = (t.numpy() for t in chip_smoke.complements(*(torch.from_numpy(v)
                                                             for v in rows[:3])))
    if kind in ("a unsorted", "both unsorted"):
        a = rng.permuted(a, axis=-1)
    if kind in ("b unsorted", "both unsorted"):
        b = rng.permuted(b, axis=-1)
    return a, b, x


@pytest.mark.cuda
@pytest.mark.parametrize("kind,m", [("all zeros", 300), ("a = b", 1025),
                                    ("one distinct value", 257), ("dyadic", 1), ("dyadic", 2),
                                    ("dyadic", 8192), ("a unsorted", 257), ("b unsorted", 257),
                                    ("both unsorted", 1025)])
def test_coupling_grads_kernel_on_row_families_on_card(kind, m):
    """Kernel 8, alpha_grads both ways, against its plain version: bit for
    bit on the stress and dyadic rows (exact prefix sums), within
    chip_smoke's COUPLING_GRAD_LIMIT on rows unsorted on either side (the
    whole-row scan), m = 1, 2 and 8192 (the most shared memory a block
    needs)."""
    _need_cuda()
    a, b, x = (torch.from_numpy(np.ascontiguousarray(t)).cuda() for t in _grad_rows(kind, m))
    for alpha_grads in (True, False):
        got = kmerge.coupling_grads(a, b, x, alpha_grads)
        ref = kmerge.coupling_grads_plain(a, b, x, alpha_grads)
        torch.cuda.synchronize()
        for g, r in zip(got, ref):
            if r is None:
                assert g is None
                continue
            if "unsorted" not in kind:
                assert torch.equal(g.view(torch.int32), r.view(torch.int32))
            assert float((g - r).abs().max()) <= chip_smoke.COUPLING_GRAD_LIMIT * float(
                r.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("m", [257, 1025])
def test_coupling_grads_kernel_bit_equal_across_launches_on_card(m):
    """Two launches of kernel 8 on the same random rows, alpha_grads both
    ways: bit-equal (fixed orders, no atomics)."""
    _need_cuda()
    a, b, x = (torch.from_numpy(np.ascontiguousarray(t)).cuda()
               for t in chip_smoke.complements(*(torch.from_numpy(v) for v in
                                                 chip_smoke.random_plane_rows(
                                                     np.random.default_rng(m), 1024, m + 1)[:3])))
    for alpha_grads in (True, False):
        runs = [kmerge.coupling_grads(a, b, x, alpha_grads) for _ in range(2)]
        torch.cuda.synchronize()
        assert torch.equal(runs[0][1], runs[1][1])
        assert (runs[0][0] is None) or torch.equal(runs[0][0], runs[1][0])


@pytest.mark.cuda
@pytest.mark.parametrize("n_fft,hop,window", chip_smoke.FRONTEND_CASES)
def test_stft_frontend_kernel_and_its_gradient_on_card(n_fft, hop, window):
    """Kernel 9 against the plain matmul at the gated step's shapes (and,
    against a float64 projection, no more than 2x the plain version's
    error), and the entry's gradient (plain matmul and overlap-add) against
    autograd of the plain version."""
    _need_cuda()
    win = chip_smoke.hann_window(n_fft) if window is None else chip_smoke.get_window(window,
                                                                                     n_fft)
    x = torch.from_numpy(np.random.default_rng(n_fft + hop).uniform(
        -0.9, 0.9, (64, 4096)).astype(np.float32)).cuda()
    basis = kstft.windowed_dft(n_fft, win, x.device)
    before = kstft.launches
    got = kstft.stft_frontend_kernel(x, n_fft, hop, kstft.window_tensor(win, x.device))
    ref = kstft.stft_frontend_projection_plain(x, n_fft, hop, basis)
    ref64 = torch.matmul(kstft._frames(x, n_fft, hop).double(),
                         chip_smoke.windowed_dft64(n_fft, win).cuda())
    torch.cuda.synchronize()
    assert kstft.launches == before + 1
    assert float((got - ref).abs().max()) <= chip_smoke.FRONTEND_LIMIT * float(ref.abs().max())
    assert chip_smoke.f64_rel(got, ref64) <= 2.0 * chip_smoke.f64_rel(ref, ref64)
    xa, xb = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    dproj = torch.randn_like(got)
    kstft.stft_frontend_projection(xa, n_fft, hop, win).backward(dproj)
    kstft.stft_frontend_projection_plain(xb, n_fft, hop, basis).backward(dproj)
    assert float((xa.grad - xb.grad).abs().max()) <= 1e-5 * float(xb.grad.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("n_fft", [768, 4096])
def test_stft_frontend_kernel_refuses_other_sizes_on_card(n_fft):
    """Only the FFT sizes the kernel instantiates: a size that is not a power
    of two, or one past 2048, raises and launches nothing."""
    _need_cuda()
    x = torch.zeros((2, 4096), device="cuda")
    before = kstft.launches
    with pytest.raises(ValueError, match="FFT size"):
        kstft.stft_frontend_kernel(x, n_fft, 256, torch.ones(n_fft, device="cuda"))
    assert kstft.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("cin", [1, 40])
def test_conv_kernels_and_gradients_on_card(cin, dtype):
    """Kernels 10 and 11 through ``conv1d_same``'s autograd at conv1's and the
    prefilter's shapes: y, dx and dW on the card against the same Function
    on the CPU (its plain versions: F.conv1d and conv1d_weight on the
    rounded operands), within chip_smoke's CONV_LIMIT."""
    _need_cuda()
    rng = np.random.default_rng(cin)
    x = torch.from_numpy(rng.standard_normal((1024, cin, 285)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((40, cin, 15)) / np.sqrt(15 * cin))
                         .astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal((1024, 40, 285)).astype(np.float32))
    before = (kconv.launches, kconv.dw_launches)
    outs = []
    for dev in ("cuda", "cpu"):
        xx, ww = x.to(dev).requires_grad_(True), w.to(dev).requires_grad_(True)
        y = kconv.conv1d_same(xx, ww, dtype)
        y.backward(dy.to(dev))
        outs.append([t.cpu() for t in (y.detach(), xx.grad, ww.grad)])
    assert (kconv.launches, kconv.dw_launches) == (before[0] + 2, before[1] + 1)
    for g, r in zip(*outs):
        assert float((g - r).abs().max()) <= chip_smoke.CONV_LIMIT * float(r.abs().max())


def _conv_case(b, w, cin, cout, k, seed, device="cuda"):
    """Inputs on the card, with the port's precision policy: the plain
    versions' cuDNN convolutions in full f32 (TF32 off)."""
    set_precision_policy()
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, cin, w)).astype(np.float32)
    weight = (rng.standard_normal((cout, cin, k)) / np.sqrt(k * cin)).astype(np.float32)
    dy = rng.standard_normal((b, cout, w)).astype(np.float32)
    return tuple(torch.from_numpy(a).to(device) for a in (x, weight, dy))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("cin", [1, 40])
def test_conv_kernels_bit_equal_and_float64_close_on_card(cin, dtype):
    """At conv1's and the prefilter's shapes: two launches of each kernel on
    the same inputs are bit-equal (no atomics, fixed-order sums), and against
    a float64 conv of the same rounded operands each kernel's error is at
    most 2x the plain f32 version's (chip_smoke's check_conv)."""
    _need_cuda()
    x, w, dy = _conv_case(1024, 285, cin, 40, 15, seed=cin)
    outs = [(kconv.conv1d_forward(x, w, dtype), kconv.conv1d_weight(x, dy, 15, dtype))
            for _ in range(2)]
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*outs))
    xr, wr, dyr = (kconv.round_to(t, dtype).double() for t in (x, w, dy))
    y64 = torch.nn.functional.conv1d(xr, wr, padding=7)
    dw64 = torch.nn.grad.conv1d_weight(xr, tuple(w.shape), dyr, padding=7)
    plain = (kconv.conv1d_same_plain(x, w, dtype), kconv.conv1d_weight_plain(x, dy, 15, dtype))
    for got, ref, ref64 in zip(outs[0], plain, (y64, dw64)):
        assert chip_smoke.f64_rel(got, ref64) <= 2.0 * chip_smoke.f64_rel(ref, ref64)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,w,cin,cout,k", [(4, 285, 1, 40, 15), (4, 285, 40, 40, 15),
                                            (3, 64, 8, 16, 15), (8, 128, 4, 4, 15),
                                            (5, 33, 3, 7, 5), (1, 285, 2, 3, 1),
                                            (24, 285, 4, 8, 15), (2, 600, 40, 40, 15)])
def test_conv_kernels_match_plain_at_every_shape_on_card(b, w, cin, cout, k, dtype):
    """tests/test_conv_pallas.py's SHAPES, written out (that file imports JAX,
    which the CUDA test command runs without), and a row wider than two strips:
    forward, dx and dW within chip_smoke's CONV_LIMIT of the plain version,
    one launch of B10 per forward or dx and of B11 per dW."""
    _need_cuda()
    x, wt, dy = _conv_case(b, w, cin, cout, k, seed=b + w + k)
    wflip = wt.flip(-1).transpose(0, 1)
    before = (kconv.launches, kconv.dw_launches)
    got = (kconv.conv1d_forward(x, wt, dtype), kconv.conv1d_forward(dy, wflip, dtype),
           kconv.conv1d_weight(x, dy, k, dtype))
    ref = (kconv.conv1d_same_plain(x, wt, dtype), kconv.conv1d_same_plain(dy, wflip, dtype),
           kconv.conv1d_weight_plain(x, dy, k, dtype))
    torch.cuda.synchronize()
    assert (kconv.launches, kconv.dw_launches) == (before[0] + 2, before[1] + 1)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        assert float((g - r).abs().max()) <= chip_smoke.CONV_LIMIT * float(r.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("k,cin,cout", [(2, 4, 4), (17, 4, 4), (15, 41, 4), (15, 4, 41)])
def test_conv_kernels_refuse_other_shapes_on_card(k, cin, cout):
    """An even k, k > 15 or more than 40 channels raises and launches
    nothing: no fallback to another path."""
    _need_cuda()
    x, wt, dy = _conv_case(2, 64, cin, cout, k, seed=0)
    before = (kconv.launches, kconv.dw_launches)
    with pytest.raises(ValueError, match="conv1d_forward"):
        kconv.conv1d_forward(x, wt)
    with pytest.raises(ValueError, match="conv1d_weight"):
        kconv.conv1d_weight(x, dy, k)
    assert (kconv.launches, kconv.dw_launches) == before
