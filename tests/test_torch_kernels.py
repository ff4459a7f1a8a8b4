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

from sot_tpu_torch.ops.cqt import cqt_bank
from sot_tpu_torch.ops.kernels import cqt as kcqt
from sot_tpu_torch.ops.kernels import merge as kmerge
from sot_tpu_torch.ops.kernels import refgrad as krefgrad
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


def test_cqt_split_k_divides_the_window():
    assert kcqt._splits(32768) == 16
    assert 1024 % (kcqt._splits(1024) * 8) == 0


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")


@pytest.mark.cuda
def test_cqt_kernel_matches_plain_on_card():
    _need_cuda()
    xpad, bank = _cqt_inputs("cuda", batch=64)
    before = kcqt.launches
    got = kcqt.cqt_project(xpad, bank, 256, 16, 570)
    ref = kcqt.cqt_project_plain(xpad, bank, 256, 16, 570)
    torch.cuda.synchronize()
    assert kcqt.launches == before + 1
    assert float((got - ref).abs().max() / ref.abs().max()) <= 1e-4


@pytest.mark.cuda
def test_synth_kernel_matches_plain_on_card():
    _need_cuda()
    amps, freqs = _synth_inputs("cuda", batch=64)
    audio, env_f, env_a = ksynth.synth_render(amps, freqs, 4096, 16000,
                                              debug_envelopes=True)
    ref_f, ref_a = ksynth.synth_envelopes_plain(amps, freqs, 4096, 16000)
    ref = ksynth.synth_render_plain(amps, freqs, 4096, 16000)
    torch.cuda.synchronize()
    assert torch.equal(env_f, ref_f) and torch.equal(env_a, ref_a)
    assert float((audio - ref).abs().max()) <= 2e-2
    assert np.corrcoef(audio.cpu().numpy().ravel(), ref.cpu().numpy().ravel())[0, 1] > 0.9999


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
