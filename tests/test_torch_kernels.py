"""The port's kernel wrappers.

On a CPU tensor each wrapper runs its plain PyTorch version and launches
nothing; on any other non-CUDA device it raises (no fallback). The tests
marked ``cuda`` build the CUDA sources and hold each kernel against its
plain version at the serving shapes; they skip on a machine without a GPU.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from sot_tpu_torch.ops.cqt import cqt_bank
from sot_tpu_torch.ops.kernels import cqt as kcqt
from sot_tpu_torch.ops.kernels import synth as ksynth


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
