"""The benchmark's inputs, made from ``--seed``: the model's weights and
the clips, both on the device and in a few large calls.

Clips follow the paper's synthetic distribution (arXiv 2312.14507, Sec. 4;
the configuration's generator block): f0 ~ U(freq_gen_min, freq_gen_max),
n_sinusoids harmonic amplitudes ~ U(amplitude_min, amplitude_max), the
first harmonic always on and the next ones on up to a count drawn
uniformly, harmonics at or above Nyquist silent; rendered as constant
sinusoids in float64 and stored in float32, each clip peak-normalised to
0.9, as users feed the model.
"""

from __future__ import annotations

from types import ModuleType
from typing import Dict

import numpy as np
import torch


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed of its own for each use of the run's seed."""
    words = np.random.SeedSequence([seed % (1 << 64), *tag.encode()]).generate_state(2, np.uint32)
    return int(words[0]) | (int(words[1] & 0x7FFFFFFF) << 32)


def generator(seed: int, tag: str, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, tag))


def weights(reference: ModuleType, cfg: dict, seed: int,
            device: torch.device) -> Dict[str, torch.Tensor]:
    """Every parameter of the model whose plain reference is ``reference``
    (its ``n_params`` and ``weights_from_uniform``) from one U[0, 1) draw
    on the device."""
    u = torch.rand(reference.n_params(cfg), generator=generator(seed, "weights", device),
                   device=device)
    return {k: v.contiguous() for k, v in reference.weights_from_uniform(cfg, u).items()}


def clips(cfg: dict, n: int, seed: int, tag: str, device: torch.device) -> torch.Tensor:
    """Peak-normalised clips [n, n_samples] float32 on the device."""
    g = generator(seed, tag, device)
    gen = cfg["generator"]
    k, sr, t = gen["n_sinusoids"], cfg["sample_rate"], cfg["n_samples"]
    f0 = gen["freq_gen_min"] + (gen["freq_gen_max"] - gen["freq_gen_min"]) * torch.rand(
        n, generator=g, device=device, dtype=torch.float64)
    amps = gen["amplitude_min"] + (gen["amplitude_max"] - gen["amplitude_min"]) * torch.rand(
        (n, k), generator=g, device=device, dtype=torch.float64)
    n_active = torch.randint(gen["n_sinusoids_min"] - 1, k, (n,), generator=g, device=device)
    harm = torch.arange(k, device=device)
    on = (harm == 0) | (harm < n_active[:, None])
    freqs = f0[:, None] * (harm + 1)
    amps = torch.where(on & (freqs < sr / 2.0), amps, torch.zeros_like(amps))
    time = torch.arange(1, t + 1, device=device, dtype=torch.float64) / sr
    x = torch.zeros((n, t), dtype=torch.float64, device=device)
    for j in range(k):
        x += amps[:, j:j + 1] * torch.sin(2.0 * np.pi * freqs[:, j:j + 1] * time)
    x = x.to(torch.float32)
    peak = torch.amax(torch.abs(x), dim=-1, keepdim=True)
    return x / (peak + 1e-7) * 0.9
