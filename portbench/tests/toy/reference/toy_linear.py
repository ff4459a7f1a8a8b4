"""The plain reference of a toy model: each frame of a clip (``hop``
samples) mapped linearly to a pitch in [f0_min, f0_max] and to
``n_harmonics`` amplitudes in (0, 1), rendered by the reference synth; the
loss the mean |x - x_hat|; Adam with coupled L2."""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from portbench.reference import dsp

Params = Dict[str, torch.Tensor]


def param_spec(cfg: dict) -> List[Tuple[str, Tuple[int, ...]]]:
    hop, k = cfg["hop"], cfg["n_harmonics"]
    return [("pitch.weight", (hop,)), ("pitch.bias", (1,)),
            ("amps.weight", (k, hop)), ("amps.bias", (k,))]


def n_params(cfg: dict) -> int:
    return sum(int(np.prod(shape)) for _, shape in param_spec(cfg))


def weights_from_uniform(cfg: dict, u: torch.Tensor) -> Params:
    """U(+-1/sqrt(hop)) for every parameter, from one flat U[0, 1) tensor."""
    out, at = {}, 0
    for name, shape in param_spec(cfg):
        n = int(np.prod(shape))
        out[name] = (u[at:at + n].reshape(shape) * 2.0 - 1.0) / math.sqrt(cfg["hop"])
        at += n
    return out


def forward(cfg: dict, p: Params, x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Clips [B, T] -> pitch_hz [B, F, 1], amplitudes [B, F, K], x_hat [B, T]."""
    frames = x.reshape(x.shape[0], -1, cfg["hop"])
    unit = torch.sigmoid(frames @ p["pitch.weight"] + p["pitch.bias"])[..., None]
    pitch_hz = cfg["f0_min"] + (cfg["f0_max"] - cfg["f0_min"]) * unit
    amps = torch.sigmoid(frames @ p["amps.weight"].t() + p["amps.bias"])
    x_hat = dsp.synth(amps, pitch_hz, cfg["n_samples"], cfg["sample_rate"])
    return {"pitch_hz": pitch_hz, "amplitudes": amps, "x_hat": x_hat}


def train_steps(cfg: dict, params: Params, batches: Sequence[torch.Tensor],
                betas=(0.9, 0.999), eps: float = 1e-8) -> Dict[str, object]:
    """len(batches) updates from ``params``: each step's loss, the first
    gradient as Adam takes it (with the coupled decay), the parameters
    after the last."""
    lr, wd = cfg["learning_rate"], cfg["weight_decay"]
    p = {k: v.detach().clone() for k, v in params.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    losses, first_grad = [], None
    for t, x in enumerate(batches, start=1):
        leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        loss = torch.mean(torch.abs(x - forward(cfg, leaves, x)["x_hat"]))
        grads = torch.autograd.grad(loss, list(leaves.values()))
        losses.append(float(loss.detach()))
        with torch.no_grad():
            g = {k: gk + wd * p[k] for k, gk in zip(p, grads)}
            if first_grad is None:
                first_grad = g
            for k in p:
                m[k] = betas[0] * m[k] + (1.0 - betas[0]) * g[k]
                v2[k] = betas[1] * v2[k] + (1.0 - betas[1]) * g[k] * g[k]
                m_hat = m[k] / (1.0 - betas[0] ** t)
                v_hat = v2[k] / (1.0 - betas[1] ** t)
                p[k] = p[k] - lr * m_hat / (torch.sqrt(v_hat) + eps)
    return {"losses": losses, "first_grad": first_grad, "params": p}
