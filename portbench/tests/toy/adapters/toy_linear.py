"""The toy model's program: its linear maps as ``torch`` parameters, the
port's plain synth (``sot_tpu_torch``), ``torch.optim.Adam``."""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from sot_tpu_torch.ops.kernels.synth import synth_render_plain


class Program:
    def __init__(self, cfg: dict, weights: Dict[str, torch.Tensor], device: torch.device):
        self.cfg, self.device = cfg, torch.device(device)
        self.p = {k: v.detach().clone().requires_grad_(True) for k, v in weights.items()}
        self.opt = self.x_all = None

    def render(self, amps: torch.Tensor, pitch_hz: torch.Tensor) -> torch.Tensor:
        k = torch.arange(1, amps.shape[-1] + 1, device=amps.device, dtype=amps.dtype)
        return synth_render_plain(amps, pitch_hz * k, self.cfg["n_samples"],
                                  self.cfg["sample_rate"])

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        cfg, p = self.cfg, self.p
        frames = x.reshape(x.shape[0], -1, cfg["hop"])
        unit = torch.sigmoid(frames @ p["pitch.weight"] + p["pitch.bias"])[..., None]
        pitch_hz = cfg["f0_min"] + (cfg["f0_max"] - cfg["f0_min"]) * unit
        amps = torch.sigmoid(frames @ p["amps.weight"].t() + p["amps.bias"])
        return {"pitch_hz": pitch_hz, "amplitudes": amps, "x_hat": self.render(amps, pitch_hz)}

    def start_training(self, x_all: torch.Tensor, dropout_seed: int) -> None:
        self.x_all = x_all
        self.opt = torch.optim.Adam(list(self.p.values()), lr=self.cfg["learning_rate"],
                                    weight_decay=self.cfg["weight_decay"])

    def train(self, offsets: Sequence[int]) -> Dict[str, torch.Tensor]:
        for o in offsets:
            x = self.x_all[int(o):int(o) + self.cfg["batch_size"]]
            loss = torch.mean(torch.abs(x - self.forward(x)["x_hat"]))
            self.opt.zero_grad()
            loss.backward()
            self.opt.step()
        return {"loss": loss.detach()}

    @staticmethod
    def loss_terms(logs: Dict[str, torch.Tensor]) -> Dict[str, float]:
        return {"total": float(logs["loss"])}

    def params(self) -> Dict[str, torch.Tensor]:
        return {k: v.detach().clone() for k, v in self.p.items()}

    def adam_first_moments(self) -> Dict[str, torch.Tensor]:
        return {k: self.opt.state[v]["exp_avg"].clone() for k, v in self.p.items()}

    def predict(self, x: np.ndarray) -> Dict[str, torch.Tensor]:
        with torch.no_grad():
            return self.forward(torch.as_tensor(x, device=self.device))

    def close(self) -> None:
        self.p = self.opt = self.x_all = None
