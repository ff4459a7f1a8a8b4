"""Faults planted in the reference put in the program's place, and the
reference's first update under them (for the readings that the training
limits are set from and for the tests that see each fault fail):

* ``w2_value``: the W2 value leaves out the second half of its rows (a
  forward kernel launched on half of its blocks), its mean over all rows;
  the gradient is sound;
* ``w2_grad``: the W2 gradient leaves out the same rows; the value is sound;
* ``conv_dx``: the k = 15 convolutions' input gradient with the kernel
  not flipped;
* ``conv_dw``: the k = 15 convolutions' weight gradient summed over the
  first half of the frames only;
* ``synth_freq``: the synth's frequency gradient left out (the phase is
  built from frequencies with no gradient);
* ``half_batch``: the loss over half of the batch, its mean over that half;
* ``louder``: the synth's output 1% louder where it is produced.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from portbench.compare import pesto_sot as compare
from portbench.reference import dsp
from portbench.reference import pesto_sot as ref_model

FAULTS = ("w2_value", "w2_grad", "conv_dx", "conv_dw", "synth_freq", "half_batch", "louder")
W2_FAULTS = ("w2_value", "w2_grad")


def applicable(cfg: dict) -> List[str]:
    """The faults a configuration can have (no W2 faults without a W2 term)."""
    has_w2 = any(lc["kind"] != "mss" for lc in cfg["losses"])
    return [f for f in FAULTS if has_w2 or f not in W2_FAULTS]


class _Conv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, padding, fault):
        ctx.save_for_backward(x, w)
        ctx.padding, ctx.fault = padding, fault
        return F.conv1d(x, w, b, padding=padding)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        pad = ctx.padding
        w_dx = w.flip(-1) if ctx.fault == "conv_dx" else w
        gx = torch.nn.grad.conv1d_input(x.shape, w_dx, g, padding=pad)
        if ctx.fault == "conv_dw":
            n = x.shape[0] // 2
            gw = torch.nn.grad.conv1d_weight(x[:n], w.shape, g[:n], padding=pad)
        else:
            gw = torch.nn.grad.conv1d_weight(x, w.shape, g, padding=pad)
        return gx, gw, g.sum(dim=(0, 2)), None, None


class _FaultyPrecision(ref_model.Precision):
    def __init__(self, fault: str):
        super().__init__()
        self.fault = fault

    def conv(self, x, w, b, padding: int) -> torch.Tensor:
        if self.fault in ("conv_dx", "conv_dw") and w.shape[-1] > 1:
            return _Conv.apply(x, w, b, padding, self.fault)
        return super().conv(x, w, b, padding)


class FaultyModel(ref_model.Model):
    """The reference with one planted fault."""

    def __init__(self, cfg: dict, device: torch.device, fault: str):
        super().__init__(cfg, device, _FaultyPrecision(fault))
        self.fault = fault

    def render(self, weights: torch.Tensor, pitch_hz: torch.Tensor) -> torch.Tensor:
        if self.fault == "synth_freq":
            pitch_hz = pitch_hz.detach()
        out = super().render(weights, pitch_hz)
        return out * 1.01 if self.fault == "louder" else out

    def loss_terms(self, x: torch.Tensor, x_hat: torch.Tensor) -> Dict[str, torch.Tensor]:
        if self.fault == "half_batch":
            n = x.shape[0] // 2
            x, x_hat = x[:n], x_hat[:n]
        terms = super().loss_terms(x, x_hat)
        if self.fault not in W2_FAULTS:
            return terms
        lc = next(lc for lc in self.losses if lc["kind"] != "mss")
        n_fft, hop = self.cfg["transform_n_fft"], self.cfg["transform_hop"]
        sx = dsp.stft_magnitude(x, n_fft, hop, self.transform_window)
        sy = dsp.stft_magnitude(x_hat, n_fft, hop, self.transform_window)
        rows = ref_model.w2_rows(self.grid, sx.reshape(-1, sx.shape[-1]),
                                 sy.reshape(-1, sy.shape[-1]), lc)
        keep = torch.ones_like(rows)
        keep[rows.shape[0] // 2:] = 0.0
        sound = torch.mean(rows) * lc["weight"]
        faulty = torch.mean(rows * keep) * lc["weight"]
        if self.fault == "w2_value":
            terms["wasserstein"] = faulty.detach() + (sound - sound.detach())
        else:
            terms["wasserstein"] = sound.detach() + (faulty - faulty.detach())
        return terms


def model(cfg: dict, device: torch.device, lower: bool = False,
          fault: Optional[str] = None) -> ref_model.Model:
    if fault:
        return FaultyModel(cfg, device, fault)
    return ref_model.Model(cfg, device, ref_model.Precision(lower))


def first_update(cfg: dict, device: torch.device, weights, batches: Sequence[torch.Tensor],
                 dropout_seed: int, lower: bool = False, fault: Optional[str] = None,
                 draws_on: Optional[torch.device] = None) -> dict:
    """``compare.first_update`` of the reference, the control (``lower``) or
    the reference with ``fault`` planted."""
    return compare.first_update(cfg, device, weights, batches, dropout_seed,
                              model=model(cfg, torch.device(device), lower, fault),
                              draws_on=draws_on)


def one_ulp(weights: Dict[str, torch.Tensor], seed: int) -> Dict[str, torch.Tensor]:
    """Every weight moved by one ulp, up or down as drawn from ``seed``."""
    out = {}
    for i, (k, w) in enumerate(sorted(weights.items())):
        gen = torch.Generator(device=w.device).manual_seed(seed * 131 + i)
        up = torch.randint(0, 2, w.shape, generator=gen, device=w.device).bool()
        inf = torch.full_like(w, float("inf"))
        out[k] = torch.nextafter(w, torch.where(up, inf, -inf))
    return {k: out[k] for k in weights}
