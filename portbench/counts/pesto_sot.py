"""The counts of PESTO-SOT (the PESTO encoder on the CQT, the frozen
harmonic synth): a clip's frames and the operations of a request and of a
train step, from the configuration's shapes."""

from __future__ import annotations

import math
from typing import List, Tuple

from portbench.counts import conv_flops


def frames_per_clip(cfg: dict) -> int:
    """CQT frames of one clip: the last sample dropped, centred framing."""
    return (cfg["n_samples"] - 1) // cfg["cqt_hop_length"] + 1


def n_bins(cfg: dict) -> int:
    fmin, sr = cfg["cqt_fmin"], cfg["sample_rate"]
    return int(math.floor(12 * math.log2(sr / 2) - 12 * math.log2(fmin))) * cfg["cqt_bins_per_semitone"]


def convs(cfg: dict) -> List[Tuple[str, int, int, int]]:
    """(name, c_in, c_out, kernel) of the encoder's convolutions in order."""
    enc = cfg["encoder"]
    ch, k = enc["channels"], enc["kernel_size"]
    out = [("conv1", 1, ch[0], k)]
    out += [(f"prefilt.{i}", ch[0], ch[0], k) for i in range(enc["n_prefilt_layers"] - 1)]
    out += [("conv2", ch[0], ch[1], 1), ("conv3", ch[1], ch[2], 1),
            ("conv4a", ch[2], ch[3], 1), ("conv4b", ch[3], ch[4], 1)]
    return out


def heads_flops(cfg: dict, rows: int) -> float:
    """The Toeplitz frequency head and the amplitude head, forward."""
    feat = cfg["encoder"]["channels"][4] * n_bins(cfg)
    return 2.0 * feat * (n_bins(cfg) + cfg["n_modes"]) * rows


def cqt_flops(cfg: dict, clips: int) -> float:
    """The CQT projection over each bin's non-zero support (l_k taps, real
    and imaginary parts) for every frame."""
    bpo = 12 * cfg["cqt_bins_per_semitone"]
    q = 1.0 / (2.0 ** (1.0 / bpo) - 1.0)
    taps = sum(math.ceil(q * cfg["sample_rate"] / (cfg["cqt_fmin"] * 2.0 ** (k / bpo)))
               for k in range(n_bins(cfg)))
    return 2.0 * 2.0 * taps * frames_per_clip(cfg) * clips


def forward_flops(cfg: dict, clips: int) -> float:
    """A served request: the CQT, the encoder's convolutions and heads."""
    rows, length = clips * frames_per_clip(cfg), n_bins(cfg)
    enc = sum(conv_flops(ci, co, k, length, rows) for _, ci, co, k in convs(cfg))
    return cqt_flops(cfg, clips) + enc + heads_flops(cfg, rows)


def train_step_flops(cfg: dict, clips: int) -> float:
    """A train step: the forward, then every layer's weight gradient and
    every input gradient but the first convolution's (the features need
    none)."""
    rows, length = clips * frames_per_clip(cfg), n_bins(cfg)
    layers = [conv_flops(ci, co, k, length, rows) for _, ci, co, k in convs(cfg)]
    heads = heads_flops(cfg, rows)
    backward = sum(layers) + heads + sum(layers[1:]) + heads
    return forward_flops(cfg, clips) + backward
