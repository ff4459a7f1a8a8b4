"""The plain reference of PESTO-SOT, the model of the configuration files
that name ``"model": "pesto_sot"``: the PESTO encoder, the soft-argmax
pitch head, the frozen harmonic synth, the MSS and SOT (W2) losses and
Adam with coupled L2, in float32 PyTorch on one device; the parameter spec
and the weights drawn from one U[0, 1) vector.

It reads a configuration file (``portbench/configs/<name>.json``), takes
the weights and clips the benchmark made from the seed, and imports
nothing of the program. Conventions it follows where a function has a kink
(the program documents the same): relu's gradient is 0 at 0,
minimum/maximum split a tie's gradient in halves, amax splits it evenly,
|z| has gradient 0 at z = 0.

``Precision`` picks the configuration's precision (float32 with TF32 off in
cuBLAS and cuDNN, the synth's phase accumulated in float64) or the
control's, the next below it: TF32 for every matmul and convolution (on the
card the library switches, on the CPU the operands rounded to TF32's
10-bit mantissa) and the phase accumulated in float32.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import dsp

Params = Dict[str, torch.Tensor]


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest value with a 10-bit mantissa (ties away)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class Precision:
    """``lower=False``: the configuration's precision. ``lower=True``: the
    control's."""

    def __init__(self, lower: bool = False):
        self.tf32 = lower
        self.phase_dtype = torch.float32 if lower else torch.float64

    @contextlib.contextmanager
    def active(self, device: torch.device) -> Iterator[None]:
        saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        on_card = device.type == "cuda" and self.tf32
        torch.backends.cuda.matmul.allow_tf32 = on_card
        torch.backends.cudnn.allow_tf32 = on_card
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved

    def _operand(self, x: torch.Tensor) -> torch.Tensor:
        if not self.tf32 or x.device.type != "cpu":
            return x
        # rounded in the forward, the gradient passed through unchanged
        return x + (round_tf32(x.detach()) - x.detach())

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self._operand(a) @ self._operand(b)

    def conv(self, x, w, b, padding: int) -> torch.Tensor:
        return F.conv1d(self._operand(x), self._operand(w), b, padding=padding)


# ---------------------------------------------------------------------------
# Shapes and weights
# ---------------------------------------------------------------------------


def n_bins(cfg: dict) -> int:
    return dsp.cqt_bins(cfg["sample_rate"], cfg["cqt_fmin"], cfg["cqt_bins_per_semitone"])


def param_spec(cfg: dict) -> List[Tuple[str, Tuple[int, ...], str, int]]:
    """(name, shape, kind, fan_in) of every encoder parameter, named as the
    program's state dict names them. kind: "uniform" for U(+-1/sqrt(fan_in)),
    "norm_weight" / "norm_bias" for the layer norm's affine."""
    enc = cfg["encoder"]
    ch, k, nb = enc["channels"], enc["kernel_size"], n_bins(cfg)
    spec = [("layernorm.weight", (1, nb), "norm_weight", 0),
            ("layernorm.bias", (1, nb), "norm_bias", 0)]

    def conv(name, cin, cout, ks):
        spec.append((f"{name}.weight", (cout, cin, ks), "uniform", cin * ks))
        spec.append((f"{name}.bias", (cout,), "uniform", cin * ks))

    conv("conv1", 1, ch[0], k)
    for i in range(enc["n_prefilt_layers"] - 1):
        conv(f"prefilt.{i}", ch[0], ch[0], k)
    conv("conv2", ch[0], ch[1], 1)
    conv("conv3", ch[1], ch[2], 1)
    conv("conv4a", ch[2], ch[3], 1)
    conv("conv4b", ch[3], ch[4], 1)
    feat = ch[4] * nb
    spec.append(("frequency.0.weight", (feat + nb - 1,), "uniform", feat + nb - 1))
    spec.append(("weights.weight", (cfg["n_modes"], feat), "uniform", feat))
    spec.append(("weights.bias", (cfg["n_modes"],), "uniform", feat))
    return spec


def weights_from_uniform(cfg: dict, u: torch.Tensor) -> Params:
    """Every parameter from one flat tensor of U[0, 1) draws (the benchmark
    makes it on the device from the seed, in one call): U(+-1/sqrt(fan_in))
    for the convolutions and heads, 1 +- 0.1 and +- 0.1 for the layer norm's
    affine (a trained model's is not the identity)."""
    out: Params = {}
    at = 0
    for name, shape, kind, fan_in in param_spec(cfg):
        n = int(np.prod(shape))
        v = u[at:at + n].reshape(shape) * 2.0 - 1.0
        at += n
        if kind == "uniform":
            out[name] = v * (1.0 / math.sqrt(fan_in))
        elif kind == "norm_weight":
            out[name] = 1.0 + 0.1 * v
        else:
            out[name] = 0.1 * v
    return out


# the parameters that act on the harmonic amplitudes alone: their gradient
# reaches the loss through the synth's amplitude path and not through the
# pitch, whose phase (~1e4 rad at a clip's end) amplifies rounding
AMPLITUDE_HEAD = ("weights.weight", "weights.bias")


def n_params(cfg: dict) -> int:
    return sum(int(np.prod(shape)) for _, shape, _, _ in param_spec(cfg))


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


class Model:
    """The tables of one configuration on one device."""

    def __init__(self, cfg: dict, device: torch.device, precision: Optional[Precision] = None):
        self.cfg = cfg
        self.device = torch.device(device)
        self.precision = precision or Precision()
        sr, fmin, bps = cfg["sample_rate"], cfg["cqt_fmin"], cfg["cqt_bins_per_semitone"]
        self.n_bins = n_bins(cfg)
        bpo = 12 * bps
        self.bank = torch.from_numpy(dsp.cqt_bank(sr, fmin, self.n_bins, bpo)).to(self.device)
        f = dsp.cqt_frequencies(sr, fmin, self.n_bins, bpo).astype(np.float32)
        # the pitch range: the first and last CQT bins, log-scaled through MIDI
        self.midi_lo, self.midi_hi = (float(12.0 * (np.log2(np.float64(v)) - np.log2(440.0)) + 69.0)
                                      for v in (f[0], f[-1]))
        self.positions = torch.linspace(0.0, 1.0, self.n_bins, device=self.device)
        self.losses = cfg["losses"]
        if cfg["transform"] == "stft":
            n_fft = cfg["transform_n_fft"]
            self.transform_window = torch.from_numpy(
                dsp.window(cfg["transform_window"], n_fft)).to(self.device)
            freqs = np.fft.rfftfreq(n_fft, d=1.0 / sr).astype(np.float32)
            self.grid = torch.from_numpy(freqs / freqs.max()).to(self.device)
        self.mss_windows = {n: torch.from_numpy(dsp.window("hann", n)).to(self.device)
                            for lc in self.losses if lc["kind"] == "mss" for n in lc["fft_sizes"]}

    # -- encoder ------------------------------------------------------------

    def encode(self, p: Params, feats: torch.Tensor,
               dropout_gen: Optional[torch.Generator] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """CQT frames [N, n_bins] -> (frequency logits [N, n_bins], harmonic
        amplitudes [N, n_modes]). In training (``dropout_gen`` given) the
        dropout keeps an activation where one U[0, 1) draw of the dropout
        input's shape from ``dropout_gen`` is below 1 - p."""
        enc, pr = self.cfg["encoder"], self.precision
        slope, pad = enc["a_lrelu"], enc["kernel_size"] // 2
        x = F.layer_norm(feats[:, None, :], (1, self.n_bins), p["layernorm.weight"],
                         p["layernorm.bias"], eps=1e-5)
        x = F.leaky_relu(pr.conv(x, p["conv1.weight"], p["conv1.bias"], pad), slope)
        for i in range(enc["n_prefilt_layers"] - 1):
            x = F.leaky_relu(pr.conv(x, p[f"prefilt.{i}.weight"], p[f"prefilt.{i}.bias"], pad),
                             slope) + x
        for name in ("conv2", "conv3", "conv4a"):
            x = F.leaky_relu(pr.conv(x, p[f"{name}.weight"], p[f"{name}.bias"], 0), slope)
        if dropout_gen is not None:
            keep = 1.0 - enc["p_dropout"]
            draw = torch.rand(x.shape, device=dropout_gen.device,
                              generator=dropout_gen).to(x.device)
            x = torch.where(draw < keep, x / keep, torch.zeros_like(x))
        x = pr.conv(x, p["conv4b.weight"], p["conv4b.bias"], 0)
        feat = x.reshape(x.shape[0], -1)
        w = p["frequency.0.weight"]
        n_in, n_out = feat.shape[1], self.n_bins
        idx = (torch.arange(n_in, device=w.device)[:, None] + (n_out - 1)
               - torch.arange(n_out, device=w.device)[None, :])
        logits = pr.mm(feat, w[idx])
        z = pr.mm(feat, p["weights.weight"].t()) + p["weights.bias"]
        amps = 2.0 * torch.sigmoid(z) ** math.log(10.0) + 1e-7
        return logits, amps

    def forward(self, p: Params, x: torch.Tensor, dropout_gen: Optional[torch.Generator] = None,
                temperature: Optional[float] = None) -> Dict[str, torch.Tensor]:
        """Clips [B, T] -> pitch_unit, pitch_hz [B, F, 1], weights [B, F, K], x_hat [B, T]."""
        cfg = self.cfg
        batch = x.shape[0]
        feats = dsp.cqt_magnitude(x[:, :-1], self.bank, cfg["cqt_hop_length"], self.precision.mm)
        n_frames = feats.shape[1]
        logits, amps = self.encode(p, feats.reshape(-1, self.n_bins), dropout_gen)
        t = cfg["temperature"] if temperature is None else temperature
        probs = torch.softmax(logits / t, dim=-1)
        unit = torch.sum(probs * self.positions, dim=-1)
        midi = self.midi_lo + (self.midi_hi - self.midi_lo) * unit
        hz = 440.0 * 2.0 ** ((midi - 69.0) / 12.0)
        out = {"pitch_unit": unit.reshape(batch, n_frames, 1),
               "pitch_hz": hz.reshape(batch, n_frames, 1),
               "weights": amps.reshape(batch, n_frames, -1)}
        out["x_hat"] = self.render(out["weights"], out["pitch_hz"])
        return out

    def render(self, weights: torch.Tensor, pitch_hz: torch.Tensor) -> torch.Tensor:
        """The synth alone on given controls (to judge a served x_hat)."""
        return dsp.synth(weights, pitch_hz, self.cfg["n_samples"], self.cfg["sample_rate"],
                         self.precision.phase_dtype)

    # -- losses -------------------------------------------------------------

    def loss_terms(self, x: torch.Tensor, x_hat: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Each loss term times its weight, by kind ("mss", "wasserstein")."""
        cfg = self.cfg
        terms: Dict[str, torch.Tensor] = {}
        for lc in self.losses:
            if lc["kind"] == "mss":
                value = x.new_zeros(())
                for n in lc["fft_sizes"]:
                    w = self.mss_windows[n]
                    a = dsp.stft_magnitude(x, n, n // 4, w)
                    b = dsp.stft_magnitude(x_hat, n, n // 4, w)
                    if lc["mag_weight"] > 0:
                        value = value + lc["mag_weight"] * _mean_diff(a, b, lc["loss_type"])
                    if lc["logmag_weight"] > 0:
                        value = value + lc["logmag_weight"] * _mean_diff(
                            _safe_log(a), _safe_log(b), lc["loss_type"])
            else:
                n_fft, hop = cfg["transform_n_fft"], cfg["transform_hop"]
                sx = dsp.stft_magnitude(x, n_fft, hop, self.transform_window)
                sy = dsp.stft_magnitude(x_hat, n_fft, hop, self.transform_window)
                value = torch.mean(w2_rows(self.grid, sx.reshape(-1, sx.shape[-1]),
                                           sy.reshape(-1, sy.shape[-1]), lc))
            terms[lc["kind"]] = value * lc["weight"]
        return terms


def _mean_diff(a: torch.Tensor, b: torch.Tensor, loss_type: str) -> torch.Tensor:
    d = a - b
    return torch.mean(torch.abs(d)) if loss_type.upper() == "L1" else torch.mean(d * d)


def _safe_log(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    return torch.log(torch.where(x <= eps, torch.full_like(x, eps), x))


def _safe_divide(num: torch.Tensor, den: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    return num / torch.where(den <= eps, torch.full_like(den, eps), den)


# ---------------------------------------------------------------------------
# SOT: W_2^2 between the spectra's row distributions on one grid
# ---------------------------------------------------------------------------


def w2_rows(grid: torch.Tensor, target: torch.Tensor, value: torch.Tensor, lc: dict
            ) -> torch.Tensor:
    """W_p^p [rows] between each row of the target and value spectra
    [rows, n] on the grid [n]: squared magnitudes under ``square_dist``,
    both divided by the target's mass (``dont_normalize``; else each by its
    own), CDFs by a float64 prefix rounded to float32, clipped at the cap
    (the largest CDF value <= 1 of either side under
    ``limit_quantile_range``, else the larger mass), one tail lane at the
    cap, the grid's last point repeated; then
      W = sum_ij relu(min(a_i, b_j) - max(a_{i-1}, b_{j-1})) |g_i - g_j|^p.
    The target is data: its CDF gets no gradient."""
    target = target.detach()
    if lc["square_dist"]:
        target, value = target * target, value * value
    mass = torch.sum(target, dim=1, keepdim=True)
    u = _safe_divide(target, mass)
    v = _safe_divide(value, mass if lc["dont_normalize"]
                     else torch.sum(value, dim=1, keepdim=True))
    cu = torch.cumsum(u, dim=-1, dtype=torch.float64).to(torch.float32)
    cv = torch.cumsum(v, dim=-1, dtype=torch.float64).to(torch.float32)
    if lc["limit_quantile_range"]:
        zero = cu.new_zeros(())
        cap = torch.maximum(torch.amax(torch.where(cu <= 1.0, cu, zero), dim=-1),
                            torch.amax(torch.where(cv <= 1.0, cv, zero), dim=-1))[:, None]
    else:
        cap = torch.maximum(cu[:, -1], cv[:, -1])[:, None]
    alpha = torch.cat([torch.minimum(cu, cap), cap], dim=-1).detach()
    beta = torch.cat([torch.minimum(cv, cap), cap], dim=-1)
    g = torch.cat([grid, grid[-1:]])
    return _PlaneW.apply(alpha, beta, g, float(lc["p"]))


_CHUNK_CELLS = 1 << 24


def _plane_rows(a, b, g, p):
    """W per row of a chunk, summed in float64."""
    prev = lambda t: F.pad(t, (1, 0))[:, :-1]  # noqa: E731
    mu = torch.relu(torch.minimum(a[:, :, None], b[:, None, :])
                    - torch.maximum(prev(a)[:, :, None], prev(b)[:, None, :]))
    d = g[:, None] - g[None, :]
    dist = d * d if p == 2.0 else torch.abs(d) ** p
    return torch.sum((mu * dist).to(torch.float64), dim=(1, 2)).to(torch.float32)


class _PlaneW(torch.autograd.Function):
    """The dense sum in row chunks (a [rows, n, n] plane at once would not
    fit); the backward differentiates each chunk again by autograd."""

    @staticmethod
    def forward(ctx, alpha, beta, g, p):
        ctx.save_for_backward(alpha, beta, g)
        ctx.p = p
        rows, n = alpha.shape
        step = max(1, _CHUNK_CELLS // (n * n))
        return torch.cat([_plane_rows(alpha[s:s + step], beta[s:s + step], g, p)
                          for s in range(0, rows, step)])

    @staticmethod
    def backward(ctx, wbar):
        alpha, beta, g = ctx.saved_tensors
        rows, n = alpha.shape
        step = max(1, _CHUNK_CELLS // (n * n))
        db = torch.empty_like(beta)
        for s in range(0, rows, step):
            with torch.enable_grad():
                b = beta[s:s + step].detach().requires_grad_(True)
                w = _plane_rows(alpha[s:s + step], b, g, ctx.p)
                (gb,) = torch.autograd.grad(w, b, wbar[s:s + step])
            db[s:s + step] = gb
        return None, db, None, None


# ---------------------------------------------------------------------------
# Training: three steps of loss, backward and Adam with coupled L2
# ---------------------------------------------------------------------------


def first_gradient(model: Model, params: Params, x: torch.Tensor,
                   dropout_gen: torch.Generator
                   ) -> Tuple[Dict[str, float], Dict[str, torch.Tensor]]:
    """(loss terms and "total", gradient by leaf) of one batch at
    ``params``, the dropout drawn from ``dropout_gen``."""
    p = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    out = model.forward(p, x, dropout_gen=dropout_gen)
    terms = model.loss_terms(x, out["x_hat"])
    loss = sum(terms.values())
    # a leaf the loss does not reach has gradient 0
    grads = torch.autograd.grad(loss, list(p.values()), allow_unused=True)
    return ({**{k: float(v.detach()) for k, v in terms.items()}, "total": float(loss.detach())},
            {k: torch.zeros_like(v) if g is None else g for (k, v), g in zip(p.items(), grads)})


def train_steps(model: Model, params: Params, batches: Sequence[torch.Tensor],
                dropout_gen: torch.Generator, lr: float, weight_decay: float,
                betas=(0.9, 0.999), eps: float = 1e-8) -> Dict[str, object]:
    """Run len(batches) updates from ``params`` (copied). The dropout draws
    come from ``dropout_gen``, one U[0, 1) tensor of the dropout's input
    shape per step. Returns each step's loss terms and total, the first
    update's gradient as Adam takes it (plus the coupled decay), and the
    parameters after the last."""
    p = {k: v.detach().clone() for k, v in params.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    losses, first_grad = [], None
    b1, b2 = betas
    for t, x in enumerate(batches, start=1):
        loss, grads = first_gradient(model, p, x, dropout_gen)
        losses.append(loss)
        with torch.no_grad():
            g = {k: grads[k] + weight_decay * p[k] for k in p}
            if first_grad is None:
                first_grad = {k: gk.clone() for k, gk in g.items()}
            for k in p:
                m[k] = b1 * m[k] + (1.0 - b1) * g[k]
                v2[k] = b2 * v2[k] + (1.0 - b2) * g[k] * g[k]
                m_hat = m[k] / (1.0 - b1 ** t)
                v_hat = v2[k] / (1.0 - b2 ** t)
                p[k] = p[k] - lr * m_hat / (torch.sqrt(v_hat) + eps)
    return {"losses": losses, "first_grad": first_grad, "params": p}
