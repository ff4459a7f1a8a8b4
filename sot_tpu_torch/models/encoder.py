"""PESTO-style CNN pitch encoder (L3), port of ``sot_tpu/models/encoder.py``.

  * LayerNorm over (channel, bins) with a per-element affine
  * k=15 'same' conv1 + residual prefilt, then 1x1 convs 40 -> 30 -> 30 -> 10
    -> 3, leaky-ReLU 0.3, dropout 0.5 before the last conv
  * channel-major flatten into the heads
  * ``ToeplitzLinear`` — a linear map constrained to a Toeplitz matrix
    (in+out-1 parameters), built as reversed sliding windows of the weight
    vector and applied with one matmul
  * 'frequency' logits (Toeplitz), 'weights' (n_modes harmonic amplitudes via
    exp-sigmoid, dense), optional 'gain'

Convolutions run in PyTorch's NCW layout. By default the k > 1 'same'
convolutions are ``F32Conv1d``: on the GPU the hand-written f32 kernels of
``ops/kernels/conv.conv1d_f32`` (a layer their shape rule does not take
raises there), on the CPU ``nn.Conv1d``'s own forward. With ``conv_dtype`` (the
``conv`` kernel gate, ``SOT_TPU_CONV_PALLAS`` in the JAX package) the
k > 1 'same' convolutions (``conv1``, ``prefilt*``) run on the hand-written
kernels B10/B11 with operands rounded to that type (``KernelConv1d``,
whose parameters and state-dict keys are those of ``nn.Conv1d``). With
``conv_bf16`` (``SOT_TPU_CONV_BF16``) the stack computes in bf16 as Flax's
``nn.Conv(dtype=bfloat16)`` does (``Bf16Conv1d``); the k > 1 convs stay on
the kernels when both are set, as in the JAX package.
Parameters use PyTorch's default
initialisation (U(+-1/sqrt(fan_in))), drawn from an optional explicit
``torch.Generator``. ~46K parameters in the paper configuration. Dropout
draws its masks from the generator set on ``encoder.dropout.generator``
(the trainer seeds one on the device from the config's seed).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sot_tpu_torch.device import device_constant
from sot_tpu_torch.ops.kernels import conv as kconv
from sot_tpu_torch.ops.kernels.conv import conv1d_same
from sot_tpu_torch.ops.numerics import exp_sigmoid


def _uniform_(p: torch.Tensor, fan_in: int, generator: Optional[torch.Generator]) -> None:
    """U(+-1/sqrt(fan_in)), drawn on the generator's device (a CPU generator
    gives a parameter on the card the values it gives one on the CPU)."""
    bound = 1.0 / math.sqrt(fan_in)
    with torch.no_grad():
        if generator is None or generator.device == p.device:
            p.uniform_(-bound, bound, generator=generator)
        else:
            p.copy_(torch.empty(p.shape, dtype=p.dtype, device=generator.device)
                    .uniform_(-bound, bound, generator=generator))


class GeneratorDropout(nn.Module):
    """Inverted dropout whose mask comes from ``self.generator`` (a
    ``torch.Generator`` on the input's device, or None for the default one):
    where(keep, x / (1 - p), 0) in training mode, identity in eval mode.

    ``shard`` = (index, count) says that x is block ``index`` of ``count``
    equal row blocks of a global batch (a data-parallel rank's rows): the
    mask is drawn for the global batch, as one process drawing for all of
    it would, and this block's rows are kept. None (one process) draws for
    x alone."""

    def __init__(self, p: float):
        super().__init__()
        self.p = p
        self.generator: Optional[torch.Generator] = None
        self.shard: Optional[Tuple[int, int]] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        keep = 1.0 - self.p
        if self.shard is None:
            draw = torch.rand(x.shape, device=x.device, generator=self.generator)
        else:
            index, count = self.shard
            rows = x.shape[0]
            draw = torch.rand((count * rows,) + tuple(x.shape[1:]), device=x.device,
                              generator=self.generator)[index * rows:(index + 1) * rows]
        mask = draw < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))


class KernelConv1d(nn.Conv1d):
    """An ``nn.Conv1d`` with odd kernel size and 'same' padding whose
    forward is the hand-written conv (``ops/kernels/conv.conv1d_same``,
    kernels B10/B11) with operands rounded to ``compute_dtype``; the bias is
    added after it in f32, as the JAX package's ``_PallasConvInner`` adds
    it. Parameters, initialisation and state-dict keys are the base
    class's."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__(in_channels, out_channels, kernel_size, padding=(kernel_size - 1) // 2)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv1d_same(x, self.weight, self.compute_dtype) + self.bias[:, None]


class F32Conv1d(nn.Conv1d):
    """An ``nn.Conv1d`` with 'same' padding whose forward on a CUDA tensor
    is ``kconv.conv1d_f32`` (the kernels of ``csrc/conv_f32.cu``, forward,
    input and weight gradients; the bias added after the sum in f32), and on
    the CPU ``nn.Conv1d``'s own. On CUDA a layer the kernels' shape rule
    (``kconv.f32_route``) does not take, or an input the wrapper does not
    take, raises. Parameters, initialisation and state-dict keys are the
    base class's."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int):
        super().__init__(in_channels, out_channels, kernel_size, padding=(kernel_size - 1) // 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.device.type != "cuda":
            return super().forward(x)
        if not kconv.f32_route(self.kernel_size[0], self.in_channels, self.out_channels,
                               self.stride[0], self.padding[0], self.dilation[0], self.groups,
                               self.padding_mode):
            raise ValueError(f"F32Conv1d: the f32 kernels do not take k {self.kernel_size[0]}, "
                             f"C_in {self.in_channels}, C_out {self.out_channels}")
        return kconv.conv1d_f32(x, self.weight, self.bias)


class Bf16Conv1d(nn.Conv1d):
    """An ``nn.Conv1d`` computed as Flax's ``nn.Conv(dtype=bfloat16)``: the
    input, weight and bias cast to bf16, the conv in bf16 with a bf16
    output, then the bias added in bf16 as a separate op (Flax adds it after
    ``conv_general_dilated``; a bias fused into the conv would round once
    where Flax rounds twice). Parameters (f32), initialisation and
    state-dict keys are the base class's."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv1d(x.to(torch.bfloat16), self.weight.to(torch.bfloat16), None, self.stride,
                     self.padding)
        return y + self.bias.to(torch.bfloat16)[:, None]


class ToeplitzLinear(nn.Module):
    """y[b, j] = sum_i x[b, i] * w[i - j + out - 1]."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.weight = nn.Parameter(torch.empty(in_features + out_features - 1))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        _uniform_(self.weight, self.weight.numel(), generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # the matrix as sliding windows of w, reversed: [i, j] = w[i + out - 1 - j].
        # unfold's backward sums each weight's windows in a fixed order, where an
        # indexed gather's backward accumulates in a thread-dependent order.
        return x @ self.weight.unfold(0, self.out_features, 1).flip(1)


class PESTOEncoder(nn.Module):
    """1D CNN over a single CQT frame -> dict of head outputs.

    Input is [batch, n_bins_in] (a flattened (batch*time) of single-channel
    frames). ``conv_dtype``: None for PyTorch's convolutions, else the
    operand type of the hand-written kernels for the k > 1 convs.
    ``conv_bf16``: the conv stack's activations in bf16 (``Bf16Conv1d`` for
    every conv the kernels do not take). With neither, the k > 1 convs are
    ``F32Conv1d``.
    """

    def __init__(
        self,
        n_bins_in: int = 285,
        output_size: int = 285,
        n_modes: int = 20,
        output_splits: Sequence[str] = ("frequency", "weights"),
        harmonic: bool = True,
        n_chan_layers: Sequence[int] = (40, 30, 30, 10, 3),
        n_prefilt_layers: int = 2,
        residual: bool = True,
        kernel_size: int = 15,
        a_lrelu: float = 0.3,
        p_dropout: float = 0.5,
        generator: Optional[torch.Generator] = None,
        conv_dtype: Optional[torch.dtype] = None,
        conv_bf16: bool = False,
    ):
        super().__init__()
        self.n_bins_in = n_bins_in
        self.output_size = output_size
        self.n_modes = n_modes
        self.output_splits = tuple(output_splits)
        self.harmonic = harmonic
        self.residual = residual
        self.a_lrelu = a_lrelu
        ch = list(n_chan_layers)
        if len(ch) < 5:
            ch.append(1)
        pad = (kernel_size - 1) // 2

        self.layernorm = nn.LayerNorm([1, n_bins_in], eps=1e-5)
        conv = Bf16Conv1d if conv_bf16 else nn.Conv1d
        if conv_dtype is None and not conv_bf16 and kernel_size > 1:
            def wide(cin, cout):
                return F32Conv1d(cin, cout, kernel_size)
        elif conv_dtype is None or kernel_size <= 1:
            def wide(cin, cout):
                return conv(cin, cout, kernel_size, padding=pad)
        else:
            def wide(cin, cout):
                return KernelConv1d(cin, cout, kernel_size, conv_dtype)
        self.conv1 = wide(1, ch[0])
        self.prefilt = nn.ModuleList(wide(ch[0], ch[0]) for _ in range(n_prefilt_layers - 1))
        self.conv2 = conv(ch[0], ch[1], 1)
        self.conv3 = conv(ch[1], ch[2], 1)
        self.conv4a = conv(ch[2], ch[3], 1)
        self.dropout = GeneratorDropout(p_dropout)
        self.conv4b = conv(ch[3], ch[4], 1)

        feature_size = n_bins_in * ch[4]
        if "frequency" in self.output_splits:
            n_mean_outs = 1 if harmonic else n_modes
            self.frequency = nn.ModuleList(
                ToeplitzLinear(feature_size, output_size) for _ in range(n_mean_outs))
        if "gain" in self.output_splits:
            self.gain = nn.Linear(feature_size, 1)
        if "weights" in self.output_splits:
            self.weights = nn.Linear(feature_size, n_modes)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Torch-default init: weight and bias ~ U(+-1/sqrt(fan_in))."""
        for m in self.modules():
            if isinstance(m, nn.Conv1d):
                fan_in = m.in_channels * m.kernel_size[0]
                _uniform_(m.weight, fan_in, generator)
                _uniform_(m.bias, fan_in, generator)
            elif isinstance(m, nn.Linear):
                _uniform_(m.weight, m.in_features, generator)
                _uniform_(m.bias, m.in_features, generator)
            elif isinstance(m, ToeplitzLinear):
                m.reset_parameters(generator)
            elif isinstance(m, nn.LayerNorm):
                m.reset_parameters()

    def _leaky_relu(self, y: torch.Tensor) -> torch.Tensor:
        """Flax's ``leaky_relu``: on bf16 activations its slope is a weakly
        typed scalar, rounded to bf16 (0.3 -> 0.30078125) before the
        product."""
        if y.dtype == torch.float32:
            return F.leaky_relu(y, negative_slope=self.a_lrelu)
        slope = device_constant(np.float64(self.a_lrelu), y.device, dtype=y.dtype)
        return torch.where(y >= 0, y, y * slope)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        if x.ndim == 2:
            x = x[:, None, :]  # [batch, 1, bins] (NCW)
        act = self._leaky_relu

        x = self.layernorm(x)
        x = act(self.conv1(x))
        for conv in self.prefilt:
            y = act(conv(x))
            x = y + x if self.residual else y
        x = act(self.conv2(x))
        x = act(self.conv3(x))
        x = act(self.conv4a(x))
        x = self.dropout(x)
        x = self.conv4b(x).float()

        feat = x.reshape(x.shape[0], -1)  # channel-major flatten
        outputs: Dict[str, torch.Tensor] = {}
        if "frequency" in self.output_splits:
            heads = [head(feat) for head in self.frequency]
            outputs["frequency"] = heads[0] if len(heads) == 1 else torch.stack(heads, dim=1)
        if "gain" in self.output_splits:
            outputs["gain"] = exp_sigmoid(self.gain(feat)[..., 0])
        if "weights" in self.output_splits:
            outputs["weights"] = exp_sigmoid(self.weights(feat))
        return outputs


def predict_pitch(
    logits: torch.Tensor,
    estimation_type: str = "soft-argmax",
    temperature: float = 1.0,
    mask: Optional[torch.Tensor] = None,
    kernel_std: float = 0.025,
) -> Dict[str, torch.Tensor]:
    """Normalised pitch in [0, 1] from frequency logits.

    Args:
      logits: [batch, out_size] or [batch, n_modes, out_size].
    Returns dict with 'pitch_unit' (+ 'probabilities' for argmax heads).
    """
    if logits.ndim == 2:
        logits = logits[:, None, :]  # keep the mode axis, as the reference does
    seq_len = logits.shape[-1]
    positions = torch.linspace(0.0, 1.0, seq_len, device=logits.device)

    outputs: Dict[str, torch.Tensor] = {}
    if estimation_type == "soft-argmax":
        if mask is not None:
            if mask.ndim == 2:
                mask = mask[:, None, :]
            logits = logits * mask + 1e-7
        probabilities = torch.softmax(logits / temperature, dim=-1)
        expectation = torch.sum(probabilities * positions, dim=-1)
        outputs.update({"pitch_unit": expectation, "probabilities": probabilities})
    elif estimation_type == "kernel-soft-argmax":
        argmax_pos = torch.argmax(logits, dim=-1).to(torch.float32) / (seq_len - 1)
        kernel = torch.exp(-((positions[None, None, :] - argmax_pos[..., None]) ** 2)
                           / (2.0 * kernel_std ** 2))
        kernel = kernel / torch.sum(kernel, dim=-1, keepdim=True)
        probabilities = torch.softmax(kernel * logits / temperature, dim=-1)
        expectation = torch.sum(probabilities * positions, dim=-1)
        outputs.update({"pitch_unit": expectation, "probabilities": probabilities,
                        "kernel": kernel})
    elif estimation_type == "regression":
        outputs["pitch_unit"] = torch.sigmoid(logits)[..., 0]
    else:
        raise ValueError(f"Unknown estimation_type: {estimation_type}")
    return outputs
