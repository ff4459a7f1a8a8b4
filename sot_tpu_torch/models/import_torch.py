"""Reference (Lightning) checkpoint -> the port's encoder ``state_dict``,
port of ``sot_tpu/models/import_torch.py``.

The reference releases Lightning checkpoints whose encoder weights
correspond 1:1 to ``models.encoder.PESTOEncoder``. ``load_reference_state_dict``
reads such a file, ``import_encoder_state`` maps it onto the port's key
names, so ``cli predict / evaluate / analyze --ckpt`` take the published
weights.

Layout mapping (reference -> port):
  layernorm.{weight,bias} [1, bins]            -> layernorm.*  (the same)
  conv1.0 / prefilt_list.p.0 / conv2.0 /
    conv3.0 / conv4.0 / conv4.3 [out, in, k]   -> conv1 / prefilt.p / conv2 /
                                                  conv3 / conv4a / conv4b
                                                  (the same layout)
  linear.frequency.i.weight [1, 1, in+out-1]   -> frequency.i.weight [in+out-1]
      (the reference's ToeplitzLinear is a Conv1d, a cross-correlation, so
       the taps map without a flip: both compute
       y[j] = sum_i x[i] w[i - j + out - 1])
  linear.{weights,gain}.0.{weight,bias}        -> {weights,gain}.*
      ([out, in] on both sides)

Keys the map does not use are ignored. The decoder is parameter-free, and
the optimizer state is not imported (an evaluation-only restore).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

_CONVS = {"conv1": "conv1.0", "conv2": "conv2.0", "conv3": "conv3.0",
          "conv4a": "conv4.0", "conv4b": "conv4.3"}  # conv4: Conv, act, Dropout, Conv
# a key only the reference layout has: its first conv
REFERENCE_MARK = "conv1.0.weight"


def load_reference_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """Read a reference checkpoint file: a Lightning ``.ckpt`` (a dict with a
    ``state_dict`` entry) or a bare ``torch.save`` of a state dict; tensors
    on the CPU."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    sd = blob.get("state_dict", blob) if isinstance(blob, dict) else blob
    return dict(sd)


def _strip_prefix(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Drop the LightningModule's attribute prefix ``encoder.`` (the
    reference's trainer holds the model at ``self.encoder``)."""
    enc = {k[len("encoder."):]: v for k, v in sd.items() if k.startswith("encoder.")}
    return enc if enc else dict(sd)


def is_reference_layout(sd: Mapping[str, torch.Tensor]) -> bool:
    """Whether the state dict ``sd`` is in the reference layout (with or
    without the ``encoder.`` prefix)."""
    return REFERENCE_MARK in _strip_prefix(sd)


def reference_key(key: str) -> str:
    """The reference layout's name of the port's state-dict key ``key``."""
    name, leaf = key.rsplit(".", 1)
    if name == "layernorm":
        return key
    if name in _CONVS:
        return f"{_CONVS[name]}.{leaf}"
    if name.startswith("prefilt."):
        return f"prefilt_list.{name[len('prefilt.'):]}.0.{leaf}"
    if name.startswith("frequency."):
        return f"linear.{key}"
    if name in ("weights", "gain"):
        return f"linear.{name}.0.{leaf}"
    raise KeyError(f"no reference name for the port's key {key!r}")


def import_encoder_state(encoder: nn.Module, state_dict: Mapping[str, torch.Tensor]
                         ) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` for ``encoder`` (a ``PESTOEncoder``) with
    every tensor taken from the reference ``state_dict`` (numpy arrays or
    tensors, with or without the ``encoder.`` prefix), as float32 on the
    CPU. Raises KeyError on a missing reference key and ValueError on a
    shape mismatch: a silent partial import would be worse than none."""
    sd = _strip_prefix(state_dict)
    out: Dict[str, torch.Tensor] = {}
    for key, own in encoder.state_dict().items():
        name = reference_key(key)
        if name not in sd:
            raise KeyError(f"{name}: missing from the reference state dict (for {key})")
        shape = (1, 1, own.numel()) if key.startswith("frequency.") else tuple(own.shape)
        value = sd[name]
        arr = torch.as_tensor(value if isinstance(value, torch.Tensor) else np.asarray(value))
        if tuple(arr.shape) != shape:
            raise ValueError(f"{name}: reference shape {tuple(arr.shape)} != {shape}")
        out[key] = arr.detach().to("cpu", torch.float32, copy=True).reshape(own.shape)
    return out


def load_from_reference_ckpt(encoder: nn.Module, path: str) -> Dict[str, torch.Tensor]:
    """One call: a reference checkpoint file -> the port's ``state_dict``
    for ``encoder``."""
    return import_encoder_state(encoder, load_reference_state_dict(path))
