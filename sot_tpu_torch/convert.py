"""Carry ``PESTOEncoder`` weights between the JAX package and the port.

``params_from_flax`` maps the JAX package's parameter tree (nested dicts of
numpy arrays, with or without the top-level ``"params"`` key) onto the
port's ``state_dict``; ``params_to_flax`` is its inverse. Layouts:

  flax                              torch
  LayerNorm_0/{scale,bias} (285, 1)  layernorm.{weight,bias}  (1, 285)
  <conv>/Conv_0/kernel [k, in, out]  <conv>.weight            [out, in, k]
  <conv>/Conv_0/bias   [out]         <conv>.bias              [out]
  prefilt<p>/...                     prefilt.<p>.*
  frequency<i>/kernel  [in+out-1]    frequency.<i>.weight     [in+out-1]
  weights/Dense_0/kernel [in, out]   weights.weight           [out, in]
  gain/Dense_0/...                   gain.*
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

_CONVS = ("conv1", "conv2", "conv3", "conv4a", "conv4b")
_DENSES = ("weights", "gain")


def _np(x: Any) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def params_from_flax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    p = tree.get("params", tree)
    sd: Dict[str, np.ndarray] = {
        "layernorm.weight": _np(p["LayerNorm_0"]["scale"]).T,
        "layernorm.bias": _np(p["LayerNorm_0"]["bias"]).T,
    }
    for name, sub in p.items():
        if name in _CONVS or name.startswith("prefilt"):
            key = name if name in _CONVS else f"prefilt.{name[len('prefilt'):]}"
            sd[f"{key}.weight"] = _np(sub["Conv_0"]["kernel"]).transpose(2, 1, 0)
            sd[f"{key}.bias"] = _np(sub["Conv_0"]["bias"])
        elif name.startswith("frequency"):
            sd[f"frequency.{name[len('frequency'):]}.weight"] = _np(sub["kernel"])
        elif name in _DENSES:
            sd[f"{name}.weight"] = _np(sub["Dense_0"]["kernel"]).T
            sd[f"{name}.bias"] = _np(sub["Dense_0"]["bias"])
        elif name != "LayerNorm_0":
            raise KeyError(f"unknown flax parameter group {name!r}")
    return {k: torch.tensor(v) for k, v in sd.items()}


def flax_tree_from_flat(flat: Mapping[str, np.ndarray], prefix: str = "params"
                        ) -> Dict[str, Any]:
    """{"params/conv1/Conv_0/kernel": array, ...} (an .npz's keys) -> nested
    tree {"params": {"conv1": {"Conv_0": {"kernel": array}}}}."""
    tree: Dict[str, Any] = {}
    for key, v in flat.items():
        if not key.startswith(prefix + "/"):
            continue
        node = tree
        *path, leaf = key[len(prefix) + 1:].split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = np.asarray(v)
    return {prefix: tree}


def params_to_flax(state_dict: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    p: Dict[str, Any] = {}
    for key, value in state_dict.items():
        v = value.detach().cpu().numpy().astype(np.float32)
        parts = key.split(".")
        if parts[0] == "layernorm":
            p.setdefault("LayerNorm_0", {})["scale" if parts[1] == "weight" else "bias"] = v.T
        elif parts[0] in _CONVS or parts[0] == "prefilt":
            group = parts[0] if parts[0] in _CONVS else f"prefilt{parts[1]}"
            conv = p.setdefault(group, {}).setdefault("Conv_0", {})
            if parts[-1] == "weight":
                conv["kernel"] = v.transpose(2, 1, 0)
            else:
                conv["bias"] = v
        elif parts[0] == "frequency":
            p[f"frequency{parts[1]}"] = {"kernel": v}
        elif parts[0] in _DENSES:
            dense = p.setdefault(parts[0], {}).setdefault("Dense_0", {})
            if parts[1] == "weight":
                dense["kernel"] = v.T
            else:
                dense["bias"] = v
        else:
            raise KeyError(f"unknown state_dict key {key!r}")
    return {"params": {k: p[k] for k in sorted(p)}}
