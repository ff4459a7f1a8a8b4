"""Carry ``PESTOEncoder`` weights between the JAX package and the port.

``params_from_flax`` maps the JAX package's parameter tree (nested dicts of
numpy arrays, with or without the top-level ``"params"`` key) onto the
port's ``state_dict``; ``params_to_flax`` is its inverse, and
``grads_to_flax`` maps the parameters' ``.grad`` the same way, so gradients
compare per flax leaf; ``optimizer_state_from_flax`` loads the JAX
package's Adam moments and count into the port's optimizer and schedule,
so a run that JAX trained can go on in the port once its arrays are
exported (the port reads no Orbax checkpoint). Layouts:

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


def flat_from_tree(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested tree -> {"conv1/Conv_0/kernel": array, ...}: the inverse of
    ``flax_tree_from_flat`` (keys below ``prefix``)."""
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(flat_from_tree(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


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


def grads_to_flax(module: torch.nn.Module) -> Dict[str, Any]:
    """The module's parameter gradients as a flax tree (zeros where a
    parameter has no gradient)."""
    return params_to_flax({name: torch.zeros_like(p) if p.grad is None else p.grad
                           for name, p in module.named_parameters()})


def _adam_state(opt_state: Any) -> Any:
    """The ``scale_by_adam`` element (``mu``, ``nu``, ``count``) of an optax
    state: a ``ScaleByAdamState`` or a sequence (the chain's states) that
    holds one."""
    if all(hasattr(opt_state, k) for k in ("mu", "nu", "count")):
        return {k: getattr(opt_state, k) for k in ("mu", "nu", "count")}
    if isinstance(opt_state, (list, tuple)):
        found = [s for s in (_adam_state(e) for e in opt_state) if s is not None]
        if len(found) == 1:
            return found[0]
    return None


def optimizer_state_from_flax(opt_state: Any, step: int, mod: Any, state: Any) -> None:
    """Load the JAX package's optimizer state (``optax.chain(
    add_decayed_weights, scale_by_adam, scale...)``, ``sot_tpu/training/
    trainer.py:make_optimizer``, its leaves as numpy arrays) into the port's
    ``state`` for ``mod.encoder``: ``mu`` -> ``exp_avg``, ``nu`` ->
    ``exp_avg_sq`` (through ``params_from_flax``'s leaf map and transposes),
    ``count`` -> each parameter's Adam ``step`` and the schedule's
    ``last_epoch`` (the lr set to the schedule's value there), and ``step``
    -> ``state.step``. The parameters themselves go through
    ``params_from_flax``."""
    from sot_tpu_torch.training.trainer import lr_multiplier

    adam = _adam_state(opt_state)
    if adam is None:
        raise ValueError("no scale_by_adam state (mu, nu, count) found in opt_state")
    count = int(np.asarray(adam["count"]))
    mu, nu = params_from_flax(adam["mu"]), params_from_flax(adam["nu"])
    names = [name for name, _ in mod.encoder.named_parameters()]
    if set(mu) != set(names) or set(nu) != set(names):
        raise KeyError(f"optimizer moments do not match the encoder's parameters: "
                       f"{sorted(set(mu) ^ set(names))}")
    sd = state.optimizer.state_dict()
    ids = sd["param_groups"][0]["params"]
    if len(sd["param_groups"]) != 1 or len(ids) != len(names):
        raise ValueError("the optimizer must hold the encoder's parameters in one group")
    sd["state"] = {i: {"step": torch.tensor(float(count)), "exp_avg": mu[name],
                       "exp_avg_sq": nu[name]} for i, name in zip(ids, names)}
    state.optimizer.load_state_dict(sd)
    sched = state.scheduler
    sched.last_epoch = count
    factor = lr_multiplier(mod.config, count)
    for group, base in zip(state.optimizer.param_groups, sched.base_lrs):
        group["lr"] = base * factor
    sched._last_lr = [g["lr"] for g in state.optimizer.param_groups]
    state.step = int(step)
