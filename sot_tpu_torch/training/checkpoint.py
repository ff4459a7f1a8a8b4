"""Run checkpoints (L5), port of ``sot_tpu/training/checkpoint.py``: the
encoder's parameters, the optimizer and its schedule, the dropout
generator and the step, as one ``torch.save`` file at ``<dir>/<tag>``.

Tags as in the JAX package: ``best-lsd`` (top-1 on the lowest val LSD) and
``last``, each overwritten in place. A run keeps them under
``<run>/checkpoints/<tag>``, so the run's ``train_config.json`` is found two
levels up from the file (``cli._config_for_ckpt``).
"""

from __future__ import annotations

import os
from typing import Any, Dict

import torch

FORMAT = "sot_tpu_torch.checkpoint/1"


def _path(checkpoint_dir: str, tag: str) -> str:
    return os.path.join(os.path.abspath(checkpoint_dir), tag)


def payload(mod: Any, state: Any, step: int) -> Dict[str, Any]:
    """What a checkpoint holds: copies on the CPU, so a payload taken now
    does not move with later updates."""
    def cpu(tree):
        if isinstance(tree, torch.Tensor):
            return tree.detach().to("cpu", copy=True)
        if isinstance(tree, dict):
            return {k: cpu(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [cpu(v) for v in tree]
        return tree

    return {"format": FORMAT,
            "encoder": cpu(mod.encoder.state_dict()),
            "optimizer": cpu(state.optimizer.state_dict()),
            "scheduler": cpu(state.scheduler.state_dict()),
            "generator": state.generator.get_state().clone(),
            "step": int(step)}


def save(checkpoint_dir: str, mod: Any, state: Any, step: int, tag: str = "best-lsd") -> str:
    """Save ``mod``'s encoder and ``state`` under ``<dir>/<tag>``, overwriting
    the previous one (top-k = 1) through a temporary file, so a reader never
    sees half a checkpoint."""
    path = _path(checkpoint_dir, tag)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(payload(mod, state, step), path + ".tmp")
    os.replace(path + ".tmp", path)
    return path


def _read(path: str) -> Any:
    return torch.load(os.path.abspath(path), map_location="cpu", weights_only=True)


def _is_payload(data: Any) -> bool:
    return isinstance(data, dict) and data.get("format") == FORMAT


def load(path: str) -> Dict[str, Any]:
    """A checkpoint's payload, tensors on the CPU. Raises on a file that is
    not a run checkpoint of this package."""
    data = _read(path)
    if not _is_payload(data):
        raise ValueError(f"{path} is not a run checkpoint ({FORMAT})")
    return data


def encoder_state(path: str) -> Dict[str, torch.Tensor]:
    """The encoder's ``state_dict`` from a run checkpoint or from a bare
    ``torch.save`` of the encoder's ``state_dict``."""
    data = _read(path)
    return data["encoder"] if _is_payload(data) else data


def restore(path: str, mod: Any, state: Any) -> int:
    """Load a checkpoint into ``mod.encoder`` and ``state`` (optimizer,
    schedule, generator and step, on ``mod.device``); returns the step."""
    data = load(path)
    mod.encoder.load_state_dict(data["encoder"])
    state.optimizer.load_state_dict(data["optimizer"])
    state.scheduler.load_state_dict(data["scheduler"])
    state.generator.set_state(data["generator"])
    state.step = int(data["step"])
    return state.step
