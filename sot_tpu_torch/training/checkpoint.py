"""Run checkpoints (L5), port of ``sot_tpu/training/checkpoint.py``: the
encoder's parameters, the optimizer and its schedule, the dropout
generator and the step, as one ``torch.save`` file at ``<dir>/<tag>``.

The optimizer's state is Adam's ``state_dict``: on the GPU a capturable
Adam's, whose step counts are device tensors (held on the CPU in the file,
as every tensor). ``restore`` loads it into the optimizer as that optimizer
is built, so one file resumes on either device and on either path, the
eager loop or the CUDA graph of ``trainer.TrainGraph``: each Adam step
count goes where the live optimizer keeps it (the device when capturable,
the CPU when not), the live ``capturable`` flag stays, and a tensor
learning rate takes the file's value in place, at its address.

Tags as in the JAX package: ``best-lsd`` (top-1 on the lowest val LSD) and
``last``, each overwritten in place. A run keeps them under
``<run>/checkpoints/<tag>``, so the run's ``train_config.json`` is found two
levels up from the file (``cli._config_for_ckpt``).
"""

from __future__ import annotations

import os
from typing import Any, Dict

import torch

from sot_tpu_torch.models import import_torch

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


def encoder_state(path: str, encoder: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """``encoder``'s ``state_dict`` from the file ``path``, decided by its
    content: a run checkpoint of this package, a bare ``torch.save`` of the
    encoder's ``state_dict`` (its keys are the encoder's), or a reference
    checkpoint (a Lightning ``.ckpt`` or its bare ``state_dict``, with or
    without the ``encoder.`` prefix), mapped by
    ``models.import_torch.import_encoder_state``. Anything else raises,
    naming the keys it found."""
    data = _read(path)
    if _is_payload(data):
        return data["encoder"]
    if isinstance(data, dict):
        if set(data) == set(encoder.state_dict()):
            return data
        sd = data.get("state_dict", data)
        if isinstance(sd, dict) and import_torch.is_reference_layout(sd):
            return import_torch.import_encoder_state(encoder, sd)
    found = sorted(map(str, data)) if isinstance(data, dict) else type(data).__name__
    raise ValueError(f"{path} is neither a run checkpoint ({FORMAT}), nor the encoder's "
                     f"state_dict, nor a reference checkpoint (no {import_torch.REFERENCE_MARK}); "
                     f"found {found}")


def load_optimizer_state(optimizer: torch.optim.Optimizer, saved: Dict[str, Any]) -> None:
    """``optimizer.load_state_dict(saved)`` that keeps the optimizer as it is
    built: its ``capturable`` flags, each Adam step count on the device a
    capturable Adam keeps it on (else the CPU), and a tensor ``lr`` in place."""
    live = [(g.get("capturable", False), g["lr"]) for g in optimizer.param_groups]
    optimizer.load_state_dict(saved)
    for group, (capturable, lr) in zip(optimizer.param_groups, live):
        group["capturable"] = capturable
        if isinstance(lr, torch.Tensor):
            with torch.no_grad():
                lr.copy_(torch.as_tensor(group["lr"], dtype=lr.dtype))
            group["lr"] = lr
        for p in group["params"]:
            s = optimizer.state.get(p, {})
            if isinstance(s.get("step"), torch.Tensor):
                s["step"] = s["step"].to(device=p.device if capturable else "cpu", dtype=torch.float32)


def restore(path: str, mod: Any, state: Any) -> int:
    """Load a checkpoint into ``mod.encoder`` and ``state`` (optimizer,
    schedule, generator and step, on ``mod.device``; the parameters and the
    generator in place); returns the step. A CUDA graph captured for
    ``state`` is dropped (the optimizer's state tensors are new), so the next
    chunk captures again."""
    data = load(path)
    mod.encoder.load_state_dict(data["encoder"])
    load_optimizer_state(state.optimizer, data["optimizer"])
    state.scheduler.load_state_dict(data["scheduler"])
    state.generator.set_state(data["generator"])
    state.step = int(data["step"])
    state.graph = None
    return state.step
