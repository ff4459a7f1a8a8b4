"""PESTO-SOT's program adapter: the port's model (``sot_tpu_torch``: the
PESTO encoder on the CQT, the frozen harmonic synth, the registry's loss)
built from a configuration file, the benchmark's weights loaded into it,
and the entries the windows drive: the compiled train step and
``predict``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import numpy as np
import torch

from sot_tpu_torch import configs as configs_lib
from sot_tpu_torch.training import trainer

# the encoder a configuration file states: the program builds the PESTO
# encoder with these sizes fixed, so a file that states others is refused
_ENCODER_DEFAULTS = {"channels": [40, 30, 30, 10, 3], "kernel_size": 15, "p_dropout": 0.5,
                     "a_lrelu": 0.3, "n_prefilt_layers": 2}


def experiment_config(cfg: dict) -> configs_lib.ExperimentConfig:
    """The program's config of a configuration file: its registry entry,
    with which every field the file sets must agree (the file holds the
    configuration as it is run); the file's other keys (the model's name,
    the encoder's sizes, the clip generator, the kernel preset) are the
    benchmark's."""
    base = configs_lib.get_experiment(cfg["experiment"])
    fields = {f.name for f in dataclasses.fields(base)}
    over = {k: v for k, v in cfg.items() if k in fields and k != "name"}
    if "losses" in over:
        over["losses"] = tuple(configs_lib.LossConfig(**{k: (tuple(v) if isinstance(v, list) else v)
                                                          for k, v in lc.items()})
                               for lc in over["losses"])
    run = base.replace(**over)
    for k in over:
        if getattr(run, k) != getattr(base, k):
            raise ValueError(f"config {cfg['experiment']}: {k} = {getattr(run, k)!r} in the file, "
                             f"{getattr(base, k)!r} in the program's registry")
    if cfg["encoder"] != _ENCODER_DEFAULTS:
        raise ValueError(f"config {cfg['experiment']}: encoder {cfg['encoder']} is not the "
                         f"program's PESTO encoder {_ENCODER_DEFAULTS}")
    return run


class Program:
    """The program's model for one configuration file on ``device``, its
    encoder holding ``weights`` (name -> tensor, the state dict's names)."""

    def __init__(self, cfg: dict, weights: Dict[str, torch.Tensor], device: torch.device):
        self.cfg = self.run_config(cfg)
        self.device = torch.device(device)
        self.mod = trainer.build_modules(self.cfg, device=self.device, kernels=cfg["kernels"])
        state = self.mod.encoder.state_dict()
        if set(state) != set(weights) or any(state[k].shape != weights[k].shape for k in state):
            raise ValueError("the program's encoder does not have the configuration's "
                             "parameters: " + str({k: tuple(v.shape) for k, v in state.items()}))
        self.mod.encoder.load_state_dict(weights)
        self.state = None
        self.x_all = None

    @staticmethod
    def run_config(cfg: dict) -> configs_lib.ExperimentConfig:
        return experiment_config(cfg)

    # -- training ----------------------------------------------------------

    def start_training(self, x_all: torch.Tensor, dropout_seed: int) -> None:
        """Adam, its schedule and the dropout generator (seeded with
        ``dropout_seed`` on the device), over the device-resident clips."""
        self.state = trainer.init_state(self.mod, seed=dropout_seed)
        self.x_all = x_all

    def train(self, offsets: Sequence[int]) -> Dict[str, torch.Tensor]:
        """One chunk of updates, one per batch offset into the clips, as
        ``train()`` runs them: replays of the step's CUDA graph on the GPU,
        the eager steps on the CPU. The last step's logs."""
        run = (trainer.train_steps_graph if self.device.type == "cuda"
               else trainer.train_steps)
        return run(self.mod, self.state, self.x_all, np.asarray(offsets, np.int64))

    @staticmethod
    def loss_terms(logs: Dict[str, torch.Tensor]) -> Dict[str, float]:
        """A step's logged loss terms (each times its weight) by kind, and
        the total."""
        names = {"loss/MSSLoss": "mss", "loss/Wasserstein1D": "wasserstein", "loss/total": "total"}
        return {names[k]: float(v) for k, v in logs.items() if k in names}

    def params(self) -> Dict[str, torch.Tensor]:
        return {k: v.detach().clone() for k, v in self.mod.encoder.named_parameters()}

    def adam_first_moments(self) -> Dict[str, torch.Tensor]:
        names = {id(p): k for k, p in self.mod.encoder.named_parameters()}
        return {names[id(p)]: s["exp_avg"].detach().clone()
                for p, s in self.state.optimizer.state.items()}

    # -- serving -----------------------------------------------------------

    def predict(self, x: np.ndarray) -> Dict[str, torch.Tensor]:
        return trainer.predict(self.mod, x)

    def close(self) -> None:
        """Drop the model, its state and its graphs."""
        self.mod = self.state = self.x_all = None
