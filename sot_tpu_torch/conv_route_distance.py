"""How far apart the encoder's conv routes put a train step's gradient, from
identical states (the step-level side of the f32 route's 25k verdict):

    python -m sot_tpu_torch.conv_route_distance --experiment SOT-2048-Anneal \\
        --seed 42 --steps 1000 --every 10 --out DIR/conv_route_distance.json

From the seed's initialisation, in the training run's batch order (one
``default_rng(seed)`` permutation per epoch), it makes ``--steps`` updates
on the default route (``F32Conv1d``: on the GPU the f32 kernels of
``csrc/conv_f32.cu``). Every ``--every`` steps, before the update, it
takes the train loss's gradient of every encoder parameter from the same
parameters, batch, schedule values and dropout masks, with the k > 1 convs
computed by each route:

  * ``f32`` — the layer's own forward (the f32 kernels on the GPU), twice;
  * ``cudnn`` — ``nn.Conv1d``'s forward (cuDNN in f32, TF32 off), twice;
  * ``f64`` — the conv in float64, its output rounded to f32: the reference.

Each step's record holds ``||a - b|| / ||g_f64||`` over all the gradients
(``all``) and over the k > 1 convs' weights alone (``conv``) for the pairs
f32-f64, cudnn-f64, f32-cudnn, f32-f32 (the kernels' reproducibility) and
cudnn-cudnn (cuDNN's); the summary gives each pair's median and max over
the steps. Every route's gradient comes from the same state, so the pairs
measure the route alone, not trajectories that have drifted apart. On the
CPU ``f32`` and ``cudnn`` are the same computation (``nn.Conv1d``).
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import statistics
from typing import Dict, Iterator

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sot_tpu_torch.models.encoder import F32Conv1d

ROUTES = ("f32", "f32_again", "cudnn", "cudnn_again", "f64")
PAIRS = (("f32", "f64"), ("cudnn", "f64"), ("f32", "cudnn"), ("f32", "f32_again"),
         ("cudnn", "cudnn_again"))


def _f64_forward(layer: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
    y = F.conv1d(x.double(), layer.weight.double(), layer.bias.double(),
                 padding=layer.padding)
    return y.float()


_FORWARDS = {"f32": None, "cudnn": nn.Conv1d.forward, "f64": _f64_forward}


@contextlib.contextmanager
def conv_route(encoder: nn.Module, route: str) -> Iterator[None]:
    """The encoder's ``F32Conv1d`` layers computed by ``route`` (a key of
    ``_FORWARDS``) inside the block."""
    fn = _FORWARDS[route]
    layers = [m for m in encoder.modules() if isinstance(m, F32Conv1d)]
    if fn is not None:
        for m in layers:
            m.forward = functools.partial(fn, m)
    try:
        yield
    finally:
        for m in layers:
            m.__dict__.pop("forward", None)


def _gradient(mod, state, x: torch.Tensor, route: str) -> Dict[str, torch.Tensor]:
    """Every encoder parameter's gradient of the train loss at ``state``,
    the dropout generator left as it was."""
    from sot_tpu_torch.training import trainer

    cfg = mod.config
    gen = state.generator.get_state()
    mod.encoder.zero_grad(set_to_none=True)
    with conv_route(mod.encoder, route.replace("_again", "")):
        loss, _ = trainer.compute_loss(mod, x, train=True,
                                       temperature=trainer.temperature_at(cfg, state.step),
                                       prior_scale=trainer.prior_scale_at(cfg, state.step))
        loss.backward()
    state.generator.set_state(gen)
    grads = {n: p.grad.detach().double().clone() for n, p in mod.encoder.named_parameters()
             if p.grad is not None}
    mod.encoder.zero_grad(set_to_none=True)
    return grads


def _distances(grads: Dict[str, Dict[str, torch.Tensor]], conv_names) -> Dict[str, dict]:
    def flat(g, names):
        return torch.cat([g[n].flatten() for n in names])

    out = {}
    for part, names in (("all", sorted(grads["f64"])), ("conv", conv_names)):
        ref = float(flat(grads["f64"], names).norm())
        out[part] = {f"{a}-{b}": float((flat(grads[a], names) - flat(grads[b], names)).norm())
                     / ref for a, b in PAIRS}
    return out


def run(experiment: str, seed: int, steps: int, every: int, device=None,
        overrides=None) -> dict:
    """The document described in the module docstring."""
    from sot_tpu_torch import data as data_lib
    from sot_tpu_torch.configs import get_experiment
    from sot_tpu_torch.device import card_line, set_precision_policy
    from sot_tpu_torch.training import trainer

    cfg = get_experiment(experiment, seed=seed, **(overrides or {}))
    mod = trainer.build_modules(cfg, device=device,
                                generator=torch.Generator().manual_seed(cfg.seed),
                                kernels="auto")
    if mod.device.type == "cuda":
        set_precision_policy()
    conv_names = [n for n, m in mod.encoder.named_modules() if isinstance(m, F32Conv1d)]
    conv_names = [f"{n}.weight" for n in conv_names]
    splits = data_lib.dataset_from_config(cfg, device=mod.device)
    x_train = torch.as_tensor(data_lib.peak_normalize(splits["train"].x).astype(np.float32),
                              device=mod.device)
    bs = cfg.batch_size
    per_epoch = x_train.shape[0] // bs
    shuffle = np.random.default_rng(cfg.seed)
    state = trainer.init_state(mod)
    records = []
    order = []
    for step in range(steps):
        if not order:
            order = list(shuffle.permutation(per_epoch)[:steps - step])
        lo = int(order.pop(0)) * bs
        x = x_train[lo:lo + bs]
        if step % every == 0:
            grads = {r: _gradient(mod, state, x, r) for r in ROUTES}
            records.append({"step": step, **_distances(grads, conv_names)})
        trainer.train_step(mod, state, x)
    summary = {part: {pair: {"median": statistics.median(r[part][pair] for r in records),
                             "max": max(r[part][pair] for r in records)}
                      for pair in records[0][part]}
               for part in ("all", "conv")}
    return {"experiment": cfg.name, "seed": cfg.seed, "steps": steps, "every": every,
            "device": card_line(mod.device), "conv_weights": conv_names,
            "summary": summary, "records": records}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--experiment", default="SOT-2048-Anneal")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--every", type=int, default=10)
    p.add_argument("--device", default=None, help="'cuda' (default) or 'cpu'")
    p.add_argument("--out", required=True, help="the JSON file to write")
    args = p.parse_args(argv)
    doc = run(args.experiment, args.seed, args.steps, args.every, device=args.device)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(doc, fh, indent=1)
    print(json.dumps({"summary": doc["summary"], "device": doc["device"]}, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
