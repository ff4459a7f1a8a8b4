#!/usr/bin/env python3
"""Which operation makes two identical train steps differ on one GPU.

Restores one SOT-2048 (``auto``) state from a checkpoint twice, takes the
same training-mode forward and backward on the same 64 clips each time
(dropout from the restored generator), and prints which losses, forward
outputs and parameter gradients differ between the two, under PyTorch's
defaults, under ``torch.backends.cudnn.deterministic = True`` and under
``torch.use_deterministic_algorithms(True)`` (which raises on an operation
that has no deterministic implementation and names it).

    python3 tools/step_determinism.py

It needs a GPU; the checkpoint it writes goes to ``runs/`` and is removed.
"""

from __future__ import annotations

import os
import sys

# cuBLAS needs a fixed workspace for use_deterministic_algorithms; set it
# before CUDA starts
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from sot_tpu_torch import data as data_lib  # noqa: E402
from sot_tpu_torch.configs import get_experiment  # noqa: E402
from sot_tpu_torch.device import set_precision_policy  # noqa: E402
from sot_tpu_torch.ops.kernels import _build  # noqa: E402
from sot_tpu_torch.training import checkpoint as ckpt_lib  # noqa: E402
from sot_tpu_torch.training import trainer  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("step_determinism: no CUDA device", file=sys.stderr)
        return 1
    set_precision_policy()
    _build.build(["cqt", "synth", "merge", "refgrad", "plane", "stft", "conv"])
    dev = torch.device("cuda")
    cfg = get_experiment("SOT-2048", dataset_size=200)
    x = torch.from_numpy(data_lib.peak_normalize(
        data_lib.dataset_from_config(cfg, device=dev)["train"].x[:cfg.batch_size])).to(dev)
    mod = trainer.build_modules(cfg, device=dev, generator=torch.Generator().manual_seed(42),
                                kernels="auto")
    state = trainer.init_state(mod)
    os.makedirs(os.path.join(ROOT, "runs"), exist_ok=True)
    path = ckpt_lib.save(os.path.join(ROOT, "runs"), mod, state, 0, tag="step_determinism")

    def once(train: bool):
        ckpt_lib.restore(path, mod, state)
        mod.encoder.zero_grad(set_to_none=True)
        loss, (logs, out) = trainer.compute_loss(mod, x, train=train, temperature=0.1)
        loss.backward()
        torch.cuda.synchronize()
        return ({k: float(v.detach()) for k, v in logs.items()},
                {n: p.grad.detach().clone() for n, p in mod.encoder.named_parameters()},
                {k: out[k].detach().clone() for k in ("x_hat", "pitch_hz", "weights")})

    def compare(tag: str, train: bool = True) -> None:
        a, b = once(train), once(train)
        fwd = {k: float((a[2][k] - b[2][k]).abs().max()) for k in a[2]}
        grads = {n: float((a[1][n] - b[1][n]).abs().max() / (a[1][n].abs().max() + 1e-30))
                 for n in a[1]}
        print(f"[{tag}] train={train}: losses equal {a[0] == b[0]}; forward max|d| {fwd}; "
              f"gradients that differ (max|d|/max): "
              f"{ {n: f'{v:.2e}' for n, v in grads.items() if v} }", flush=True)

    try:
        compare("default")
        compare("default", train=False)
        torch.backends.cudnn.deterministic = True
        compare("cudnn.deterministic")
        torch.backends.cudnn.deterministic = False
        torch.use_deterministic_algorithms(True)
        try:
            compare("use_deterministic_algorithms")
        except RuntimeError as exc:
            print(f"[use_deterministic_algorithms] raised: {str(exc)[:600]}")
        torch.use_deterministic_algorithms(False)
    finally:
        os.remove(path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
