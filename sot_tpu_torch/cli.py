"""Command-line entry point of the port (L6): batch inference.

    python -m sot_tpu_torch.cli predict --ckpt encoder.pt --input clips.npy \
        --output preds.npz [--device cuda|cpu]

``--ckpt`` is a ``torch.save`` of the encoder's ``state_dict`` (for weights
trained by the JAX package, build one with ``convert.params_from_flax``).
The other subcommands of ``sot_tpu.cli`` come with later slices (ROADMAP).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from sot_tpu_torch.configs import EXPERIMENTS, get_experiment


def _parse_set_overrides(pairs) -> dict:
    """--set key=value generic field overrides (typed via json parsing)."""
    out = {}
    for pair in pairs or ():
        key, _, value = pair.partition("=")
        try:
            out[key] = json.loads(value)
        except json.JSONDecodeError:
            out[key] = value
    return out


def _load_audio(path: str):
    import numpy as np

    if path.endswith(".npz"):
        with np.load(path) as z:
            key = "signals" if "signals" in z.files else z.files[0]
            x = z[key]
    else:
        x = np.load(path)
    x = np.asarray(x, np.float32)
    if x.ndim == 1:
        x = x[None]
    if x.ndim != 2:
        raise SystemExit(f"expected [T] or [batch, T] audio, got {x.shape}")
    return x


def cmd_predict(args: argparse.Namespace) -> int:
    """Per-frame pitch_hz / pitch_unit / harmonic weights for audio clips,
    in batches of the config's batch size, written as .npz or printed as
    pitch_hz JSON."""
    import numpy as np
    import torch

    from sot_tpu_torch import data as data_lib
    from sot_tpu_torch.device import set_precision_policy
    from sot_tpu_torch.training.trainer import build_modules, predict

    overrides = _parse_set_overrides(args.set)
    if args.dataset:
        overrides["dataset_path"] = args.dataset
    cfg = get_experiment(args.experiment, **overrides)
    mod = build_modules(cfg, device=args.device)
    if mod.device.type == "cuda":
        set_precision_policy()
    state = torch.load(args.ckpt, map_location=mod.device, weights_only=True)
    mod.encoder.load_state_dict(state)

    x = _load_audio(args.input)
    if not args.no_normalize:
        # the model is trained on peak-normalized clips (data.py x0.9)
        x = data_lib.peak_normalize(x).astype(np.float32)

    bs = cfg.batch_size
    n = x.shape[0]
    pad = (-n) % bs
    if pad:
        x = np.concatenate([x, np.zeros((pad, x.shape[1]), x.dtype)])
    keep = ("pitch_hz", "pitch_unit", "weights")
    chunks = []
    for i in range(0, x.shape[0], bs):
        out = predict(mod, x[i:i + bs])
        chunks.append({k: out[k].cpu().numpy() for k in keep})
    res = {k: np.concatenate([c[k] for c in chunks])[:n] for k in keep}
    res["pitch_hz"] = res["pitch_hz"].squeeze(-1)
    res["pitch_unit"] = res["pitch_unit"].squeeze(-1)
    if args.output:
        os.makedirs(os.path.dirname(os.path.abspath(args.output)), exist_ok=True)
        np.savez(args.output, **res)
        print(f"wrote {args.output}: " + ", ".join(
            f"{k} {tuple(v.shape)}" for k, v in sorted(res.items())))
    else:
        print(json.dumps({"pitch_hz": res["pitch_hz"].tolist()}))
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="sot_tpu_torch", description=__doc__)
    sub = p.add_subparsers(dest="command", required=True)

    pr = sub.add_parser("predict", help="batch inference on audio clips")
    pr.add_argument("--experiment", default="SOT-2048", choices=sorted(EXPERIMENTS))
    pr.add_argument("--ckpt", required=True,
                    help="torch.save of the encoder state_dict")
    pr.add_argument("--input", required=True,
                    help=".npy [T] or [batch, T] float audio @ the model's "
                         "sample rate, or .npz with a 'signals' array")
    pr.add_argument("--output", default=None,
                    help="write pitch_hz/pitch_unit/weights as .npz "
                         "(default: print pitch_hz JSON to stdout)")
    pr.add_argument("--no-normalize", action="store_true",
                    help="skip the training-matching peak normalization")
    pr.add_argument("--dataset", default=None, help=argparse.SUPPRESS)
    pr.add_argument("--set", action="append", default=None, metavar="KEY=VAL",
                    help="config overrides, e.g. batch_size=32")
    pr.add_argument("--device", default=None,
                    help="'cuda' (default; fails without a GPU) or 'cpu'")
    pr.set_defaults(fn=cmd_predict)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
