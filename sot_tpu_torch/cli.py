"""Command-line entry points of the port (L6), after ``sot_tpu/cli.py``:

    python -m sot_tpu_torch.cli train --experiment SOT-2048 --seed 42 \
        --steps 25000 --kernels auto --final-eval --out runs/sot2048-42
    python -m sot_tpu_torch.cli train ... --resume runs/sot2048-42/checkpoints/last
    python -m sot_tpu_torch.cli train ... --kernels auto --gate conv=true \
        --gate conv_dtype=float32
    python -m sot_tpu_torch.cli evaluate --ckpt runs/sot2048-42/checkpoints/best-lsd
    python -m sot_tpu_torch.cli analyze --ckpt runs/sot2048-42/checkpoints/best-lsd
    python -m sot_tpu_torch.cli predict --ckpt runs/.../best-lsd --input clips.npy \
        --output preds.npz
    python -m sot_tpu_torch.cli generate-data --out data/sinusoids.npz
    python -m sot_tpu_torch.cli list

Every command but ``list`` runs on the GPU unless ``--device cpu`` asks for
the CPU; without a GPU and without ``--device`` it raises. A run directory
holds ``train_config.json`` (the resolved config), ``kernel_gates.json``
(the gates the run trained and evaluated with: ``--kernels`` and the
``--gate FIELD=VALUE`` pins, the port's ``SOT_TPU_*``; after training,
``train_launches``, each hand-written kernel's launches over the steps and
the val evaluations, which names the conv kernels that ran), ``log.jsonl``,
``checkpoints/{best-lsd,last}`` and ``best_metrics.json``; ``--ckpt`` takes
a run checkpoint, whose run's ``train_config.json`` is used, a
``torch.save`` of the encoder's ``state_dict`` (for weights trained by the
JAX package, build one with ``convert.params_from_flax``), or a reference
Lightning checkpoint (``models/import_torch.py``), told apart by content.
``predict`` runs each batch shape as one CUDA graph on the GPU
(``trainer.predict``). ``train
--profile`` first traces a few warmed-up train steps (on the GPU, replays
of the step's CUDA graph) into ``<out>/trace`` and prints the device-time
table (``training/profiling.py``); ``train --figures`` draws the figure
gallery of each evaluation into ``<out>/figures/step<N>/``
(``training/observability.py``; needs matplotlib). The paper table over
many runs is ``python -m sot_tpu_torch.eval_paper``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shlex
import sys

from sot_tpu_torch.configs import EXPERIMENTS, PAPER_SEEDS, get_experiment


def _save_resolved_config(cfg, out_dir: str) -> None:
    """The resolved config as ``<out>/train_config.json``."""
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "train_config.json"), "w") as fh:
        json.dump(dataclasses.asdict(cfg), fh, indent=2, default=str)


def _read_config_file(path: str):
    """A config file's document: ``json`` for a ``.json`` name, else YAML
    (PyYAML, imported here; a ``.json`` file works without it)."""
    with open(path) as fh:
        if path.endswith(".json"):
            return json.load(fh)
        try:
            import yaml
        except ImportError as exc:
            raise RuntimeError(
                f"--config {path}: reading YAML needs PyYAML, which is not installed; "
                f"give the overrides as a .json file instead") from exc
        return yaml.safe_load(fh)


def _load_config_files(paths) -> dict:
    """YAML/JSON config overrides, with master-config expansion: a file whose
    top level has a ``configs:`` list pulls in those files in order, later
    entries overriding earlier ones."""
    merged: dict = {}
    for path in paths:
        doc = _read_config_file(path) or {}
        if isinstance(doc, dict) and "configs" in doc:
            sub = [os.path.join(os.path.dirname(path), c) if not os.path.isabs(c) else c
                   for c in doc.pop("configs")]
            merged.update(_load_config_files(sub))
        if not isinstance(doc, dict):
            raise ValueError(f"config {path} must be a mapping")
        merged.update(doc)
    return merged


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


def _coerce_saved_config(experiment: str, saved: dict) -> dict:
    """train_config.json values back to ExperimentConfig field types: lists
    back to tuples, and a loud failure on a str where the preset holds a
    non-str value (the field did not round-trip)."""
    preset = get_experiment(experiment)
    out = {}
    for key, val in saved.items():
        if not hasattr(preset, key):
            raise ValueError(f"train_config.json field {key!r} is not an ExperimentConfig "
                             f"field (config schema drift?)")
        ref = getattr(preset, key)
        if isinstance(val, list) and (isinstance(ref, tuple) or ref is None):
            val = tuple(val)
        elif isinstance(val, str) and ref is not None and not isinstance(ref, str):
            raise ValueError(
                f"train_config.json field {key!r} stringified to {val!r} (preset holds "
                f"{type(ref).__name__}); the config did not round-trip — fix "
                f"_save_resolved_config for this field")
        out[key] = val
    return out


def _config_for_ckpt(args):
    """The config of an evaluate / analyze / predict command: the saved
    ``train_config.json`` of the run that holds ``--ckpt`` (``<run>/
    checkpoints/<tag>``) if there is one, else ``--experiment``'s preset;
    ``--dataset``, ``--dataset-size`` and ``--set`` override it."""
    overrides = {}
    experiment = args.experiment
    if args.ckpt:
        run_dir = os.path.dirname(os.path.dirname(os.path.abspath(args.ckpt)))
        cfg_path = os.path.join(run_dir, "train_config.json")
        if os.path.exists(cfg_path):
            with open(cfg_path) as fh:
                saved = json.load(fh)
            experiment = saved.pop("name", experiment)
            saved.pop("losses", None)  # preset-defined; not a flat override
            overrides.update(_coerce_saved_config(experiment, saved))
    if args.dataset:
        overrides["dataset_path"] = args.dataset
    if getattr(args, "dataset_size", None):
        overrides["dataset_size"] = args.dataset_size
    overrides.update(_parse_set_overrides(getattr(args, "set", None)))
    return get_experiment(experiment, **overrides)


def _resolve(device):
    """The device of a command, with the port's precision policy on the card."""
    from sot_tpu_torch.device import resolve_device, set_precision_policy

    device = resolve_device(device)
    if device.type == "cuda":
        set_precision_policy()
    return device


def _model(cfg, args, device):
    """Modules for ``cfg`` with ``--ckpt``'s encoder weights (or a seed-0
    initialisation without one): a run checkpoint, a ``torch.save`` of the
    encoder's ``state_dict`` or a reference Lightning checkpoint
    (``checkpoint.encoder_state``)."""
    import torch

    from sot_tpu_torch.training import checkpoint as ckpt_lib
    from sot_tpu_torch.training.trainer import build_modules

    mod = build_modules(cfg, device=device, generator=torch.Generator().manual_seed(0))
    if args.ckpt:
        mod.encoder.load_state_dict(ckpt_lib.encoder_state(args.ckpt, mod.encoder))
    return mod


def _train_gates(kernels: str, pin_texts):
    """The gates of ``cli train``: ``--kernels``' preset with the ``--gate``
    pins, which under ``auto`` also remove the candidates they touch
    (``kernel_gates.auto_gates``) and under ``default`` are set on top."""
    from sot_tpu_torch.kernel_gates import auto_gates, parse_pin, resolve_gates

    pins = dict(parse_pin(text) for text in pin_texts or ())
    if kernels == "auto" and pins:
        return auto_gates(pins=pins), pins
    return dataclasses.replace(resolve_gates(kernels), **pins), pins


def _profile_steps(cfg, trace_dir: str, device, kernels, n_steps: int = 5) -> None:
    """A trace of ``n_steps`` train steps on one batch after 3 warm-up steps
    (the JAX package's ``_profile_steps``) and its device-time table: on the
    GPU replays of the step's graph (``train_steps_graph``, captured at the
    first warm-up step), on the CPU the eager steps."""
    import torch

    from sot_tpu_torch import data as data_lib
    from sot_tpu_torch.ops.kernels import launches as launches_lib
    from sot_tpu_torch.training import trainer
    from sot_tpu_torch.training.profiling import print_trace_summary, trace

    mod = trainer.build_modules(cfg, device=device,
                                generator=torch.Generator().manual_seed(cfg.seed),
                                kernels=kernels)
    state = trainer.init_state(mod)
    steps = trainer.train_steps_graph if mod.device.type == "cuda" else trainer.train_steps
    signals, _, _ = data_lib.generate_sinusoid_dataset(
        seed=0, size=cfg.batch_size, n_samples=cfg.n_samples, render_batch=cfg.batch_size,
        device=device)
    x = torch.as_tensor(data_lib.peak_normalize(signals), dtype=torch.float32, device=device)
    steps(mod, state, x, [0] * 3)
    if mod.device.type == "cuda":
        torch.cuda.synchronize()
    before = launches_lib.read()
    with trace(trace_dir):
        steps(mod, state, x, [0] * n_steps)
    counts = launches_lib.delta(before, launches_lib.read())
    print("# kernel launches a step: "
          + ", ".join(f"{k} {v / n_steps:g}" for k, v in counts.items() if v))
    print(f"# device trace -> {trace_dir} (top ops, ms/step):")
    print_trace_summary(trace_dir, steps=n_steps, top=15)


def cmd_train(args: argparse.Namespace) -> int:
    from sot_tpu_torch import data as data_lib
    from sot_tpu_torch.device import card_line
    from sot_tpu_torch.kernel_gates import gates_record
    from sot_tpu_torch.ops.kernels import launches as launches_lib
    from sot_tpu_torch.training.trainer import build_modules, evaluate, make_eval_step, train

    overrides = {}
    if args.config:
        file_overrides = _load_config_files(args.config)
        experiment = file_overrides.pop("experiment", args.experiment)
        overrides.update(file_overrides)
    else:
        experiment = args.experiment
    if args.seed is not None:
        overrides["seed"] = args.seed
    if args.batch_size is not None:
        overrides["batch_size"] = args.batch_size
    if args.dataset is not None:
        overrides["dataset_path"] = args.dataset
    if args.dataset_size is not None:
        overrides["dataset_size"] = args.dataset_size
    if args.eval_every is not None:
        overrides["eval_every_steps"] = args.eval_every
    overrides.update(_parse_set_overrides(args.set))
    cfg = get_experiment(experiment, **overrides)
    gates, pins = _train_gates(args.kernels, args.gate)
    device = _resolve(args.device)
    print(f"kernel gates ({args.kernels}{' + --gate pins' if pins else ''}): {gates}")

    out = args.out or f"runs/{cfg.name}-{cfg.seed}"
    os.makedirs(out, exist_ok=True)
    _save_resolved_config(cfg, out)
    record = {"kernels": args.kernels, "pins": list(args.gate or ()),
              "gates": gates_record(gates), "command": args.command_line,
              "device": card_line(device)}

    def write_record():
        with open(os.path.join(out, "kernel_gates.json"), "w") as fh:
            json.dump(record, fh, indent=2)

    write_record()

    if args.profile:
        _profile_steps(cfg, os.path.join(out, "trace"), device, gates)

    splits = data_lib.dataset_from_config(cfg, device=device)
    before = launches_lib.read()
    mod, _, best = train(cfg, max_steps=args.steps,
                         checkpoint_dir=os.path.join(out, "checkpoints"),
                         log_file=os.path.join(out, "log.jsonl"), splits=splits,
                         resume_from=args.resume, figure_dir=out if args.figures else None,
                         device=device, kernels=gates)
    # the hand-written kernels that trained and evaluated the run, by launches
    record["train_launches"] = {k: v for k, v in
                                launches_lib.delta(before, launches_lib.read()).items() if v}
    write_record()
    with open(os.path.join(out, "best_metrics.json"), "w") as fh:
        json.dump(best, fh, indent=2)
    print(json.dumps({"best_val_metrics": best}))

    if args.final_eval and "test" in splits:
        # the best-LSD parameters (train() leaves them in mod.encoder) on the
        # test split: plain, octave-corrected and comb-corrected
        params = mod.encoder.state_dict()
        for variant, fname in (("plain", "test_metrics.json"),
                               ("octcorr", "test_metrics_octcorr.json"),
                               ("comb", "test_metrics_comb.json")):
            cfg_e = cfg.replace(eval_octave_correction=variant == "octcorr",
                                eval_comb_correction=variant == "comb")
            mod_e = build_modules(cfg_e, device=device, kernels=gates)
            mod_e.encoder.load_state_dict(params)
            m = evaluate(mod_e, make_eval_step(mod_e), splits["test"], cfg.batch_size)
            with open(os.path.join(out, fname), "w") as fh:
                json.dump({"test_metrics": m}, fh, indent=2)
            key = "test_metrics" + ("" if variant == "plain" else f"_{variant}")
            print(json.dumps({key: m}))
    return 0


def cmd_evaluate(args: argparse.Namespace) -> int:
    from sot_tpu_torch import data as data_lib
    from sot_tpu_torch.training.trainer import evaluate, make_eval_step

    cfg = _config_for_ckpt(args)
    device = _resolve(args.device)
    mod = _model(cfg, args, device)
    splits = data_lib.dataset_from_config(cfg, device=device)
    if args.split not in splits:
        raise SystemExit(f"split '{args.split}' not present in dataset "
                         f"(available: {sorted(splits)})")
    metrics = evaluate(mod, make_eval_step(mod), splits[args.split], cfg.batch_size)
    print(json.dumps({f"{args.split}_metrics": metrics}, indent=2))
    return 0


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

    from sot_tpu_torch import data as data_lib
    from sot_tpu_torch.training.trainer import predict

    cfg = _config_for_ckpt(args)
    mod = _model(cfg, args, _resolve(args.device))

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


def cmd_generate_data(args: argparse.Namespace) -> int:
    import numpy as np

    from sot_tpu_torch import data as data_lib

    signals, freqs, amps = data_lib.generate_sinusoid_dataset(
        seed=args.seed, size=args.size, device=_resolve(args.device))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez(args.out, signals=signals, frequency=freqs, weights=amps)
    print(f"wrote {args.out}: {signals.shape[0]} items x {signals.shape[1]} samples")
    return 0


def cmd_analyze(args: argparse.Namespace) -> int:
    import numpy as np
    import torch

    from sot_tpu_torch import data as data_lib
    from sot_tpu_torch.analysis import pitch_error_report
    from sot_tpu_torch.training.trainer import (apply_comb_correction,
                                                apply_octave_correction, forward)

    cfg = _config_for_ckpt(args)
    device = _resolve(args.device)
    mod = _model(cfg, args, device)
    split = data_lib.dataset_from_config(cfg, device=device)[args.split]

    chunks = []
    with torch.no_grad():
        for batch in data_lib.iterate_batches(split, cfg.batch_size, drop_last=False):
            x = torch.as_tensor(batch["x"], dtype=torch.float32, device=device)
            pitch_hz = forward(mod, x)["pitch_hz"]
            if args.correction == "octave":
                pitch_hz, _ = apply_octave_correction(mod, x, pitch_hz)
            elif args.correction == "comb":
                pitch_hz, _ = apply_comb_correction(mod, x, pitch_hz)
            chunks.append(pitch_hz.cpu().numpy())
    pitch = np.concatenate(chunks)[:, :, 0]
    report = pitch_error_report(pitch, split.frequency[:pitch.shape[0], 0])
    print(json.dumps(report, indent=2))
    return 0


def cmd_list(_args: argparse.Namespace) -> int:
    for name, cfg in EXPERIMENTS.items():
        loss_desc = " + ".join(f"{lc.weight}x{lc.kind}" for lc in cfg.losses)
        print(f"{name:14s} transform={cfg.transform}:{cfg.transform_n_fft} "
              f"losses=[{loss_desc}] rolloff={cfg.apply_roll_off}")
    print(f"paper seeds: {PAPER_SEEDS}")
    return 0


def _device_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default=None,
                   help="'cuda' (default; fails without a GPU) or 'cpu'")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="sot_tpu_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="command", required=True)

    t = sub.add_parser("train", help="train an experiment")
    t.add_argument("--experiment", default="SOT-2048", choices=sorted(EXPERIMENTS))
    t.add_argument("--seed", type=int, default=None)
    t.add_argument("--steps", type=int, default=None)
    t.add_argument("--batch-size", type=int, default=None)
    t.add_argument("--dataset", default=None, help="path to reference .pth dataset")
    t.add_argument("--dataset-size", type=int, default=None)
    t.add_argument("--eval-every", type=int, default=None)
    t.add_argument("--out", default=None)
    t.add_argument("--resume", default=None, help="checkpoint path to resume from")
    t.add_argument("--config", action="append", default=None,
                   help="JSON (or, with PyYAML, YAML) config override file (repeatable; a "
                        "'configs:' list inside expands to more files)")
    t.add_argument("--set", action="append", default=None, metavar="KEY=VAL",
                   help="generic config field override (repeatable)")
    t.add_argument("--kernels", default="default", choices=("default", "auto"),
                   help="the port's kernel-gate preset (kernel_gates.PRESETS): 'auto' the "
                        "committed H100 A/B winners (sot_tpu_torch/adoption/), 'default' "
                        "every gate off")
    t.add_argument("--gate", action="append", default=None, metavar="FIELD=VALUE",
                   help="pin one kernel gate (repeatable), the JAX package's SOT_TPU_* "
                        "variables: a KernelGates field (w2_merge=off|full|hybrid|ref, "
                        "w2_merge_small=|off|full|hybrid|ref, conv, conv_bf16, "
                        "stft_frontend, dft_matmul =true|false, conv_dtype=bfloat16|float32); "
                        "under 'auto' a pin removes the candidates that touch its field")
    t.add_argument("--figures", action="store_true",
                   help="write spectrum/probability figures each eval epoch (needs matplotlib)")
    t.add_argument("--profile", action="store_true",
                   help="first trace 5 warmed-up train steps into <out>/trace and print the "
                        "device-time table (on the GPU, replays of the step's CUDA graph)")
    t.add_argument("--final-eval", action="store_true",
                   help="after training, evaluate the best-LSD params on the test split "
                        "(plain, octave- and comb-corrected) and write "
                        "test_metrics{,_octcorr,_comb}.json into the run dir")
    _device_flag(t)
    t.set_defaults(fn=cmd_train)

    e = sub.add_parser("evaluate", help="evaluate a checkpoint")
    e.add_argument("--experiment", default="SOT-2048", choices=sorted(EXPERIMENTS))
    e.add_argument("--ckpt", default=None)
    e.add_argument("--dataset", default=None)
    e.add_argument("--dataset-size", type=int, default=None)
    e.add_argument("--split", default="test", choices=("train", "val", "test"))
    e.add_argument("--set", action="append", default=None, metavar="KEY=VAL")
    _device_flag(e)
    e.set_defaults(fn=cmd_evaluate)

    pr = sub.add_parser("predict", help="batch inference on audio clips")
    pr.add_argument("--experiment", default="SOT-2048", choices=sorted(EXPERIMENTS))
    pr.add_argument("--ckpt", required=True,
                    help="a run checkpoint, a torch.save of the encoder state_dict or a "
                         "reference Lightning checkpoint")
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
                    help="config overrides, e.g. inference_comb_correction=true")
    _device_flag(pr)
    pr.set_defaults(fn=cmd_predict)

    g = sub.add_parser("generate-data", help="generate the synthetic dataset")
    g.add_argument("--out", default="data/sinusoids.npz")
    g.add_argument("--seed", type=int, default=0)
    g.add_argument("--size", type=int, default=4000)
    _device_flag(g)
    g.set_defaults(fn=cmd_generate_data)

    a = sub.add_parser("analyze", help="pitch-error breakdown of a checkpoint")
    a.add_argument("--experiment", default="SOT-2048", choices=sorted(EXPERIMENTS))
    a.add_argument("--ckpt", required=True)
    a.add_argument("--dataset", default=None)
    a.add_argument("--dataset-size", type=int, default=None)
    a.add_argument("--split", default="val", choices=("train", "val", "test"))
    a.add_argument("--set", action="append", default=None, metavar="KEY=VAL")
    a.add_argument("--correction", default="none", choices=("none", "octave", "comb"),
                   help="apply a test-time correction before the breakdown "
                        "(classifies the post-correction residual)")
    _device_flag(a)
    a.set_defaults(fn=cmd_analyze)

    ls = sub.add_parser("list", help="list experiment presets")
    ls.set_defaults(fn=cmd_list)
    return p


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    args.command_line = "python -m sot_tpu_torch.cli " + shlex.join(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
