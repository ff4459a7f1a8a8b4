"""The paper's table (L8), port of ``sot_tpu/eval_paper.py``: per experiment
family, evaluate the best-LSD checkpoint of each seed on the test split,
rename the metrics to the paper's columns (LSD, MSE, MSS, OD*-1, RPA*100,
RCA*100), aggregate mean(std) and median per family, mark the best and
second best, and write the CSV (LaTeX-ready cells) and JSON files.

    python -m sot_tpu_torch.eval_paper --runs-dir runs --out results_port/ \
        [--dataset PATH] [--experiments SOT-2048 MSS-Lin ...] [--device cpu]

Runs are laid out as ``<runs-dir>/<EXPERIMENT>-<seed>/checkpoints/best-lsd``,
what ``python -m sot_tpu_torch.cli train`` writes: ``best-lsd`` is a file
(``training/checkpoint.py``). A directory belongs to a family only when its
name is exactly ``<EXPERIMENT>-<digits>``, so ``SOT-2048-SS-42`` counts in
SOT-2048-SS's row and not in SOT-2048's. A run without a readable
``best-lsd`` file is named on stdout and left out. Each run is evaluated
with its own saved ``train_config.json`` (``cli._config_for_ckpt``).
Evaluation runs on the GPU unless ``--device cpu`` asks for the CPU;
without a GPU and without ``--device`` it raises.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import re
from typing import Dict, List, Optional, Tuple

import numpy as np

from sot_tpu_torch.device import DeviceLike

RENAME = {
    "log_spectral_distance": ("LSD", 1.0),
    "mse": ("MSE", 1.0),
    "mss": ("MSS", 1.0),
    "octave_difference": ("OD", -1.0),
    "raw_pitch_accuracy": ("RPA", 100.0),
    "raw_chroma_accuracy": ("RCA", 100.0),
}
HIGHER_BETTER = {"RPA", "RCA"}
FILES = ("synthetic_results_best-lsd.json", "synthetic_results_paper_best-lsd.json",
         "synthetic_results_paper_best-lsd.csv")


def rename_metrics(metrics: Dict[str, float]) -> Dict[str, float]:
    out = {}
    for key, (name, scale) in RENAME.items():
        if key in metrics:
            out[name] = metrics[key] * scale
    return out


def best_lsd_path(run_dir: str) -> str:
    return os.path.join(run_dir, "checkpoints", "best-lsd")


def family_runs(runs_dir: str, experiment: str) -> List[str]:
    """The run directories of ``experiment``: names exactly
    ``<experiment>-<digits>``, sorted."""
    pattern = re.compile(re.escape(experiment) + r"-\d+")
    if not os.path.isdir(runs_dir):
        return []
    return sorted(os.path.join(runs_dir, name) for name in os.listdir(runs_dir)
                  if pattern.fullmatch(name) and os.path.isdir(os.path.join(runs_dir, name)))


def unreadable(run_dir: str) -> Optional[str]:
    """Why the run's ``best-lsd`` cannot be evaluated, or None if it is a
    run checkpoint of this package."""
    from sot_tpu_torch.training import checkpoint as ckpt_lib

    path = best_lsd_path(run_dir)
    if not os.path.exists(path):
        return "no checkpoints/best-lsd"
    if not os.path.isfile(path):
        return "checkpoints/best-lsd is a directory, not this package's checkpoint file"
    try:
        ckpt_lib.load(path)
    except (OSError, EOFError, RuntimeError, ValueError, pickle.UnpicklingError) as exc:
        return f"checkpoints/best-lsd is not readable ({type(exc).__name__}: {exc})"
    return None


def evaluate_run(experiment: str, run_dir: str, dataset: Optional[str], split: str = "test",
                 device: DeviceLike = None) -> Dict[str, float]:
    """``evaluate`` of the run's ``best-lsd`` parameters on ``split``, with
    the run's own saved config (so a run trained with ``--set`` overrides
    is evaluated on its own data)."""
    from sot_tpu_torch import data as data_lib
    from sot_tpu_torch.cli import _config_for_ckpt
    from sot_tpu_torch.training import checkpoint as ckpt_lib
    from sot_tpu_torch.training.trainer import build_modules, evaluate, make_eval_step

    ckpt = best_lsd_path(run_dir)
    cfg = _config_for_ckpt(argparse.Namespace(ckpt=ckpt, experiment=experiment,
                                              dataset=dataset, dataset_size=None, set=None))
    mod = build_modules(cfg, device=device)
    mod.encoder.load_state_dict(ckpt_lib.load(ckpt)["encoder"])
    splits = data_lib.dataset_from_config(cfg, device=mod.device)
    return evaluate(mod, make_eval_step(mod), splits[split], cfg.batch_size)


def aggregate(rows: List[Dict[str, float]]) -> Dict[str, Dict[str, float]]:
    """mean/std/median and the count per metric."""
    out = {}
    for k in rows[0].keys():
        vals = np.array([r[k] for r in rows], dtype=np.float64)
        out[k] = {"mean": float(vals.mean()), "std": float(vals.std()),
                  "median": float(np.median(vals)), "n": int(len(vals))}
    return out


def format_paper_table(table: Dict[str, Dict[str, Dict[str, float]]]) -> List[str]:
    """LaTeX-ready 'mean(std)' rows with \\textbf best and \\emph second best
    per column (OD: closest to zero). Cells backed by fewer seeds than the
    paper's five say so: n = 1 renders as ``mean(n=1)``, 1 < n < 5 appends
    ``[n=k]``."""
    if not table:
        return []
    metrics = list(next(iter(table.values())).keys())
    exps = list(table.keys())
    ranks: Dict[str, Dict[str, int]] = {m: {} for m in metrics}
    for m in metrics:
        means = {e: table[e][m]["mean"] for e in exps}
        order = sorted(exps, key=lambda e: means[e], reverse=(m in HIGHER_BETTER))
        if m == "OD":  # closest to zero wins
            order = sorted(exps, key=lambda e: abs(means[e]))
        for rank, e in enumerate(order):
            ranks[m][e] = rank
    lines = ["experiment," + ",".join(metrics)]
    for e in exps:
        cells = []
        for m in metrics:
            cell = table[e][m]
            n = cell.get("n", 5)
            if n == 1:
                s = f"{cell['mean']:.3f}(n=1)"
            else:
                s = f"{cell['mean']:.3f}({cell['std']:.3f})"
                if n < 5:
                    s += f"[n={n}]"
            if ranks[m][e] == 0:
                s = "\\textbf{%s}" % s
            elif ranks[m][e] == 1:
                s = "\\emph{%s}" % s
            cells.append(s)
        lines.append(e + "," + ",".join(cells))
    return lines


def paper_table(runs_dir: str, experiments: List[str], dataset: Optional[str],
                device: DeviceLike) -> Tuple[List[Dict], Dict[str, Dict[str, Dict[str, float]]]]:
    """(per-run rows, {family: aggregate}) over the families' runs; each run
    left out is named on stdout."""
    per_run_rows: List[Dict] = []
    table: Dict[str, Dict[str, Dict[str, float]]] = {}
    for exp in experiments:
        run_dirs = family_runs(runs_dir, exp)
        rows = []
        for rd in run_dirs:
            reason = unreadable(rd)
            if reason is not None:
                print(f"{exp}: skipped {rd}: {reason}")
                continue
            metrics = rename_metrics(evaluate_run(exp, rd, dataset, device=device))
            metrics["run"] = os.path.basename(rd)
            per_run_rows.append({"experiment": exp, **metrics})
            rows.append({k: v for k, v in metrics.items() if k != "run"})
            print(json.dumps({"experiment": exp, "run": rd,
                              **{k: round(v, 4) for k, v in rows[-1].items()}}))
        if rows:
            table[exp] = aggregate(rows)
        elif run_dirs:
            print(f"{exp}: {len(run_dirs)} run(s), none with a readable checkpoints/best-lsd; "
                  f"no row")
    return per_run_rows, table


def main(argv=None) -> int:
    from sot_tpu_torch.cli import _resolve
    from sot_tpu_torch.configs import EXPERIMENTS

    p = argparse.ArgumentParser(prog="sot_tpu_torch.eval_paper", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--runs-dir", default="runs")
    p.add_argument("--out", default="results")
    p.add_argument("--dataset", default=None, help="reference .pth test dataset")
    p.add_argument("--experiments", nargs="*", default=None)
    p.add_argument("--device", default=None,
                   help="'cuda' (default; fails without a GPU) or 'cpu'")
    args = p.parse_args(argv)

    device = _resolve(args.device)
    os.makedirs(args.out, exist_ok=True)
    experiments = args.experiments or sorted(EXPERIMENTS)
    per_run_rows, table = paper_table(args.runs_dir, experiments, args.dataset, device)

    runs_json, paper_json, paper_csv = (os.path.join(args.out, f) for f in FILES)
    with open(runs_json, "w") as fh:
        json.dump(per_run_rows, fh, indent=2)
    with open(paper_json, "w") as fh:
        json.dump(table, fh, indent=2)
    with open(paper_csv, "w") as fh:
        fh.write("\n".join(format_paper_table(table)) + "\n")

    # console table
    if table:
        metrics = list(next(iter(table.values())).keys())
        print("experiment".ljust(14) + "".join(m.ljust(26) for m in metrics))
        for exp, row in table.items():
            print(exp.ljust(14) + "".join(
                f"{row[m]['mean']:.3f}({row[m]['std']:.3f}) med={row[m]['median']:.3f}".ljust(26)
                for m in metrics))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
