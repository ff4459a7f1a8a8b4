"""25k-step training verdicts of the port (the counterpart of
``scripts/refgrad_train_verdict.py`` and ``scripts/convbf16_train_verdict.py``):

    python -m sot_tpu_torch.train_verdict port --run runs/port-anneal-42 [--out DIR]
    python -m sot_tpu_torch.train_verdict conv --run runs/port-anneal-42-conv \\
        --twin sot_tpu_torch/adoption/runs/port-anneal-42 [--out DIR]

A run directory is ``cli train``'s (``test_metrics{,_comb}.json``,
``log.jsonl``, ``kernel_gates.json``, ``train_config.json``). The checks
are the JAX scripts':
  * the run reaches the recipe: comb-corrected test RPA >= 95;
  * it agrees with its twin: within 3 RPA of the twin's comb RPA;
  * no sustained collapse: val LSD < 70 at 10k steps and < 50 at 25k (a
    step the log does not reach reads as passing, as there).

``port`` writes ``port_train_verdict.json`` (``port_ok``): the port's run
against the JAX package's committed twin on a TPU v5e,
``results/round2/runs/r4/refverd-ref-anneal-42`` (its test metrics; its
val-LSD trajectory from ``results/round2/refgrad_train_verdict.json``),
read as data. ``kernel_gates.auto_gates`` does not read it: it is the
port's own evidence that it trains the recipe. ``conv`` writes
``conv_train_verdict.json`` (``conv_ok``), which ``auto_gates`` reads: the
run with kernels B10/B11 against a port twin of the same seed, data,
initialisation and gates, only the conv pins differing (checked on the
two runs' ``train_config.json`` and ``kernel_gates.json``).

Each verdict holds the metrics and the val-LSD trajectory it was decided
on, the command lines, the card's name and power limit and the protocol,
and the run's small outputs are copied to ``<out>/runs/<run name>/`` (the
val lines of ``log.jsonl`` only). Runs on the GPU unless ``--device cpu``
asks for the CPU (it only reads files; the device names where the verdict
was written), and a CPU verdict is refused into ``ADOPTION_DIR``. Exit
code 0 when the verdict passes, 2 when it fails, 1 when a run is
incomplete.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import shlex
import shutil
import sys
from typing import Dict, Optional

from sot_tpu_torch.kernel_gates import ADOPTION_DIR

# the JAX package's twin, by its path in the repository
JAX_TWIN = "results/round2/runs/r4/refverd-ref-anneal-42"
JAX_TWIN_VERDICT = "results/round2/refgrad_train_verdict.json"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN_FILES = ("test_metrics.json", "test_metrics_comb.json", "test_metrics_octcorr.json",
             "best_metrics.json", "kernel_gates.json", "train_config.json")
CONV_FIELDS = ("conv", "conv_dtype")
RECIPE_RPA, TWIN_RPA, LSD_10K, LSD_25K = 95.0, 3.0, 70.0, 50.0


def read_metrics(base: str, sub: str) -> Optional[Dict[str, Dict[str, float]]]:
    """``{plain, comb}: {RPA, RCA, LSD}`` of a run's test metrics
    (``scripts/refgrad_train_verdict.py:read_metrics`` on ``base`` alone)."""
    out = {}
    d = os.path.join(base, sub)
    for variant, suffix in (("plain", ""), ("comb", "_comb")):
        fp = os.path.join(d, f"test_metrics{suffix}.json")
        if not os.path.exists(fp):
            continue
        with open(fp) as fh:
            m = json.load(fh)["test_metrics"]
        out[variant] = {
            "RPA": round(100 * m["raw_pitch_accuracy"], 2),
            "RCA": round(100 * m["raw_chroma_accuracy"], 2),
            "LSD": round(m["log_spectral_distance"], 2),
        }
    return out or None


def loss_trajectory(base: str, sub: str, at_steps=(1000, 3000, 10000, 25000)
                    ) -> Optional[Dict[str, float]]:
    """The val LSD of the last evaluation at or before each of ``at_steps``
    (``scripts/refgrad_train_verdict.py:loss_trajectory``)."""
    fp = os.path.join(base, sub, "log.jsonl")
    if not os.path.exists(fp):
        return None
    vals = []
    with open(fp) as fh:
        for line in fh:
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if rec.get("split") == "val" and "log_spectral_distance" in rec:
                vals.append((rec.get("step", 0), rec["log_spectral_distance"]))
    traj = {}
    for target in at_steps:
        past = [(s, v) for s, v in vals if s <= target]
        if past:
            traj[str(target)] = round(past[-1][1], 2)
    return traj or None


def checks(run: Dict, twin: Dict, traj: Optional[Dict[str, float]]) -> Dict[str, bool]:
    """The three checks on the comb-corrected RPAs and the run's trajectory."""
    rr, rt = run["comb"]["RPA"], twin["comb"]["RPA"]
    t = traj or {}
    lsd10k, lsd25k = t.get("10000"), t.get("25000")
    return {
        "reaches_recipe": rr >= RECIPE_RPA,
        "twins_agree": abs(rr - rt) <= TWIN_RPA,
        "no_sustained_collapse": ((lsd10k is None or lsd10k < LSD_10K)
                                  and (lsd25k is None or lsd25k < LSD_25K)),
    }


def _json(path: str) -> Optional[dict]:
    try:
        with open(path) as fh:
            return json.load(fh)
    except (OSError, ValueError):
        return None


def keep_run(run_dir: str, out_dir: str) -> str:
    """Copy the run's small outputs and the val lines of its log to
    ``<out_dir>/runs/<run name>/``; returns that directory."""
    dst = os.path.join(out_dir, "runs", os.path.basename(os.path.normpath(run_dir)))
    os.makedirs(dst, exist_ok=True)
    for name in RUN_FILES:
        src = os.path.join(run_dir, name)
        if os.path.exists(src):
            shutil.copyfile(src, os.path.join(dst, name))
    log = os.path.join(run_dir, "log.jsonl")
    if os.path.exists(log):
        with open(log) as fh, open(os.path.join(dst, "log.jsonl"), "w") as out:
            for line in fh:
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if rec.get("split") == "val":
                    out.write(line)
    return dst


def _split(path: str):
    path = os.path.normpath(path)
    return os.path.dirname(path), os.path.basename(path)


def _same_but_conv(run_dir: str, twin_dir: str) -> bool:
    """Both runs' resolved configs equal, and their gates equal but for the
    conv pins' fields."""
    cfg_r, cfg_t = (_json(os.path.join(d, "train_config.json")) for d in (run_dir, twin_dir))
    g_r, g_t = (_json(os.path.join(d, "kernel_gates.json")) for d in (run_dir, twin_dir))
    if None in (cfg_r, cfg_t, g_r, g_t):
        return False
    def but_conv(g):
        return {k: v for k, v in g["gates"].items() if k not in CONV_FIELDS}

    return cfg_r == cfg_t and but_conv(g_r) == but_conv(g_t)


PROTOCOLS = {
    "port": ("25k SOT-2048-Anneal seed 42 on the port's auto gates (sot_tpu_torch/adoption/ "
             "as resolved at the run), one NVIDIA H100, comb-corrected test split; against "
             "the JAX package's seed-42 twin on a TPU v5e (results/round2/runs/r4/"
             "refverd-ref-anneal-42, the ref route; its trajectory from results/round2/"
             "refgrad_train_verdict.json). A loose twin: the port's initialisation and "
             "clips differ from JAX's by design, so only the recipe's level is compared"),
    "conv": ("25k SOT-2048-Anneal seed 42 with --gate conv=true --gate conv_dtype=float32 "
             "(kernels B10/B11 in 3xTF32 in place of cuDNN's f32 convs) over the port's "
             "auto, one NVIDIA H100, comb-corrected test split; against the port twin of "
             "the same seed, data, initialisation and gates without the conv pins"),
}


def verdict(kind: str, run_dir: str, twin_dir: Optional[str], device: str,
            command: str) -> Optional[dict]:
    """The verdict document of ``kind`` (``port`` or ``conv``), or None when
    a run's metrics are missing."""
    run = read_metrics(*_split(run_dir))
    traj = loss_trajectory(*_split(run_dir))
    if twin_dir is None and kind == "conv":
        raise ValueError("a conv verdict needs --twin, the port run without the conv pins")
    if twin_dir is None:
        twin_dir = JAX_TWIN
        twin = read_metrics(*_split(os.path.join(REPO, JAX_TWIN)))
        twin_traj = ((_json(os.path.join(REPO, JAX_TWIN_VERDICT)) or {})
                     .get("val_lsd_trajectories", {}).get("ref_anneal"))
    else:
        twin = read_metrics(*_split(twin_dir))
        twin_traj = loss_trajectory(*_split(twin_dir))
    if run is None or twin is None or "comb" not in run or "comb" not in twin:
        return None
    result = checks(run, twin, traj)
    run_gates = _json(os.path.join(run_dir, "kernel_gates.json")) or {}
    twin_gates = _json(os.path.join(twin_dir, "kernel_gates.json")) or {}
    if kind == "conv":
        result["twins_match"] = _same_but_conv(run_dir, twin_dir)
    doc = {
        f"{kind}_ok": all(result.values()),
        "checks": result,
        "limits": {"comb_rpa_min": RECIPE_RPA, "twin_rpa_max_diff": TWIN_RPA,
                   "val_lsd_10k_max": LSD_10K, "val_lsd_25k_max": LSD_25K},
        "protocol": PROTOCOLS[kind],
        "run": {"dir": run_dir, "test": run, "val_lsd_trajectory": traj,
                "gates": run_gates.get("gates"), "device": run_gates.get("device")},
        "twin": {"dir": twin_dir, "test": twin, "val_lsd_trajectory": twin_traj,
                 "gates": twin_gates.get("gates"),
                 "device": twin_gates.get("device") or ("TPU v5e" if twin_dir == JAX_TWIN
                                                        else None)},
        "commands": {"run": run_gates.get("command"), "twin": twin_gates.get("command"),
                     "verdict": command},
        "device": device,
        "date": datetime.date.today().isoformat(),
    }
    return doc


def main(argv=None) -> int:
    from sot_tpu_torch.device import card_line, resolve_device

    argv = sys.argv[1:] if argv is None else list(argv)
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("kind", choices=sorted(PROTOCOLS))
    ap.add_argument("--run", required=True, help="the run directory of cli train")
    ap.add_argument("--twin", default=None,
                    help=f"the twin's run directory (port: default {JAX_TWIN})")
    ap.add_argument("--out", default=ADOPTION_DIR)
    ap.add_argument("--device", default=None, help="'cuda' (default; fails without a GPU) or 'cpu'")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if device.type != "cuda" and os.path.realpath(args.out) == os.path.realpath(ADOPTION_DIR):
        raise SystemExit(f"a CPU verdict is not written into {ADOPTION_DIR}; pass --out")
    doc = verdict(args.kind, args.run, args.twin, card_line(device),
                  "python -m sot_tpu_torch.train_verdict " + shlex.join(argv))
    if doc is None:
        print(f"incomplete: the test metrics of {args.run} or its twin are missing",
              file=sys.stderr)
        return 1
    doc["run"]["kept"] = os.path.relpath(keep_run(args.run, args.out), args.out)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"{args.kind}_train_verdict.json"), "w") as fh:
        json.dump(doc, fh, indent=1)
    print(json.dumps(doc, indent=1))
    return 0 if doc[f"{args.kind}_ok"] else 2


if __name__ == "__main__":
    sys.exit(main())
