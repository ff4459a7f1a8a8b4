"""Readings that the comparison's limits are set from (not run by the
benchmark's own runs): for each seed, the program's numbers after a cell's
set-up (and, for a serving cell, a short window); on the control seeds,
those of the control (the reference in TF32 put in the program's place)
and of each fault (``tools/faults.py`` planted in the reference for a
training cell; half of a request left out and one sample altered for a
serving cell), all read by the cell's own comparison. One process, one
cell:

    python3 -m portbench.tools.readings --workload sot2048-train \\
        --seeds 1,2,3 --control-seeds 1,2,3 --out readings.jsonl [--kernels]

``--kernels`` also traces one window on the first seed and writes every
device kernel's name, count and microseconds (the names the roofline
readers match). A serving cell also reads the served x_hat against the
program's own plain synth on the served controls (its float64-phase path).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from portbench import check, load, program, spec, trace
from portbench.compare import pesto_sot as compare
from portbench.tools import faults


def program_readings(cell, seed: int, seconds: float, kernels_out=None, device="cuda",
                     program_cls=None):
    work = load.KINDS[cell.traffic["kind"]](cell, seed, torch.device(device),
                                             program_cls or program.adapter(cell))
    t0 = time.perf_counter()
    work.setup()
    out = {"setup_s": time.perf_counter() - t0}
    if work.kind == "serve":
        out["window_s"] = work.window(seconds)
        out["requests"] = work.units
    if kernels_out is not None:
        events = work.traced(1.0)
        tr = trace.Trace(events, work.kind, work.units, work.clips_per_unit, cell.config)
        by = {}
        for name, a, b in tr.kernels:
            n, us = by.get(name, (0, 0.0))
            by[name] = (n + 1, us + b - a)
        kernels_out.update({"units": tr.units, "window_s": tr.window_s, "busy_s": tr.busy_us / 1e6,
                            "kernels": sorted(([k, n, us] for k, (n, us) in by.items()),
                                              key=lambda r: -r[2])})
    if work.kind == "serve":
        out.update(plain_synth_gap(work))
    work.release()
    out.update(work.check())
    return out, work


def plain_synth_gap(work) -> dict:
    """The served x_hat against the program's plain synth (float64 phase)
    on the served controls, for the sampled requests."""
    from sot_tpu_torch.ops.kernels.synth import synth_render_plain

    synth, dev = work.program.mod.decoder, work.device
    gap = 0.0
    with torch.no_grad():
        for i in work.sample():
            got = work.latest[i]
            controls = synth.get_controls(torch.as_tensor(got["weights"], device=dev),
                                          torch.as_tensor(got["pitch_hz"], device=dev))
            plain = synth_render_plain(controls["amplitudes"], controls["frequencies"],
                                       synth.n_samples, synth.sample_rate)
            gap = max(gap, check.max_gap(got["x_hat"], plain))
    return {"xhat_port_plain_rel": gap}


def control_readings(cell, work) -> dict:
    """The control and the faults, on the same inputs as ``work``'s: each
    put in the program's place and read by the cell's comparison."""
    dev = work.device
    cfg = cell.config
    out = {}
    if work.kind == "train":
        batches = work.check_batches()
        ref = compare.train_reference(cfg, dev, work.weights0, batches, work.dropout_seed)
        tf32 = compare.first_update(cfg, dev, work.weights0, batches, work.dropout_seed, lower=True)

        def read(model):
            got = compare.train_reference(cfg, dev, work.weights0, batches, work.dropout_seed,
                                        model=model)
            return compare.train_compare(ref, tf32, work.weights0, got["losses"],
                                       got["first_grad"], got["params"])

        out["control"] = read(faults.model(cfg, dev, lower=True))
        for name in faults.applicable(cfg):
            out[name] = read(faults.model(cfg, dev, fault=name))
        return out
    from portbench.reference import pesto_sot as ref_model

    picks = work.sample()
    clips = [work.pool[i] for i in picks]
    ctl_model = ref_model.Model(cfg, dev, ref_model.Precision(lower=True))
    served = []
    with torch.no_grad(), ctl_model.precision.active(dev):
        for x in clips:
            o = ctl_model.forward(work.weights0, torch.from_numpy(x).to(dev))
            served.append({k: (v if k == "x_hat" else v.cpu().numpy()) for k, v in o.items()})
    model = ref_model.Model(cfg, dev)
    out["control"] = compare.serve_compare(model, work.weights0, clips, served)
    halves, altered = [], []
    for got in (work.latest[i] for i in picks):
        h = {k: (v.clone() if torch.is_tensor(v) else np.array(v)) for k, v in got.items()}
        n = h["x_hat"].shape[0] // 2
        for k in h:
            h[k][n:] = 0
        halves.append(h)
        a = dict(got, x_hat=got["x_hat"].clone())
        a["x_hat"][0, 0] += 1e-3 * float(torch.max(torch.abs(a["x_hat"])))
        altered.append(a)
    out["half_batch"] = compare.serve_compare(model, work.weights0, clips, halves)
    out["altered"] = compare.serve_compare(model, work.weights0, clips, altered)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--out", required=True)
    ap.add_argument("--kernels", action="store_true")
    args = ap.parse_args(argv)
    cell = spec.Cell(args.workload)
    program.set_policy()
    program.build_kernels()
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    with out.open("a") as fh:
        for n, seed in enumerate(int(s) for s in args.seeds.split(",")):
            kern = {} if args.kernels and n == 0 else None
            rec, work = program_readings(cell, seed, args.seconds, kern)
            row = {"workload": args.workload, "seed": seed, "program": rec}
            if seed in controls:
                row.update(control_readings(cell, work))
            if kern:
                row["trace"] = kern
            del work
            torch.cuda.empty_cache()
            fh.write(json.dumps(row) + "\n")
            fh.flush()
            short = {k: v for k, v in row.items() if k not in ("workload", "seed", "trace")}
            print(seed, json.dumps(short), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
