"""Readings behind the training comparison's design (not run by the
benchmark's runs): for each seed of a training cell, the program's first
update against the float32 reference, beside second witnesses that share
no code with the program, on the same batch and dropout draws:

* ``ulp<k>``: the reference itself with every weight moved by one ulp, in
  signs drawn from the seed (how far rounding alone moves each number at
  this seed);
* ``control``: the reference in the next lower precision;
* faults planted in the reference put in the program's place (``FAULTS``).

For the SOT configuration it also holds the program's transform STFT and
W2 (on the card and on its CPU path) against the reference's on the same
spectra. One process, one cell:

    python3 -m portbench.tools.witness --workload sot2048-train --seeds 1,2 \\
        --out witness.jsonl [--isolate]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Dict

import torch

from portbench import check, load, program, spec
from portbench.reference import dsp
from portbench.reference import pesto_sot as ref_model
from portbench.tools import faults


def leaf_numbers(got: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]) -> dict:
    """Per leaf: [|got - ref| / |ref|, | |got| - |ref| | / max(|ref|, median |ref|)]."""
    keys = list(ref)
    gaps = check.leaf_gaps(got, ref, keys)
    return {k: [float((got[k].double() - ref[k].double()).norm() / ref[k].double().norm()), gaps[i]]
            for i, k in enumerate(keys)}


def isolate_sot(cell, work, seed: int) -> dict:
    """The program's transform and W2 against the reference's on the
    reference's own clips and x_hat of the first checked batch."""
    cfg, dev = cell.config, work.device
    x = work.check_batches()[0]
    model = ref_model.Model(cfg, dev)
    with torch.no_grad(), model.precision.active(dev):
        x_hat = model.forward(work.weights0, x)["x_hat"]
    prog = work.program_cls(cfg, work.weights0, dev)
    mod = prog.mod
    n_fft, hop = cfg["transform_n_fft"], cfg["transform_hop"]
    lc = next(lc for lc in cfg["losses"] if lc["kind"] == "wasserstein")
    fn = next(f for kind, f, _ in mod.loss_fns if kind != "mss")
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = {}

    # transform: forward and a VJP with a seeded cotangent
    xr = x_hat.clone().requires_grad_(True)
    xp = x_hat.clone().requires_grad_(True)
    with model.precision.active(dev):
        sr = dsp.stft_magnitude(xr, n_fft, hop, model.transform_window)
    sp = mod.transform(xp)
    cot = torch.randn(sr.shape, generator=gen, device=dev)
    (gr,) = torch.autograd.grad(sr, xr, cot)
    (gp,) = torch.autograd.grad(sp, xp, cot)
    out["transform_rel"] = check.max_gap(sp.detach(), sr.detach())
    out["transform_vjp_rel"] = float((gp - gr).norm() / gr.norm())

    # W2 on the reference's spectra: value and gradient wrt the value side
    with torch.no_grad(), model.precision.active(dev):
        sx = dsp.stft_magnitude(x, n_fft, hop, model.transform_window)
        sy = dsp.stft_magnitude(x_hat, n_fft, hop, model.transform_window)
    n = sx.shape[-1]

    def ref_w2(a, b):
        b = b.clone().requires_grad_(True)
        m = ref_model.Model(cfg, a.device)
        w = torch.mean(ref_model.w2_rows(m.grid, a.reshape(-1, n), b.reshape(-1, n), lc))
        (g,) = torch.autograd.grad(w, b)
        return float(w), g

    def prog_w2(a, b):
        b = b.clone().requires_grad_(True)
        w = fn(a, b, x_pos=mod.x_pos, y_pos=mod.x_pos)
        (g,) = torch.autograd.grad(w, b)
        return float(w), g

    wr, gr = ref_w2(sx, sy)
    wp, gp = prog_w2(sx, sy)
    wc, gc = prog_w2(sx.cpu(), sy.cpu())
    wrc, grc = ref_w2(sx.cpu(), sy.cpu())
    rows = lambda g: g.reshape(-1, n).double()  # noqa: E731

    def row_gap(g, r):
        d = (rows(g).cpu() - rows(r).cpu()).norm(dim=1) / rows(r).cpu().norm(dim=1).clamp_min(1e-30)
        return float(d.max()), int((d > 1e-3).sum())

    out.update({
        "w2_card_rel": abs(wp - wr) / abs(wr), "w2_cpu_rel": abs(wc - wrc) / abs(wrc),
        "w2_ref_card_cpu_rel": abs(wr - wrc) / abs(wrc),
        "w2_grad_card_rel": float((gp - gr).norm() / gr.norm()),
        "w2_grad_cpu_rel": float((gc - grc).norm() / grc.norm()),
        "w2_grad_card_vs_cpu_rel": float((gp.cpu() - gc).norm() / gc.norm()),
        "w2_grad_ref_card_vs_cpu_rel": float((gr.cpu() - grc).norm() / grc.norm()),
        "w2_grad_card_worst_row": row_gap(gp, gr), "w2_grad_cpu_worst_row": row_gap(gc, grc),
    })
    prog.close()
    return out


def seed_readings(cell, seed: int, isolate: bool) -> dict:
    dev = torch.device("cuda")
    cfg = cell.config
    work = load.TrainEpoch(cell, seed, dev, program.adapter(cell))
    work.setup()
    work.release()
    batch = work.check_batches()[:1]
    prog_grad = {k: v / 0.1 for k, v in work.first_moments.items()}
    ref = faults.first_update(cfg, dev, work.weights0, batch, work.dropout_seed)
    row = {"seed": seed, "losses": {"program": work.losses[0], "reference": ref["loss"]},
           "leaves": {"program": leaf_numbers(prog_grad, ref["grad"])}}
    variants = {f"ulp{k}": dict(weights=faults.one_ulp(work.weights0, seed * 4 + k))
                for k in range(1, 4)}
    variants["control"] = dict(lower=True)
    variants.update({name: dict(fault=name) for name in faults.applicable(cfg)})
    for name, kw in variants.items():
        w = kw.pop("weights", work.weights0)
        got = faults.first_update(cfg, dev, w, batch, work.dropout_seed, **kw)
        row["losses"][name] = got["loss"]
        row["leaves"][name] = leaf_numbers(got["grad"], ref["grad"])
    if isolate and cfg["transform"] == "stft":
        row["isolate"] = isolate_sot(cell, work, seed)
    return row


def k_ulps(weights: Dict[str, torch.Tensor], seed: int, k: int) -> Dict[str, torch.Tensor]:
    out = weights
    for i in range(k):
        out = faults.one_ulp(out, seed * 64 + i)
    return out


def near_nyquist(cell, weights, batch, dropout_seed, device) -> dict:
    """Harmonic-frames and samples of the reference's first forward whose
    frequency lies within 1e-5 (relative) of Nyquist, where the synth's
    ``>=`` masks switch a harmonic on or off."""
    cfg = cell.config
    model = ref_model.Model(cfg, device)
    gen = torch.Generator(device=device).manual_seed(dropout_seed)
    with torch.no_grad(), model.precision.active(device):
        out = model.forward(weights, batch, dropout_gen=gen)
    nyq = cfg["sample_rate"] / 2.0
    k = torch.arange(1, cfg["n_modes"] + 1, device=device, dtype=torch.float64)
    f = out["pitch_hz"].double() * k
    return {"frames_1e-5": int((torch.abs(f / nyq - 1.0) < 1e-5).sum()),
            "frames_1e-6": int((torch.abs(f / nyq - 1.0) < 1e-6).sum())}


def deep_readings(cell, seed: int) -> dict:
    """One seed looked at closely: the program twice in one process (does it
    repeat itself?), the reference on the CPU against the reference on the
    card, the program's own CPU path, and the reference with its weights
    moved by 1, 4 and 16 ulps in four draws each."""
    dev = torch.device("cuda")
    cfg = cell.config
    progs = []
    for _ in range(2):
        work = load.TrainEpoch(cell, seed, dev, program.adapter(cell))
        work.setup()
        work.release()
        progs.append({k: v / 0.1 for k, v in work.first_moments.items()})
        losses = work.losses[0]
    batch = work.check_batches()[:1]
    ref = faults.first_update(cfg, dev, work.weights0, batch, work.dropout_seed)
    row = {"seed": seed, "program_repeat": leaf_numbers(progs[1], progs[0]),
           "program": leaf_numbers(progs[0], ref["grad"]),
           "losses": {"program": losses, "reference": ref["loss"]}}
    cpu = torch.device("cpu")
    w_cpu = {k: v.cpu() for k, v in work.weights0.items()}
    ref_cpu = faults.first_update(cfg, cpu, w_cpu, [batch[0].cpu()], work.dropout_seed,
                                  draws_on=dev)
    row["reference_cpu_losses"] = ref_cpu["loss"]
    row["reference_cpu"] = leaf_numbers({k: v.to(dev) for k, v in ref_cpu["grad"].items()},
                                        ref["grad"])
    row["near_nyquist"] = near_nyquist(cell, work.weights0, batch[0], work.dropout_seed, dev)
    for k in (1, 4, 16):
        for d in range(4):
            got = faults.first_update(cfg, dev, k_ulps(work.weights0, seed * 8 + d, k), batch,
                                      work.dropout_seed)
            row[f"ulp{k}_{d}"] = leaf_numbers(got["grad"], ref["grad"])
            row["losses"][f"ulp{k}_{d}"] = got["loss"]
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--isolate", action="store_true")
    ap.add_argument("--deep", action="store_true")
    args = ap.parse_args(argv)
    cell = spec.Cell(args.workload)
    program.set_policy()
    program.build_kernels()
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    with out.open("a") as fh:
        for seed in (int(s) for s in args.seeds.split(",")):
            row = (deep_readings(cell, seed) if args.deep
                   else seed_readings(cell, seed, args.isolate))
            row["workload"] = args.workload
            torch.cuda.empty_cache()
            fh.write(json.dumps(row) + "\n")
            fh.flush()
            print(seed, json.dumps({k: row[k] for k in ("losses", "isolate") if k in row}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
