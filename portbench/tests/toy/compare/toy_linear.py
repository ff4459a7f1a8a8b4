"""The toy model's comparison: the first step's loss, the first gradient
and the change after the updates against its reference; served pitch,
amplitudes and x_hat against the reference's forward."""

from __future__ import annotations

import torch

from portbench import check, spec

# the model's own reference, as the cell loaded it
ref = spec.load_part("reference", "toy_linear")

# a served request's outputs: on the host, and read on the device
OUTPUTS = {"host": ("pitch_hz", "amplitudes"), "device": ("x_hat",)}


def train_readings(cfg, device, weights0, batches, dropout_seed, losses, first_grad,
                   params_after) -> check.Readings:
    r = ref.train_steps(cfg, weights0, batches)
    keys = sorted(weights0)
    d_ref = {k: r["params"][k] - weights0[k] for k in keys}
    d_got = {k: params_after[k] - weights0[k] for k in keys}
    return {"loss_step1_rel": abs(losses[0]["total"] - r["losses"][0]) / abs(r["losses"][0]),
            "grad_gap": max(check.leaf_gaps(first_grad, r["first_grad"], keys)),
            "change_gap": max(check.leaf_gaps(d_got, d_ref, keys))}


def serve_readings(cfg, device, weights0, clips, served) -> check.Readings:
    out = {"pitch_rel": 0.0, "xhat_rel": 0.0}
    with torch.no_grad():
        for x, got in zip(clips, served):
            r = ref.forward(cfg, weights0, torch.from_numpy(x).to(device))
            out["pitch_rel"] = max(out["pitch_rel"], check.max_gap(
                torch.as_tensor(got["pitch_hz"]), r["pitch_hz"]))
            out["xhat_rel"] = max(out["xhat_rel"], check.max_gap(got["x_hat"], r["x_hat"]))
    return out
