"""PESTO-SOT's comparison: the program's outputs against its plain
reference (``reference/pesto_sot.py``) on the same weights, clips and
dropout draws, after the window, with nothing of the program left on the
device. PERF.md section 2 gives each limit and the readings it was set
from.

Training (the first ``check_steps`` updates of the timed step):

* ``mss_step1_rel``, ``wasserstein_step1_rel``: the first update's loss
  terms against the reference's (the forward of every layer; the W2 value);
* ``amp_grad_rel``: the first gradient of the amplitude head (read back
  from Adam's first moment, with the coupled decay), its worst leaf's
  ``|got - ref| / |ref|``: the losses' backward through the synth's
  amplitude path, the SOT layer's backward among them;
* ``tf32_share``: the program's gap over the gap of the reference in TF32
  (the control) on the same inputs, the smallest over the first MSS term,
  the first W2 term and the amplitude head's first gradient: the control
  reads 1, and a program in float32 comes far nearer on one of the three at
  least (each alone reaches the control's gap now and then, by a
  cancellation in the control's or a tie of the W2 gradient in the
  program's);
* ``head_change_gap``: the amplitude head's change over the updates, leaf
  by leaf as the gap between the two norms over the larger of the
  reference leaf's norm and the median leaf's.

Read and printed beside them, not compared: the later steps' losses and the
worst leaves of the whole first gradient and of the whole change. Every leaf
upstream of the pitch reaches the loss through the synth's phase (~1e4 rad
at a clip's end), and the W2 gradient switches at its ties: the reference
itself, its weights moved by one ulp, reads gaps from 1e-3 to above 1 there
(PERF.md section 2), and Adam's normalised steps carry them into the
changes.

Serving (a sample of the served requests): ``pitch_rel`` and
``weights_rel`` against the reference's forward pass on the same clips,
and ``xhat_rel``, the served x_hat against the reference synth rendered
from the served pitch and amplitudes. x_hat is judged given the controls
the program served, as a served token is judged given its prompt: a
harmonic at Nyquist is switched by the mask's ``>=``, and a relative pitch
gap d moves the last sample's phase by d times ~1e4 rad, so the reference's
own x_hat differs from a correct program's by up to a whole harmonic
(``xhat_free_rel``, printed and not compared).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from portbench.check import Readings, leaf_gaps, max_gap, rel_gap, whole_gap
from portbench.reference import pesto_sot as ref_model

# a served request's outputs: those copied to the host (the request ends
# when they are there) and those the serve check reads on the device
OUTPUTS = {"host": ("pitch_hz", "pitch_unit", "weights"), "device": ("x_hat",)}


def first_update(cfg: dict, device: torch.device, weights, batches: Sequence[torch.Tensor],
                 dropout_seed: int, model: Optional["ref_model.Model"] = None,
                 lower: bool = False, draws_on: Optional[torch.device] = None) -> dict:
    """The reference's first update on ``batches[0]`` (``model``, or the
    reference in the configuration's precision or, ``lower``, the
    control's): its loss terms and its gradient as Adam takes it (with the
    coupled decay); the dropout drawn on ``draws_on`` (default ``device``)."""
    dev = torch.device(device)
    model = model or ref_model.Model(cfg, dev, ref_model.Precision(lower))
    gen = torch.Generator(device=draws_on or dev).manual_seed(dropout_seed)
    with model.precision.active(dev):
        loss, grads = ref_model.first_gradient(model, weights, batches[0], gen)
    wd = cfg["weight_decay"]
    return {"loss": loss, "grad": {k: g + wd * weights[k] for k, g in grads.items()}}


def train_reference(cfg: dict, device: torch.device, weights0, batches, dropout_seed: int,
                    lower: bool = False, model: Optional["ref_model.Model"] = None) -> dict:
    """The reference's updates on the same batches and dropout draws, in the
    configuration's precision or (``lower``) the control's, or ``model``."""
    dev = torch.device(device)
    model = model or ref_model.Model(cfg, dev, ref_model.Precision(lower))
    with model.precision.active(dev):
        return ref_model.train_steps(model, weights0, batches,
                                     torch.Generator(device=dev).manual_seed(dropout_seed),
                                     cfg["learning_rate"], cfg["weight_decay"])


def train_compare(ref: dict, tf32: dict, weights0, losses: List[Dict[str, float]],
                  first_grad, params_after) -> Readings:
    """The numbers compared (see the module's doc) and, for the record, the
    ones they stand in for (PERF.md section 2 says why): every step's loss,
    the worst leaves of the whole gradient and of the whole change, the
    whole gradient's relative gap. ``tf32`` is the control's first update
    (``first_update(..., lower=True)``) on the same inputs."""
    rg = ref["first_grad"]
    norms = {k: float(torch.linalg.vector_norm(v.double())) for k, v in rg.items()}
    med = float(np.median(list(norms.values())))
    moving = [k for k, n in norms.items() if n >= 1e-3 * med]
    d_ref = {k: ref["params"][k] - weights0[k] for k in rg}
    d_got = {k: params_after[k] - weights0[k] for k in rg}
    loss = [abs(a["total"] - b["total"]) / abs(b["total"]) for a, b in zip(losses, ref["losses"])]
    head = [k for k in ref_model.AMPLITUDE_HEAD if k in moving]
    first, first_ref = losses[0], ref["losses"][0]
    out = {f"{k}_step1_rel": abs(first[k] - first_ref[k]) / abs(first_ref[k])
           for k in first_ref if k != "total"}
    amp = max(rel_gap(first_grad[k], rg[k]) for k in head)
    shares = [amp / max(max(rel_gap(tf32["grad"][k], rg[k]) for k in head), 1e-30)]
    for k in first_ref:
        if k != "total":
            gap = abs(tf32["loss"][k] - first_ref[k]) / abs(first_ref[k])
            shares.append(out[f"{k}_step1_rel"] / max(gap, 1e-30))
    out.update({"amp_grad_rel": amp, "tf32_share": min(shares),
                "head_change_gap": max(leaf_gaps(d_got, d_ref, head)),
                "loss_step1_rel": loss[0], "loss_rel": max(loss),
                "grad_gap": max(leaf_gaps(first_grad, rg, moving)),
                "change_gap": max(leaf_gaps(d_got, d_ref, moving)),
                "grad_rel": whole_gap(first_grad, rg)})
    return out


def train_readings(cfg: dict, device: torch.device, weights0, batches, dropout_seed: int,
                   losses: List[Dict[str, float]], first_grad, params_after) -> Readings:
    ref = train_reference(cfg, device, weights0, batches, dropout_seed)
    tf32 = first_update(cfg, device, weights0, batches, dropout_seed, lower=True)
    return train_compare(ref, tf32, weights0, losses, first_grad, params_after)


def serve_compare(model: "ref_model.Model", weights0, clips: Sequence[np.ndarray],
                  served: Sequence[Dict[str, object]]) -> Readings:
    """Max over the sampled requests of: pitch_hz's largest relative gap,
    the amplitudes' and x_hat's largest gap over their largest value."""
    dev = model.device
    out = {"pitch_rel": 0.0, "weights_rel": 0.0, "xhat_rel": 0.0, "xhat_free_rel": 0.0}
    with torch.no_grad(), model.precision.active(dev):
        for x, got in zip(clips, served):
            ref = model.forward(weights0, torch.from_numpy(x).to(dev))
            hz = ref["pitch_hz"].cpu().numpy().astype(np.float64)
            out["pitch_rel"] = max(out["pitch_rel"], float(
                np.max(np.abs(np.asarray(got["pitch_hz"], np.float64) - hz) / np.abs(hz))))
            w = ref["weights"].cpu().numpy().astype(np.float64)
            out["weights_rel"] = max(out["weights_rel"], float(
                np.max(np.abs(np.asarray(got["weights"], np.float64) - w)) / np.max(np.abs(w))))
            x_hat = torch.as_tensor(got["x_hat"], device=dev)
            rendered = model.render(torch.as_tensor(got["weights"], device=dev),
                                    torch.as_tensor(got["pitch_hz"], device=dev))
            out["xhat_rel"] = max(out["xhat_rel"], max_gap(x_hat, rendered))
            out["xhat_free_rel"] = max(out["xhat_free_rel"], max_gap(x_hat, ref["x_hat"]))
    return out


def serve_readings(cfg: dict, device: torch.device, weights0, clips, served) -> Readings:
    return serve_compare(ref_model.Model(cfg, device), weights0, clips, served)
