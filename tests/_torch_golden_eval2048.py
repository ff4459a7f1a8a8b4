"""Generate the port's SOT-2048 evaluation golden from the JAX package (not
a test module).

Restores the committed SOT-2048 seed-42 checkpoint
(``results/checkpoints/best/SOT-2048-42``) on the CPU with the gates of
``tests/_torch_golden_train.py`` and takes the 64 clips and ``f0`` of
``sot_tpu_torch/golden/sot2048_seed42_predict.npz``. Writes

    sot_tpu_torch/golden/sot2048_seed42_eval.npz

with
  * ``eval/<form>/<metric>``: ``evaluate`` on the 64 clips (one batch) in
    each form, ``plain``, ``octcorr`` (``eval_octave_correction``) and
    ``comb`` (``eval_comb_correction``), built as ``sot_tpu/cli.py``'s
    ``--final-eval`` builds them
  * ``pitch_hz`` [64, 16, 1]: the model's pitch (``forward``, eval mode)
  * for each shift of ``SHIFTS`` (the pitch times 1, 0.5, 2, 2/3 and 1.5,
    so that every branch of both corrections fires), under
    ``<correction>/<shift>/``: the clip ``factor`` [64] that the JAX
    package's ``octave_correct_pitch`` / ``comb_correct_pitch`` applies,
    and the quantities its decisions compare (``decisions``): the median
    pitch ``f0``, the spectrum's ``global_peak``; for the octave rule the
    band peaks ``up`` [3, 64] and ``down`` [3, 64], for the comb the
    normalised band peaks ``s`` [64, 11, 8] and the scores ``score`` [64,
    11]
  * ``predict_comb/pitch_hz``: ``predict`` with
    ``inference_comb_correction``
  * ``gates``: the gates used

    JAX_PLATFORMS=cpu python -m tests._torch_golden_eval2048
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np

from tests._torch_golden import GOLDEN as PREDICT_GOLDEN
from tests._torch_golden import restore_params
from tests._torch_golden_train import GATES, _set_gates

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "sot_tpu_torch", "golden", "sot2048_seed42_eval.npz")
EXPERIMENT = "SOT-2048"
FORMS = {"plain": {}, "octcorr": {"eval_octave_correction": True},
         "comb": {"eval_comb_correction": True}}
SHIFTS = {"1": 1.0, "0.5": 0.5, "2": 2.0, "2/3": 2.0 / 3.0, "1.5": 1.5}


def correction_kwargs(cfg) -> Dict[str, float]:
    """The arguments ``apply_octave_correction`` / ``apply_comb_correction``
    (``sot_tpu/training/trainer.py``) pass from the config."""
    return {"sample_rate": cfg.sample_rate, "rel_threshold": cfg.octave_correction_rel_threshold,
            "down_threshold": cfg.octave_correction_down_threshold,
            "min_frequency_hz": 0.95 * cfg.freq_gen_min}


def decisions(kind: str, x, pitch_hz, sample_rate=16000, n_fft=2048, rel_threshold=0.1,
              down_threshold=0.25, min_frequency_hz=38.0, margin=0.1, max_shifts=3,
              n_harmonics=8) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
    """(factor [b], quantities) of the JAX package's ``octave_correct_pitch``
    (kind "octave") or ``comb_correct_pitch`` ("comb"), its steps written
    out in jnp as ``sot_tpu/metrics.py`` takes them, so that the quantities
    its decisions compare can be read."""
    import jax.numpy as jnp

    from sot_tpu.metrics import _COMB_RATIOS
    from sot_tpu.ops.stft import stft_magnitude

    x, pitch_hz = jnp.asarray(x), jnp.asarray(pitch_hz)
    spec = stft_magnitude(x, size=n_fft, overlap=0.75).mean(axis=1)
    df = sample_rate / n_fft
    b, n_bins = spec.shape
    f0 = jnp.median(pitch_hz[:, :, 0], axis=1)
    nyquist = sample_rate / 2.0
    global_peak = spec.max(axis=-1)
    max_halfwidth = max(1, int(0.02 * (n_bins - 1)))
    offsets = jnp.arange(-max_halfwidth, max_halfwidth + 1)

    def band_peak(freq):
        flat = freq.reshape(b, -1)
        idx = jnp.round(flat / df).astype(jnp.int32)
        vals = jnp.take_along_axis(
            spec[:, None, :].repeat(flat.shape[1], axis=1),
            jnp.clip(idx[..., None] + offsets[None, None, :], 0, n_bins - 1), axis=-1)
        halfwidth = jnp.maximum(1, (0.02 * idx).astype(jnp.int32))
        mask = jnp.abs(offsets)[None, None, :] <= halfwidth[..., None]
        return jnp.where(mask, vals, 0.0).max(-1).reshape(freq.shape)

    out = {"f0": f0, "global_peak": global_peak}
    if kind == "octave":
        factor = jnp.ones_like(f0)
        up, down = [], []
        for _ in range(max_shifts):
            cur = f0 * factor
            up.append(band_peak(cur))
            shift = (up[-1] < rel_threshold * global_peak) & (2.0 * cur < nyquist)
            factor = jnp.where(shift, factor * 2.0, factor)
        for _ in range(max_shifts):
            cur = f0 * factor
            down.append(band_peak(0.5 * cur))
            shift = (down[-1] > down_threshold * global_peak) & (0.5 * cur >= min_frequency_hz)
            factor = jnp.where(shift, factor * 0.5, factor)
        out.update(up=jnp.stack(up), down=jnp.stack(down))
    else:
        r = jnp.asarray(_COMB_RATIOS, jnp.float32)
        ks = jnp.arange(1, n_harmonics + 1, dtype=jnp.float32)
        fc = f0[:, None] * r[None, :]
        comb = fc[..., None] * ks[None, None, :]
        s = band_peak(comb.reshape(b, -1)).reshape(comb.shape)
        s = s / (global_peak[:, None, None] + 1e-20)
        score = jnp.sum(jnp.where(comb < nyquist, jnp.minimum(s, 1.0), 0.0), axis=-1)
        thr = jnp.where(r < 1.0, down_threshold, rel_threshold)[None, :]
        admissible = (s[..., 0] >= thr) & (fc >= min_frequency_hz) & (fc < nyquist)
        i1 = list(_COMB_RATIOS).index(1.0)
        elig_invalid = admissible & (r != 1.0)[None, :]
        elig_valid = (admissible & (r < 1.0)[None, :]
                      & (score > score[:, i1][:, None] * (1.0 + margin)))
        eligible = jnp.where(admissible[:, i1][:, None], elig_valid, elig_invalid)
        best = jnp.argmax(jnp.where(eligible, score, -jnp.inf), axis=-1)
        factor = jnp.where(jnp.any(eligible, axis=-1), r[best], 1.0)
        out.update(s=s, score=score)
    return np.asarray(factor), {k: np.asarray(v) for k, v in out.items()}


def applied_factor(kind: str, x, pitch_hz, **kwargs) -> np.ndarray:
    """The factor [b] that the JAX package's own correction applies: its
    output over its input, snapped to the nearest factor it can take (a
    power of two, or a comb ratio)."""
    import jax.numpy as jnp

    from sot_tpu.metrics import _COMB_RATIOS, comb_correct_pitch, octave_correct_pitch

    fn = octave_correct_pitch if kind == "octave" else comb_correct_pitch
    got = np.asarray(fn(jnp.asarray(x), jnp.asarray(pitch_hz), **kwargs))[:, 0, 0]
    ratio = got / np.asarray(pitch_hz)[:, 0, 0]
    if kind == "octave":
        return np.exp2(np.round(np.log2(ratio))).astype(np.float32)
    cands = np.asarray(_COMB_RATIOS, np.float32)
    return cands[np.argmin(np.abs(ratio[:, None] - cands[None, :]), axis=1)]


def shifted(pitch_hz: np.ndarray, shift: float) -> np.ndarray:
    return (pitch_hz * np.float32(shift)).astype(np.float32)


def generate() -> str:
    _set_gates()
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    import jax.numpy as jnp

    from sot_tpu.configs import get_experiment
    from sot_tpu.data import SplitArrays
    from sot_tpu.training.trainer import build_modules, evaluate, forward, make_eval_step, predict

    params, step = restore_params()
    jparams = jax.tree.map(jnp.asarray, params)
    with np.load(PREDICT_GOLDEN) as z:
        x, f0 = z["x"], z["f0"]
    cfg = get_experiment(EXPERIMENT)
    payload = {"step": np.asarray(step, np.int64),
               "gates": np.array(" ".join(f"{k}={v}" for k, v in sorted(GATES.items())))}
    split = SplitArrays(x, f0, np.zeros((len(x), 1), np.float32))
    for form, over in FORMS.items():
        mod = build_modules(cfg.replace(**over))
        metrics = evaluate(mod, make_eval_step(mod), jparams, split, len(x))
        payload.update({f"eval/{form}/{k}": np.float32(v) for k, v in metrics.items()})
        print(form, ", ".join(f"{k} {v:.6f}" for k, v in metrics.items()))
    mod = build_modules(cfg)
    pitch_hz = np.asarray(forward(mod, jparams, jnp.asarray(x), train=False)["pitch_hz"])
    payload["pitch_hz"] = pitch_hz
    kwargs = correction_kwargs(cfg)
    for tag, shift in SHIFTS.items():
        p = shifted(pitch_hz, shift)
        for kind in ("octave", "comb"):
            own = applied_factor(kind, x, p, **kwargs,
                                 **({"margin": cfg.comb_correction_margin} if kind == "comb"
                                    else {}))
            factor, quantities = decisions(kind, x, p, **kwargs,
                                           **({"margin": cfg.comb_correction_margin}
                                              if kind == "comb" else {}))
            assert np.array_equal(factor, own), f"{kind} x{tag}: the transcription disagrees"
            payload[f"{kind}/{tag}/factor"] = factor
            payload.update({f"{kind}/{tag}/{k}": v for k, v in quantities.items()})
            print(f"{kind} x{tag}: factors {dict(zip(*np.unique(factor, return_counts=True)))}")
    mod = build_modules(cfg.replace(inference_comb_correction=True))
    payload["predict_comb/pitch_hz"] = np.asarray(predict(mod, jparams, jnp.asarray(x))["pitch_hz"])
    np.savez(GOLDEN, **payload)
    return GOLDEN


if __name__ == "__main__":
    print("wrote", generate())
