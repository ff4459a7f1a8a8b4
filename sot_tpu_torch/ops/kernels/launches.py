"""The kernel wrappers' launch counts, read, set and advanced as one.

Each wrapper adds one to a module-level count where it launches its kernel.
A CUDA graph runs its kernels without Python, so a count would freeze during
replays: the graph takes the counts its capture added (``delta``), sets the
counts back (capture launches nothing), and adds that delta times the number
of replays after each series (``add``).
"""

from __future__ import annotations

from typing import Dict

from sot_tpu_torch.ops.kernels import conv, cqt, merge, plane, refgrad, stft, synth

# name -> (module, its count's attribute), in the kernels' order (PERF.md §6)
COUNTERS = {
    "cqt_project": (cqt, "launches"),
    "synth_render": (synth, "launches"),
    "synth_backward": (synth, "backward_launches"),
    "merge_coupling": (merge, "launches"),
    "ref_grad_beta": (refgrad, "launches"),
    "sot_plane_forward": (plane, "launches"),
    "sot_plane_backward": (plane, "backward_launches"),
    "coupling_grads": (merge, "grad_launches"),
    "stft_frontend": (stft, "launches"),
    "conv1d_forward": (conv, "launches"),
    "conv1d_weight": (conv, "dw_launches"),
    "conv1d_f32_forward": (conv, "f32_launches"),
    "conv1d_f32_weight": (conv, "f32_dw_launches"),
}


def read() -> Dict[str, int]:
    return {name: getattr(module, attr) for name, (module, attr) in COUNTERS.items()}


def write(counts: Dict[str, int]) -> None:
    for name, value in counts.items():
        module, attr = COUNTERS[name]
        setattr(module, attr, value)


def reset() -> None:
    write({name: 0 for name in COUNTERS})


def delta(before: Dict[str, int], after: Dict[str, int]) -> Dict[str, int]:
    return {name: after[name] - before[name] for name in COUNTERS}


def add(counts: Dict[str, int], times: int = 1) -> None:
    write({name: value + times * counts[name] for name, value in read().items()})
