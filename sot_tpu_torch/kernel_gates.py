"""The kernel gates as explicit arguments (``sot_tpu``'s env gates, one field each),
and the adoption rule that picks them from on-card A/Bs and training verdicts.

The JAX package turns its alternative kernels on with environment variables
read at trace time (``sot_tpu/kernel_gates.py``, ``ops/pallas/sot.py:
_merge_mode``, ``ops/stft.py``, ``models/encoder.py``). The port reads no
environment variable: a ``KernelGates`` is passed to ``build_modules``,
``Wasserstein1D``, ``features.STFT`` and ``MSSLoss`` (each also takes a
preset name).

Presets:
  * ``"default"`` — every gate off: the SOT loss on the banded plane
    (``plane``), PyTorch's convolutions and FFT
  * ``"auto"`` — ``auto_gates()`` over the A/Bs and verdicts committed in
    ``ADOPTION_DIR`` (``sot_tpu_torch/adoption/``), measured on an H100 by
    ``python -m sot_tpu_torch.gate_ab`` and ``python -m
    sot_tpu_torch.train_verdict``; read once per process, at its first use.
    ``cli train --kernels auto`` and ``build_modules``' default.

``auto_gates`` is ``sot_tpu/kernel_gates.py:auto_gates`` branch for branch:
a candidate must beat its baseline's fwd + grad total by more than 3% and
by at least 0.05 ms; a candidate whose A/B recorded a failed parity check
is dropped; ``full`` needs ``merge_train_verdict.json`` (``full_ok``), else
the merge winner becomes ``ref`` (``_refgrad_upgrade``) or ``hybrid``; the
small-shape mode comes from ``refgrad_ab_512.json``; the MSS recipes are
exclusive and the best total wins; ``conv_bf16`` needs its verdict and a
>3% bench win. A missing or malformed file reads as "not adopted". Where
the JAX package lets an explicit ``SOT_TPU_*`` variable win, ``auto_gates``
takes ``pins``: a pinned field removes every candidate that touches it and
keeps its pinned value.

One deliberate difference: the ``conv`` candidate (kernels B10/B11 in the
dtype its A/B timed, float32 = 3xTF32) also needs a committed
``conv_train_verdict.json`` with ``conv_ok``, as ``_synth_gate`` needs
``synth_train_verdict.json``: its parity to cuDNN is fp-close, not exact,
and such a kernel becomes a default only after a 25k-step training verdict.

Not mirrored: ``SOT_TPU_CQT_PALLAS`` and ``SOT_TPU_SYNTH_PALLAS``
(``_synth_gate``; kernels B1-B3 always run in the port), and
``SOT_TPU_MERGE_ROWS`` and ``SOT_TPU_CONV_ROWS`` (TPU row tiles, which mean
nothing to the CUDA kernels).
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
from typing import Any, Dict, Iterator, Mapping, Optional, Union

import torch

W2_MODES = ("off", "full", "hybrid", "ref")
BOOL_FIELDS = ("conv", "conv_bf16", "stft_frontend", "dft_matmul")
CONV_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class KernelGates:
    w2_merge: str = "off"
    """``SOT_TPU_W2_MERGE``: the same-grid W_2 route. ``off`` (the banded
    plane), ``full`` (merge-coupling value and its min-halving gradient,
    kernels B4 + B8), ``hybrid`` (B4 + the plane backward B7) or ``ref``
    (B4 + the plane-convention rank backward B5)."""
    w2_merge_small: str = ""
    """``SOT_TPU_W2_MERGE_SMALL``: a mode that overrides ``w2_merge`` for
    rows of at most 512 bins (``SOT_TPU_W2_SMALL_N``'s default); ``""`` for
    none."""
    conv: bool = False
    """``SOT_TPU_CONV_PALLAS``: the encoder's k > 1 'same' convolutions on
    the hand-written kernels B10 (forward and dx) and B11 (dW)."""
    conv_dtype: torch.dtype = torch.bfloat16
    """``SOT_TPU_CONV_DTYPE``: the operand type of those kernels (f32
    accumulation); bf16 as in the JAX package, float32 for exact parity."""
    conv_bf16: bool = False
    """``SOT_TPU_CONV_BF16``: the encoder's conv stack in bf16, as Flax's
    ``nn.Conv(dtype=bfloat16)`` computes it: input, weight and bias cast to
    bf16, the conv with a bf16 output, the bias added after it in bf16, and
    the leaky-ReLUs, the residual add and dropout in bf16, back to f32
    after ``conv4b``. With ``conv`` as well, the k > 1 convs stay on kernels
    B10/B11 with f32 outputs and only the 1x1 convs go bf16 (the JAX
    package's precedence). Off in ``default``; ``auto`` takes it only with
    a committed verdict and bench win (``_convbf16_gate``)."""
    stft_frontend: bool = False
    """``SOT_TPU_STFT_PALLAS``: the fused pad_end framing + window + real-DFT
    projection (kernel B9) for STFTs whose hop is a multiple of 128 and
    divides both the signal length and the FFT size."""
    dft_matmul: bool = False
    """``SOT_TPU_DFT_MATMUL``: |rfft| of the framed, windowed signal as one
    f32 matmul (TF32 off) against the real-DFT matrix for n_fft <= 4096, in
    place of the FFT, in the loss transform and the MSS loss (where
    ``stft_frontend`` does not take the STFT). A matrix product outside any
    Pallas kernel in the JAX package, so ``torch.matmul`` here."""

    def __post_init__(self):
        if self.w2_merge not in W2_MODES:
            raise ValueError(f"w2_merge must be one of {W2_MODES}, got {self.w2_merge!r}")
        if self.w2_merge_small not in ("",) + W2_MODES:
            raise ValueError(f"w2_merge_small must be '' or one of {W2_MODES}, "
                             f"got {self.w2_merge_small!r}")
        for name in BOOL_FIELDS:
            if not isinstance(getattr(self, name), bool):
                raise ValueError(f"{name} must be a bool, got {getattr(self, name)!r}")
        if self.conv_dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"conv_dtype must be torch.bfloat16 or torch.float32, "
                             f"got {self.conv_dtype}")


# The committed A/Bs and verdicts that ``auto`` is read from.
ADOPTION_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "adoption")

_AB_GATES = (
    # (A/B file, baseline key, candidate key, the fields the candidate
    # touches, what it sets) -- sot_tpu/kernel_gates.py:_AB_GATES without
    # cqt_ab.json (kernel B1 always runs here)
    ("sot_ab.json", "plane", "merge", ("w2_merge",), {"w2_merge": "full"}),
    ("conv_ab.json", "xla", "pallas", ("conv",), {"conv": True, "conv_dtype": torch.float32}),
    ("mss_ab.json", "fft", "dft_matmul", ("dft_matmul",), {"dft_matmul": True}),
    ("mss_ab.json", "fft", "pallas", ("stft_frontend",), {"stft_frontend": True}),
    ("mss_ab.json", "fft", "pallas+dft", ("stft_frontend", "dft_matmul"),
     {"stft_frontend": True, "dft_matmul": True}),
)

_MSS_FILE = "mss_ab.json"
_CONV_FILE = "conv_ab.json"


def _read(ab_dir: str, name: str) -> Optional[Dict[str, Any]]:
    """A committed JSON object, or None where it is missing or malformed
    (the JAX package's ``except`` branches: "not adopted")."""
    try:
        with open(os.path.join(ab_dir, name)) as fh:
            doc = json.load(fh)
    except (OSError, ValueError):
        return None
    return doc if isinstance(doc, dict) else None


def _total(d: Any) -> float:
    d = d if isinstance(d, dict) else {}
    return d.get("fwd_ms", 1e9) + d.get("grad_ms", 1e9)


def _wins(cand: Any, base: Any) -> bool:
    """The adoption margin: more than 3% and at least 0.05 ms off the total."""
    return _total(cand) < 0.97 * _total(base) and _total(base) - _total(cand) >= 0.05


def _parity_ok(ab: Dict[str, Any]) -> bool:
    return bool(ab.get("complete") and (ab.get("parity") or {}).get("ok"))


def _refgrad_upgrade(ab_dir: str) -> bool:
    """hybrid -> ref (``sot_tpu/kernel_gates.py:_refgrad_upgrade``): the
    refgrad A/B complete, parity-checked, ref beating hybrid by the margin,
    and its training verdict, where one is committed, not negative."""
    ab = _read(ab_dir, "refgrad_ab.json")
    if ab is None or not _parity_ok(ab):
        return False
    verdict = _read(ab_dir, "refgrad_train_verdict.json")
    if verdict is not None and not verdict.get("ref_ok"):
        return False
    return _wins(ab.get("ref", {}), ab.get("hybrid", {}))


def _convbf16_gate(ab_dir: str) -> bool:
    """``conv_bf16``: a committed positive verdict carrying a >3% bench win
    (``sot_tpu/kernel_gates.py:_convbf16_gate``)."""
    v = _read(ab_dir, "convbf16_train_verdict.json")
    if v is None or not v.get("conv_bf16_ok"):
        return False
    bench = v.get("bench_frames_per_sec", {})
    off, on = bench.get("off", 0.0), bench.get("on", 0.0)
    return off > 0 and on > 1.03 * off


def _small_shape_mode(ab_dir: str) -> str:
    """The mode at the SOT-512 families' shape, from ``refgrad_ab_512.json``
    alone (``sot_tpu/kernel_gates.py:_small_shape_mode``); "" where it is
    absent, its parity failed or neither mode wins by the margin."""
    ab = _read(ab_dir, "refgrad_ab_512.json")
    if ab is None or not _parity_ok(ab):
        return ""
    ref, hyb = ab.get("ref", {}), ab.get("hybrid", {})
    if _wins(hyb, ref):
        return "hybrid"
    if _wins(ref, hyb):
        return "ref"
    return ""


def _full_merge_blessed(ab_dir: str) -> bool:
    return bool((_read(ab_dir, "merge_train_verdict.json") or {}).get("full_ok"))


def _conv_blessed(ab_dir: str) -> bool:
    """The port's one addition to the rule: kernels B10/B11 need a committed
    25k-step verdict (``conv_train_verdict.json``, ``conv_ok``)."""
    return bool((_read(ab_dir, "conv_train_verdict.json") or {}).get("conv_ok"))


def auto_gates(ab_dir: str = ADOPTION_DIR,
               pins: Optional[Mapping[str, Any]] = None) -> KernelGates:
    """The gates of the committed A/B winners under ``ab_dir``, with
    ``pins`` (``KernelGates`` field -> value) set as given: a pinned field
    removes every candidate that touches it (the JAX package's explicit
    ``SOT_TPU_*`` setting)."""
    pins = dict(pins or {})
    unknown = sorted(set(pins) - {f.name for f in dataclasses.fields(KernelGates)})
    if unknown:
        raise ValueError(f"unknown kernel gate(s) {unknown}; the fields are "
                         f"{[f.name for f in dataclasses.fields(KernelGates)]}")
    gates: Dict[str, Any] = {}
    best_mss: tuple = (None, 1e9)  # (fields it sets, total) across the MSS candidates
    for fname, base_key, cand_key, touches, sets in _AB_GATES:
        if any(field in pins for field in touches):
            continue  # the pin wins
        ab = _read(ab_dir, fname)
        if ab is None:
            continue
        if "parity" in ab and not (ab["parity"] or {}).get("ok"):
            continue  # a fast-but-wrong candidate is not a candidate
        cand, base = ab.get(cand_key, {}), ab.get(base_key, {})
        if not _wins(cand, base):
            continue
        if fname == _MSS_FILE:
            if _total(cand) < best_mss[1]:
                best_mss = (sets, _total(cand))
            continue
        if fname == _CONV_FILE and not _conv_blessed(ab_dir):
            continue
        gates.update(sets)
        if "w2_merge" in touches:
            if not _full_merge_blessed(ab_dir):
                gates["w2_merge"] = "ref" if _refgrad_upgrade(ab_dir) else "hybrid"
            small = _small_shape_mode(ab_dir)
            if small and small != gates["w2_merge"] and "w2_merge_small" not in pins:
                gates["w2_merge_small"] = small
    if best_mss[0]:
        gates.update(best_mss[0])
    if "conv_bf16" not in pins and _convbf16_gate(ab_dir):
        gates["conv_bf16"] = True
    return KernelGates(**{**gates, **pins})


def parse_pin(text: str) -> tuple:
    """``FIELD=VALUE`` (``cli train --gate``) as ``(field, value)``: the
    fields of ``KernelGates``; ``true``/``false`` (or 1/0) for the flags,
    ``bfloat16``/``float32`` for ``conv_dtype``. Raises ``ValueError`` on an
    unknown field or a bad value."""
    field, sep, value = text.partition("=")
    field, value = field.strip(), value.strip()
    names = [f.name for f in dataclasses.fields(KernelGates)]
    if not sep or field not in names:
        raise ValueError(f"--gate takes FIELD=VALUE with FIELD one of {names}, got {text!r}")
    if field in BOOL_FIELDS:
        flags = {"true": True, "1": True, "false": False, "0": False}
        if value.lower() not in flags:
            raise ValueError(f"--gate {field} takes true or false, got {value!r}")
        return field, flags[value.lower()]
    if field == "conv_dtype":
        if value not in CONV_DTYPES:
            raise ValueError(f"--gate conv_dtype takes {sorted(CONV_DTYPES)}, got {value!r}")
        return field, CONV_DTYPES[value]
    KernelGates(**{field: value})  # the modes' own check
    return field, value


def gates_record(gates: KernelGates) -> Dict[str, Any]:
    """``gates`` as JSON values (``conv_dtype`` by its name)."""
    out = dataclasses.asdict(gates)
    out["conv_dtype"] = str(gates.conv_dtype).removeprefix("torch.")
    return out


@functools.lru_cache(maxsize=None)
def _auto() -> KernelGates:
    return auto_gates()


class _Presets(Mapping):
    """``"default"`` and ``"auto"``; ``auto`` is resolved at its first use."""

    def __getitem__(self, name: str) -> KernelGates:
        if name == "default":
            return KernelGates()
        if name == "auto":
            return _auto()
        raise KeyError(name)

    def __iter__(self) -> Iterator[str]:
        return iter(("default", "auto"))

    def __len__(self) -> int:
        return 2


PRESETS = _Presets()

Kernels = Union[str, KernelGates]


def resolve_gates(kernels: Kernels) -> KernelGates:
    """A ``KernelGates`` as it is, or the preset of that name."""
    if isinstance(kernels, KernelGates):
        return kernels
    if kernels in PRESETS:
        return PRESETS[kernels]
    raise ValueError(f"kernels must be a KernelGates or one of {sorted(PRESETS)}, "
                     f"got {kernels!r}")
