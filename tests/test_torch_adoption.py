"""Kernel adoption: ``sot_tpu_torch.kernel_gates.auto_gates`` against
``sot_tpu.kernel_gates.auto_gates`` on the same directories (JAX's pins as
``SOT_TPU_*`` variables, the port's as ``pins``), the port's one stated
difference (the conv candidate needs ``conv_train_verdict.json``),
``train_verdict`` against ``scripts/refgrad_train_verdict.py`` (imported by
path) and at each check's boundary, ``gate_ab`` at a tiny size on the CPU,
and ``cli train --gate``."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

import pytest
import torch

from sot_tpu import kernel_gates as jax_gates
from sot_tpu_torch import cli
from sot_tpu_torch import gate_ab
from sot_tpu_torch import kernel_gates as kg
from sot_tpu_torch import train_verdict as tv
from sot_tpu_torch.kernel_gates import KernelGates, auto_gates, parse_pin
from sot_tpu_torch.training import trainer as ttrainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROUND2 = os.path.join(REPO, "results", "round2")
R4 = os.path.join(ROUND2, "runs", "r4")
JAX_ENVS = ("SOT_TPU_W2_MERGE", "SOT_TPU_W2_MERGE_SMALL", "SOT_TPU_MERGE_ROWS",
            "SOT_TPU_CONV_PALLAS", "SOT_TPU_CONV_DTYPE", "SOT_TPU_CQT_PALLAS",
            "SOT_TPU_DFT_MATMUL", "SOT_TPU_STFT_PALLAS", "SOT_TPU_SYNTH_PALLAS",
            "SOT_TPU_CONV_BF16", "SOT_TPU_W2_SMALL_N")
TINY = ["--set", "n_samples=1024", "--set", "cqt_fmin=261.6", "--set", "batch_size=8",
        "--set", "transform_n_fft=512", "--set", "transform_hop=128", "--dataset-size", "32",
        "--device", "cpu"]


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "refgrad_train_verdict", os.path.join(REPO, "scripts", "refgrad_train_verdict.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _flag(v: str) -> bool:
    return v.strip().lower() not in ("", "0", "false", "off", "no")


def port_of_jax(adopted: dict, env: dict) -> KernelGates:
    """The ``KernelGates`` that JAX's effective settings (its pins ``env``
    and ``auto_gates``' result ``adopted``) stand for. Kernels B1-B3 always
    run in the port, and the merge row tile means nothing here, so the CQT,
    synth and row gates have no field; the conv candidate is kernels
    B10/B11 in the dtype the port's A/B times (float32)."""
    eff = {**env, **adopted}
    raw = eff.get("SOT_TPU_W2_MERGE", "").strip().lower()
    w2 = raw if raw in ("hybrid", "ref") else ("full" if _flag(raw) else "off")
    small = eff.get("SOT_TPU_W2_MERGE_SMALL", "").strip().lower()
    if "SOT_TPU_CONV_DTYPE" in eff:
        dtype = kg.CONV_DTYPES[eff["SOT_TPU_CONV_DTYPE"]]
    else:
        dtype = torch.float32 if "SOT_TPU_CONV_PALLAS" in adopted else torch.bfloat16
    return KernelGates(
        w2_merge=w2, w2_merge_small=small if small in kg.W2_MODES else "",
        conv=_flag(eff.get("SOT_TPU_CONV_PALLAS", "")), conv_dtype=dtype,
        conv_bf16=_flag(eff.get("SOT_TPU_CONV_BF16", "")),
        stft_frontend=_flag(eff.get("SOT_TPU_STFT_PALLAS", "")),
        dft_matmul=_flag(eff.get("SOT_TPU_DFT_MATMUL", "")))


@pytest.fixture
def no_jax_env(monkeypatch):
    for name in JAX_ENVS:
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


def ab(base: str, base_ms: float, cand: str, cand_ms: float, **extra) -> dict:
    """An A/B file: ``base`` and ``cand`` with those fwd + grad totals."""
    return {"device": "test", base: {"fwd_ms": base_ms / 2, "grad_ms": base_ms / 2},
            cand: {"fwd_ms": cand_ms / 2, "grad_ms": cand_ms / 2}, "complete": True, **extra}


def sot_win(**extra):
    return {"sot_ab.json": ab("plane", 6.0, "merge", 1.0, **extra)}


def refgrad(hyb: float, ref: float, ok=True):
    return ab("hybrid", hyb, "ref", ref, parity={"max_rel": 0.0, "ok": ok})


MSS = {"fft": 1.0, "dft_matmul": 0.6, "pallas": 0.4, "pallas+dft": 0.5}

# case -> (files, JAX's env pins, the port's pins)
CASES = {
    "merge loses": ({"sot_ab.json": ab("plane", 1.0, "merge", 1.2)}, {}, {}),
    "merge wins by 4% but 0.04 ms": ({"sot_ab.json": ab("plane", 1.0, "merge", 0.96)}, {}, {}),
    "merge wins by 0.1 ms but 2%": ({"sot_ab.json": ab("plane", 5.0, "merge", 4.9)}, {}, {}),
    "merge wins, full not blessed": (sot_win(), {}, {}),
    "merge wins, full blessed": (
        {**sot_win(), "merge_train_verdict.json": {"full_ok": True}}, {}, {}),
    "merge wins, full verdict negative": (
        {**sot_win(), "merge_train_verdict.json": {"full_ok": False}}, {}, {}),
    "ref upgrade, positive verdict": (
        {**sot_win(), "refgrad_ab.json": refgrad(4.0, 2.0),
         "refgrad_train_verdict.json": {"ref_ok": True}}, {}, {}),
    "ref upgrade, negative verdict": (
        {**sot_win(), "refgrad_ab.json": refgrad(4.0, 2.0),
         "refgrad_train_verdict.json": {"ref_ok": False}}, {}, {}),
    "ref upgrade, no verdict": ({**sot_win(), "refgrad_ab.json": refgrad(4.0, 2.0)}, {}, {}),
    "ref upgrade, parity failed": (
        {**sot_win(), "refgrad_ab.json": refgrad(4.0, 2.0, ok=False)}, {}, {}),
    "ref within the margin": ({**sot_win(), "refgrad_ab.json": refgrad(2.04, 2.0)}, {}, {}),
    "small-shape mode hybrid": (
        {**sot_win(), "refgrad_ab.json": refgrad(4.0, 2.0),
         "refgrad_ab_512.json": refgrad(0.5, 0.6)}, {}, {}),
    "small-shape mode ref": ({**sot_win(), "refgrad_ab_512.json": refgrad(0.6, 0.5)}, {}, {}),
    "small-shape mode empty": (
        {**sot_win(), "refgrad_ab.json": refgrad(4.0, 2.0),
         "refgrad_ab_512.json": refgrad(0.52, 0.5)}, {}, {}),
    "small-shape parity failed": (
        {**sot_win(), "refgrad_ab_512.json": refgrad(0.6, 0.5, ok=False)}, {}, {}),
    "mss best of three: pallas": ({"mss_ab.json": {
        "complete": True, **{k: {"fwd_ms": v / 2, "grad_ms": v / 2} for k, v in MSS.items()}}},
        {}, {}),
    "mss best of three: pallas+dft": ({"mss_ab.json": {
        "complete": True, **{k: {"fwd_ms": v / 2, "grad_ms": v / 2}
                             for k, v in {**MSS, "pallas+dft": 0.3}.items()}}}, {}, {}),
    "mss below the margin": ({"mss_ab.json": {
        "complete": True, **{k: {"fwd_ms": 0.005, "grad_ms": 0.006 if k == "fft" else 0.003}
                             for k in MSS}}}, {}, {}),
    "conv_bf16 with a bench win": (
        {"convbf16_train_verdict.json": {"conv_bf16_ok": True, "bench_frames_per_sec": {
            "off": 100.0, "on": 104.0}}}, {}, {}),
    "conv_bf16 without a bench win": (
        {"convbf16_train_verdict.json": {"conv_bf16_ok": True, "bench_frames_per_sec": {
            "off": 100.0, "on": 103.0}}}, {}, {}),
    "conv_bf16 verdict negative": (
        {"convbf16_train_verdict.json": {"conv_bf16_ok": False, "bench_frames_per_sec": {
            "off": 100.0, "on": 110.0}}}, {}, {}),
    "candidate failed parity": (sot_win(parity={"max_rel": 1.0, "ok": False}), {}, {}),
    "incomplete refgrad A/B": (
        {**sot_win(), "refgrad_ab.json": {**refgrad(4.0, 2.0), "complete": False}}, {}, {}),
    "malformed A/B file": ({"sot_ab.json": "{not json"}, {}, {}),
    "conv blessed by its verdict": (
        {"conv_ab.json": ab("xla", 4.0, "pallas", 2.0),
         "conv_train_verdict.json": {"conv_ok": True}}, {}, {}),
    "pin removes the merge candidate": (
        {**sot_win(), "refgrad_ab.json": refgrad(4.0, 2.0)},
        {"SOT_TPU_W2_MERGE": "off"}, {"w2_merge": "off"}),
    "pin of the small-shape mode": (
        {**sot_win(), "refgrad_ab.json": refgrad(4.0, 2.0),
         "refgrad_ab_512.json": refgrad(0.5, 0.6)},
        {"SOT_TPU_W2_MERGE_SMALL": "ref"}, {"w2_merge_small": "ref"}),
    "pin removes two mss recipes": ({"mss_ab.json": {
        "complete": True, **{k: {"fwd_ms": v / 2, "grad_ms": v / 2} for k, v in MSS.items()}}},
        {"SOT_TPU_STFT_PALLAS": "0"}, {"stft_frontend": False}),
    "pin of conv_bf16": (
        {"convbf16_train_verdict.json": {"conv_bf16_ok": True, "bench_frames_per_sec": {
            "off": 100.0, "on": 110.0}}}, {"SOT_TPU_CONV_BF16": "0"}, {"conv_bf16": False}),
    "pin of conv with its dtype": (
        {"conv_ab.json": ab("xla", 4.0, "pallas", 2.0),
         "conv_train_verdict.json": {"conv_ok": True}},
        {"SOT_TPU_CONV_PALLAS": "1", "SOT_TPU_CONV_DTYPE": "bfloat16"},
        {"conv": True, "conv_dtype": torch.bfloat16}),
}


def _write_dir(path, files: dict) -> str:
    os.makedirs(path, exist_ok=True)
    for name, doc in files.items():
        with open(os.path.join(path, name), "w") as fh:
            fh.write(doc if isinstance(doc, str) else json.dumps(doc))
    return str(path)


def _both(ab_dir: str, env: dict, pins: dict, monkeypatch):
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    adopted = jax_gates.auto_gates(ab_dir)
    return port_of_jax(adopted, env), auto_gates(ab_dir, pins=pins), adopted


@pytest.mark.parametrize("case", sorted(CASES))
def test_auto_gates_is_jax_rule(case, tmp_path, no_jax_env):
    files, env, pins = CASES[case]
    want, got, _ = _both(_write_dir(tmp_path, files), env, pins, no_jax_env)
    assert got == want


def test_auto_gates_on_jax_committed_ab(no_jax_env):
    """On JAX's own files (TPU v5e): ``ref`` + small ``hybrid`` + the bf16
    conv stack, its CQT and synth gates having no field here."""
    want, got, adopted = _both(ROUND2, {}, {}, no_jax_env)
    assert got == want == KernelGates(w2_merge="ref", w2_merge_small="hybrid", conv_bf16=True)
    assert adopted["SOT_TPU_CQT_PALLAS"] == adopted["SOT_TPU_SYNTH_PALLAS"] == "1"


@pytest.mark.parametrize("verdict", [None, {"conv_ok": False}, "{broken"])
def test_conv_candidate_needs_its_verdict(verdict, tmp_path, no_jax_env):
    """The port's one difference: a conv bench win alone, adopted by JAX's
    rule, is not adopted without a positive ``conv_train_verdict.json``."""
    files = {"conv_ab.json": ab("xla", 4.0, "pallas", 2.0)}
    if verdict is not None:
        files["conv_train_verdict.json"] = verdict
    _, got, adopted = _both(_write_dir(tmp_path, files), {}, {}, no_jax_env)
    assert adopted == {"SOT_TPU_CONV_PALLAS": "1"}
    assert got == KernelGates()


def test_auto_preset_reads_adoption_dir(no_jax_env):
    assert kg.PRESETS["auto"] == auto_gates(kg.ADOPTION_DIR) == kg.resolve_gates("auto")
    assert kg.PRESETS["default"] == KernelGates() and sorted(kg.PRESETS) == ["auto", "default"]


def test_auto_gates_rejects_unknown_pin():
    with pytest.raises(ValueError, match="unknown kernel gate"):
        auto_gates(pins={"merge_rows": 128})


@pytest.mark.parametrize("text, want", [
    ("w2_merge=ref", ("w2_merge", "ref")), ("w2_merge_small=", ("w2_merge_small", "")),
    ("conv=true", ("conv", True)), ("stft_frontend=0", ("stft_frontend", False)),
    ("dft_matmul=1", ("dft_matmul", True)), ("conv_bf16=False", ("conv_bf16", False)),
    ("conv_dtype=float32", ("conv_dtype", torch.float32)),
    ("conv_dtype=bfloat16", ("conv_dtype", torch.bfloat16))])
def test_parse_pin(text, want):
    assert parse_pin(text) == want


@pytest.mark.parametrize("text", ["merge_rows=128", "conv=maybe", "conv_dtype=float16",
                                  "w2_merge=on", "conv", "w2_merge_small=plane"])
def test_parse_pin_raises(text):
    with pytest.raises(ValueError):
        parse_pin(text)


def test_cli_gate_raises_before_training(tmp_path):
    with pytest.raises(ValueError):
        cli.main(["train", "--experiment", "SOT-512", "--steps", "1", "--out",
                  str(tmp_path / "run"), "--gate", "conv=maybe"] + TINY)
    assert not os.path.exists(tmp_path / "run")


@pytest.fixture(scope="module")
def pinned_run(tmp_path_factory):
    """A tiny ``cli train --kernels default --gate ...`` with ``--final-eval``,
    recording every gate ``build_modules`` was given."""
    seen = []
    real = ttrainer.build_modules

    def spy(cfg, *a, **kw):
        mod = real(cfg, *a, **kw)
        seen.append(mod.kernels)
        return mod

    out = str(tmp_path_factory.mktemp("pinned") / "port-run")
    mp = pytest.MonkeyPatch()
    mp.setattr(ttrainer, "build_modules", spy)
    try:
        assert cli.main(["train", "--experiment", "SOT-2048-Anneal", "--steps", "2",
                         "--eval-every", "2", "--final-eval", "--out", out, "--kernels",
                         "default", "--gate", "w2_merge=hybrid", "--gate", "conv=true",
                         "--gate", "conv_dtype=float32"] + TINY) == 0
    finally:
        mp.undo()
    return out, seen


def test_cli_gate_reaches_train_and_final_eval(pinned_run):
    out, seen = pinned_run
    want = KernelGates(w2_merge="hybrid", conv=True, conv_dtype=torch.float32)
    assert len(seen) == 4 and all(g == want for g in seen)  # train() + three test forms
    with open(os.path.join(out, "kernel_gates.json")) as fh:
        rec = json.load(fh)
    assert rec["gates"] == kg.gates_record(want) and rec["kernels"] == "default"
    assert rec["pins"] == ["w2_merge=hybrid", "conv=true", "conv_dtype=float32"]
    assert rec["command"].startswith("python -m sot_tpu_torch.cli train ")
    assert rec["device"] == "cpu"


def test_run_record_names_the_kernels_by_launches(pinned_run):
    """After training the record holds each hand-written kernel's launches
    over the run (none on the CPU, whose plain versions launch nothing)."""
    out, _ = pinned_run
    with open(os.path.join(out, "kernel_gates.json")) as fh:
        rec = json.load(fh)
    assert rec["train_launches"] == {}
    assert set(rec) == {"kernels", "pins", "gates", "command", "device", "train_launches"}


def test_cli_auto_with_pins_is_auto_gates():
    gates, pins = cli._train_gates("auto", ["conv=true", "w2_merge=off"])
    assert pins == {"conv": True, "w2_merge": "off"}
    assert gates == auto_gates(pins=pins)
    assert cli._train_gates("default", ["stft_frontend=1"])[0] == KernelGates(stft_frontend=True)
    assert cli._train_gates("auto", None)[0] == kg.PRESETS["auto"]


def test_verdict_readers_are_jax_on_committed_runs(monkeypatch):
    jax_script = _jax_script()
    monkeypatch.chdir(REPO)
    subs = sorted(os.listdir(R4))
    assert len(subs) >= 10
    for sub in subs:
        assert tv.read_metrics(R4, sub) == jax_script.read_metrics(R4, sub), sub
        assert tv.loss_trajectory(R4, sub) == jax_script.loss_trajectory(R4, sub), sub


def _fake_run(path, rpa_comb, lsd_by_step, rpa=None, gates=None):
    os.makedirs(path, exist_ok=True)
    for suffix, acc in (("", rpa if rpa is not None else rpa_comb), ("_comb", rpa_comb)):
        with open(os.path.join(path, f"test_metrics{suffix}.json"), "w") as fh:
            json.dump({"test_metrics": {"raw_pitch_accuracy": acc / 100,
                                        "raw_chroma_accuracy": acc / 100,
                                        "log_spectral_distance": 30.123456}}, fh)
    with open(os.path.join(path, "log.jsonl"), "w") as fh:
        fh.write("not json\n")
        for step, lsd in lsd_by_step:
            fh.write(json.dumps({"split": "train", "step": step, "loss/total": 0.1}) + "\n")
            fh.write(json.dumps({"split": "val", "step": step,
                                 "log_spectral_distance": lsd}) + "\n")
        fh.write(json.dumps({"split": "probe", "step": 7, "log_spectral_distance": 1.0}) + "\n")
    for name, doc in (("train_config.json", {"name": "SOT-2048-Anneal", "seed": 42}),
                      ("kernel_gates.json", {"gates": kg.gates_record(gates or KernelGates()),
                                             "command": "python -m sot_tpu_torch.cli train",
                                             "device": "cpu"})):
        with open(os.path.join(path, name), "w") as fh:
            json.dump(doc, fh)
    return str(path)


TRAJ = [(220, 150.0), (990, 120.5), (1100, 101.0), (3000, 88.4), (9900, 44.3),
        (10120, 41.0), (24860, 29.9), (25000, 28.777)]


def test_verdict_readers_are_jax_on_logs(tmp_path, monkeypatch):
    jax_script = _jax_script()
    monkeypatch.chdir(REPO)
    _fake_run(tmp_path / "port-a", 98.765, TRAJ, rpa=44.444)
    _fake_run(tmp_path / "port-short", 12.0, TRAJ[:3])
    os.makedirs(tmp_path / "empty")
    for sub in ("port-a", "port-short", "empty", "missing"):
        assert tv.read_metrics(str(tmp_path), sub) == jax_script.read_metrics(str(tmp_path), sub)
        assert (tv.loss_trajectory(str(tmp_path), sub)
                == jax_script.loss_trajectory(str(tmp_path), sub))
    assert tv.loss_trajectory(str(tmp_path), "port-a") == {
        "1000": 120.5, "3000": 88.4, "10000": 44.3, "25000": 28.78}



@pytest.mark.parametrize("check, run, twin, traj, passes", [
    ("reaches_recipe", 95.0, 95.0, {}, True),
    ("reaches_recipe", 94.99, 94.99, {}, False),
    ("twins_agree", 96.0, 99.0, {}, True),
    ("twins_agree", 96.0, 99.01, {}, False),
    ("no_sustained_collapse", 99.0, 99.0, {"10000": 69.99, "25000": 49.99}, True),
    ("no_sustained_collapse", 99.0, 99.0, {"10000": 70.0, "25000": 30.0}, False),
    ("no_sustained_collapse", 99.0, 99.0, {"10000": 40.0, "25000": 50.0}, False),
    ("no_sustained_collapse", 99.0, 99.0, {"1000": 140.0}, True),
])
def test_verdict_check_boundaries(check, run, twin, traj, passes):
    got = tv.checks({"comb": {"RPA": run}}, {"comb": {"RPA": twin}}, traj)
    assert got[check] is passes
    assert all(v for k, v in got.items() if k != check)


def test_port_verdict_against_jax_twin(tmp_path):
    run = _fake_run(tmp_path / "runs" / "port-anneal-42", 98.0, TRAJ)
    out = str(tmp_path / "adoption")
    assert tv.main(["port", "--run", run, "--out", out, "--device", "cpu"]) == 0
    with open(os.path.join(out, "port_train_verdict.json")) as fh:
        doc = json.load(fh)
    assert doc["port_ok"] and doc["twin"]["test"]["comb"]["RPA"] == 98.86
    assert doc["twin"]["dir"] == tv.JAX_TWIN
    assert doc["twin"]["val_lsd_trajectory"]["25000"] == 31.8
    assert doc["run"]["val_lsd_trajectory"]["10000"] == 44.3 and doc["device"] == "cpu"
    assert doc["commands"]["verdict"].startswith("python -m sot_tpu_torch.train_verdict port")
    kept = os.path.join(out, doc["run"]["kept"])
    with open(os.path.join(kept, "log.jsonl")) as fh:
        assert all(json.loads(line)["split"] == "val" for line in fh)
    assert tv.loss_trajectory(*os.path.split(kept)) == doc["run"]["val_lsd_trajectory"]


@pytest.mark.parametrize("twin_gates, twin_rpa, ok", [
    (KernelGates(), 98.5, True), (KernelGates(), 94.0, False),
    (KernelGates(stft_frontend=True), 98.5, False)])
def test_conv_verdict(tmp_path, twin_gates, twin_rpa, ok):
    conv = KernelGates(conv=True, conv_dtype=torch.float32)
    run = _fake_run(tmp_path / "conv", 98.0, TRAJ, gates=conv)
    twin = _fake_run(tmp_path / "twin", twin_rpa, TRAJ, gates=twin_gates)
    out = str(tmp_path / "adoption")
    assert tv.main(["conv", "--run", run, "--twin", twin, "--out", out,
                    "--device", "cpu"]) == (0 if ok else 2)
    with open(os.path.join(out, "conv_train_verdict.json")) as fh:
        doc = json.load(fh)
    assert doc["conv_ok"] is ok
    assert kg._conv_blessed(out) is ok


def test_verdict_refuses_cpu_into_adoption_dir(tmp_path):
    run = _fake_run(tmp_path / "run", 98.0, TRAJ)
    with pytest.raises(SystemExit):
        tv.main(["port", "--run", run, "--device", "cpu"])


def test_verdict_on_a_cli_run(pinned_run, tmp_path):
    """A port log read end to end: the tiny pinned run fails the recipe."""
    out, _ = pinned_run
    assert tv.main(["port", "--run", out, "--out", str(tmp_path), "--device", "cpu"]) == 2
    with open(tmp_path / "port_train_verdict.json") as fh:
        doc = json.load(fh)
    assert doc["run"]["gates"]["conv"] is True and set(doc["run"]["val_lsd_trajectory"]) == {
        "1000", "3000", "10000", "25000"}


def test_gate_ab_tiny_cpu(tmp_path, no_jax_env):
    """Every A/B file at 16 rows, one input, one pass: JAX's schema, read by
    both packages' rules alike."""
    out = str(tmp_path / "ab")
    assert gate_ab.main(["--device", "cpu", "--out", out, "--iters", "1", "--clips", "1",
                         "--k", "1"]) == 0
    for name, kind, _, _ in gate_ab.AB_FILES:
        with open(os.path.join(out, name)) as fh:
            doc = json.load(fh)
        with open(os.path.join(ROUND2, name)) as fh:
            jax_doc = json.load(fh)
        assert doc["complete"] is True and doc["device"] == "cpu" and doc["k"] == 1
        keys = set(jax_doc) - {"sortmerge"}
        if kind == "conv":
            keys |= {"pallas_bf16", "channels", "kernel_size"}
        assert set(doc) == keys, name
        for variant, d in doc.items():
            if isinstance(d, dict) and variant != "parity":
                assert set(d) == {"fwd_ms", "grad_ms"} and min(d.values()) > 0
    assert json.load(open(os.path.join(out, "refgrad_ab.json")))["parity"]["ok"] is True
    want, got, _ = _both(out, {}, {}, no_jax_env)
    assert got == dataclasses.replace(want, conv=False, conv_dtype=torch.bfloat16)


def test_gate_ab_refuses_cpu_into_adoption_dir():
    with pytest.raises(SystemExit):
        gate_ab.run(kg.ADOPTION_DIR, torch.device("cpu"))
