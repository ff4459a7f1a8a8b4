"""The port imports neither JAX nor the JAX package, and keeps the same
experiment registry."""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import json, pkgutil, importlib, sys
import sot_tpu_torch
for info in pkgutil.walk_packages(sot_tpu_torch.__path__, "sot_tpu_torch."):
    importlib.import_module(info.name)
import chip_smoke
banned = ("jax", "flax", "optax", "orbax")
bad = sorted(m for m in sys.modules
             if m.split(".")[0].startswith(banned)
             or m == "sot_tpu" or m.startswith("sot_tpu."))
loaded = sorted(m for m in sys.modules if m.startswith("sot_tpu_torch"))
print(json.dumps({"bad": bad, "loaded": loaded}))
"""


def test_port_and_chip_smoke_load_no_jax_and_no_sot_tpu():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    # the walk really imported the package's modules
    for mod in ("sot_tpu_torch.training.trainer", "sot_tpu_torch.ops.kernels.cqt",
                "sot_tpu_torch.ops.kernels.synth", "sot_tpu_torch.cli",
                "sot_tpu_torch.ops.kernels.plane", "sot_tpu_torch.metrics",
                "sot_tpu_torch.models.import_torch", "sot_tpu_torch.eval_paper",
                "sot_tpu_torch.training.observability", "sot_tpu_torch.parallel.train",
                "sot_tpu_torch.parallel.sharded_ops", "sot_tpu_torch.parallel.dryrun"):
        assert mod in res["loaded"]


def test_experiment_registry_matches_jax_package():
    from sot_tpu import configs as jcfg
    from sot_tpu_torch import configs as tcfg

    assert list(tcfg.EXPERIMENTS) == list(jcfg.EXPERIMENTS)
    for name, cfg in jcfg.EXPERIMENTS.items():
        assert dataclasses.asdict(tcfg.EXPERIMENTS[name]) == dataclasses.asdict(cfg), name
    assert ([f.name for f in dataclasses.fields(tcfg.ExperimentConfig)]
            == [f.name for f in dataclasses.fields(jcfg.ExperimentConfig)])
    assert ([f.name for f in dataclasses.fields(tcfg.LossConfig)]
            == [f.name for f in dataclasses.fields(jcfg.LossConfig)])
    assert tcfg.PAPER_SEEDS == jcfg.PAPER_SEEDS
    assert (dataclasses.asdict(tcfg.get_experiment("SOT-512", seed=7, batch_size=8))
            == dataclasses.asdict(jcfg.get_experiment("SOT-512", seed=7, batch_size=8)))


def test_chip_smoke_fails_without_a_card():
    """On a machine without CUDA the smoke exits non-zero and prints no
    result line."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
