"""The harness on the CPU: what it loads, that it finds a cell's files by
name, that BENCHMARK.json keeps to the benchmark format's limits, and that a run
without a card prints no result."""

from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

from portbench import run, spec
from portbench import trace as trace_lib

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "sot_tpu"}


def _loaded_top_names(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, check=True, timeout=600)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax_and_not_the_jax_package():
    """A whole run of a cell (cut to the CPU), readers and reference
    included: no loaded module's top-level name is JAX's, Flax's or the
    JAX package's (``sot_tpu_torch`` is another name)."""
    code = ("import time, torch\n"
            "from portbench import run\n"
            "from portbench.tests.conftest import SmallProgram, small_cell\n"
            "cell = small_cell('sot2048-serve')\n"
            "run.run_cell(cell, 5, 0.2, True, 'cpu', SmallProgram, time.perf_counter())\n")
    names = _loaded_top_names(code)
    assert "sot_tpu_torch" in names
    assert not names & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    code = ("import json, torch\n"
            "from portbench.reference import model\n"
            "cfg = json.load(open('portbench/configs/sot2048.json'))\n"
            "m = model.Model(cfg, 'cpu')\n"
            "u = torch.rand(model.n_params(cfg), generator=torch.Generator().manual_seed(0))\n"
            "m.forward(model.weights_from_uniform(cfg, u), torch.zeros(1, cfg['n_samples']))\n")
    names = _loaded_top_names(code)
    assert not names & (FORBIDDEN | {"sot_tpu_torch"})


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "sot_tpu_torch_extra", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "sot_tpu.fake", sys)
    assert run.forbidden_modules() == ["sot_tpu"]


def test_a_run_without_a_card_prints_no_result(capsys):
    assert run.main(["--workload", "sot2048-serve", "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


def test_new_files_are_found_by_name(tmp_path):
    """A configuration, a traffic mix, a cell's limits and a per-layer metric
    added as files of their own: found by the names BENCHMARK.json gives,
    with no edit to any file there."""
    for sub in ("configs", "traffic", "limits", "metrics"):
        (tmp_path / sub).mkdir()
    cfg = json.loads((ROOT / "portbench/configs/sot2048.json").read_text())
    (tmp_path / "configs/newcfg.json").write_text(json.dumps(dict(cfg, batch_size=8)))
    (tmp_path / "traffic/newmix.json").write_text(json.dumps(
        {"kind": "closed_loop", "request_clips": 8, "pool_requests": 2, "warmup_requests": 1,
         "check_requests": 1, "trace_seconds": 1}))
    (tmp_path / "limits/newcell.json").write_text(json.dumps({"limits": {"pitch_rel": 1e-5}}))
    (tmp_path / "metrics/new_metric.py").write_text(
        "def read(trace):\n    return None if trace.units == 0 else 2.0 * trace.units\n")
    bench = dict(BENCH, workloads=[{"name": "newcell", "config": "newcfg", "traffic": "newmix",
                                    "chips": 1, "why": "a test"}],
                 per_layer=[{"name": "new_metric", "unit": "ms", "better": "lower",
                             "source": "device_trace", "layer": "x", "moves": "serve_p95_ms"}])
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.Cell("newcell", tmp_path / "BENCHMARK.json", tmp_path)
    assert cell.config["batch_size"] == 8 and cell.traffic["request_clips"] == 8
    assert cell.limits == {"pitch_rel": 1e-5}
    tr = trace_lib.Trace([{"ph": "X", "cat": "user_annotation", "name": trace_lib.WINDOW,
                           "ts": 0.0, "dur": 10.0}], "serve", 3, 8, cell.config)
    assert cell.readers["new_metric"](tr) == 6.0


def test_benchmark_json_keeps_to_the_format():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p) and (ROOT / p).is_dir()
    cfgs = {c["name"]: c for c in BENCH["configs"]}
    cells = {w["name"]: w for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    names = list(cfgs) + list(cells) + list(e2e) + [m["name"] for m in BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for name in names + [w["traffic"] for w in cells.values()]:
        assert NAME.match(name), name
    for c in cfgs.values():
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("portbench/")
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    for w in cells.values():
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in cfgs and w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert (ROOT / "portbench/traffic" / f"{w['traffic']}.json").is_file()
        assert (ROOT / "portbench/limits" / f"{w['name']}.json").is_file()
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        assert (ROOT / "portbench/metrics" / f"{m['name']}.py").is_file()
        for w in m.get("workloads", cells):
            assert w in cells and w in e2e[m["moves"]].get("workloads", cells)
    for w in cells:
        reports = [m for m in BENCH["end_to_end"] if w in m.get("workloads", cells)]
        assert len(reports) >= 2 and any(m["name"] == "setup_s" for m in reports)
        assert any(w in m.get("workloads", cells) for m in BENCH["per_layer"])
    assert len(json.dumps(BENCH)) <= 64 * 1024
