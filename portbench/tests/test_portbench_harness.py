"""The harness on the CPU: what it loads, that it finds a cell's files by
name, that BENCHMARK.json keeps to the benchmark format's limits, and that a run
without a card prints no result."""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

from portbench import counts, load, program, run, spec
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
            "from portbench.reference import pesto_sot as model\n"
            "cfg = json.load(open('portbench/configs/sot2048.json'))\n"
            "m = model.Model(cfg, 'cpu')\n"
            "u = torch.rand(model.n_params(cfg), generator=torch.Generator().manual_seed(0))\n"
            "m.forward(model.weights_from_uniform(cfg, u), torch.zeros(1, cfg['n_samples']))\n")
    names = _loaded_top_names(code)
    assert not names & (FORBIDDEN | {"sot_tpu_torch"})


@pytest.mark.parametrize("config", sorted(p.name for p in (ROOT / "portbench/configs").glob("*.json")))
def test_a_configuration_finds_its_model_and_its_reference_loads_nothing_of_the_program(config):
    """Every configuration file names a model whose four files are there;
    the model's reference and comparison, loaded as a cell loads them,
    leave nothing of the program or of JAX loaded."""
    code = ("import json\n"
            "from portbench import spec\n"
            f"cfg = json.load(open('portbench/configs/{config}'))\n"
            "spec.Model(spec.model_name(cfg))\n")
    names = _loaded_top_names(code)
    assert "torch" in names and not names & (FORBIDDEN | {"sot_tpu_torch"})


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "sot_tpu_torch_extra", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "sot_tpu.fake", sys)
    assert run.forbidden_modules() == ["sot_tpu"]


def test_a_run_without_a_card_prints_no_result(capsys):
    assert run.main(["--workload", "sot2048-serve", "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


# a toy model (``toy/``: its reference, adapter, comparison, counts and
# configuration), laid out as the harness finds a model by the name its
# configuration gives; copied into a temporary layout, never into the harness
TOY = Path(__file__).resolve().parent / "toy"
TOY_LIMITS = {"toy-train": {"loss_step1_rel": 1e-4, "grad_gap": 1e-4, "change_gap": 1e-2},
              "toy-serve": {"pitch_rel": 1e-5, "xhat_rel": 1e-4}}
TOY_CELLS = {"toy-train": "toy-epoch", "toy-serve": "toy-loop"}
# the toy's own end-to-end and per-layer metrics, each named after a
# quantity the harness measures or a reader it has, qualified by ``.toy``;
# ``new_metric`` is a reader the toy brings
_KINDS = {"train": ("toy-train", "train_frames_per_s.toy"),
          "serve": ("toy-serve", "serve_clips_per_s.toy")}
TOY_END_TO_END = [
    {"name": "train_frames_per_s.toy", "unit": "frames/s", "better": "higher", "bound": 0.1,
     "source": "host_clock", "workloads": ["toy-train"]},
    {"name": "serve_clips_per_s.toy", "unit": "clips/s", "better": "higher", "bound": 0.1,
     "source": "host_clock", "workloads": ["toy-serve"]},
    {"name": "serve_p95_ms.toy", "unit": "ms", "better": "lower", "bound": 0.1,
     "source": "host_clock", "workloads": ["toy-serve"]}]
TOY_PER_LAYER = [
    {"name": f"{metric}.toy", "unit": unit, "better": better, "source": "device_trace",
     "layer": "toy", "moves": _KINDS[kind][1], "workloads": [_KINDS[kind][0]]}
    for metric, unit, better, kind in (
        ("step_busy_ms.train", "ms", "lower", "train"), ("idle_share.train", "%", "lower", "train"),
        ("mfu.train", "%", "higher", "train"), ("request_busy_ms.serve", "ms", "lower", "serve"),
        ("idle_share.serve", "%", "lower", "serve"), ("mfu.serve", "%", "higher", "serve"))] + [
    {"name": "new_metric", "unit": "ms", "better": "lower", "source": "device_trace",
     "layer": "toy", "moves": "serve_p95_ms.toy", "workloads": ["toy-serve"]}]
HARNESS_DATA = ("configs", "traffic", "limits", "metrics")


def _layout(base: Path, model: str = "toy_linear", end_to_end=(), per_layer=()) -> Path:
    """The harness's data (configurations, traffic, limits, metric readers)
    copied under ``base`` as it is, and the toy model added as new files
    and entries only: the model's files, its configuration naming
    ``model``, a traffic mix of each kind, the limits of a train and a
    serve cell, a per-layer reader, and a BENCHMARK.json that is the
    harness's with the toy's configuration, cells and metrics (and
    ``end_to_end``, ``per_layer``) appended; returns its path."""
    for sub in HARNESS_DATA:
        shutil.copytree(ROOT / "portbench" / sub, base / sub)
    shutil.copytree(TOY, base, dirs_exist_ok=True)
    cfg = json.loads((base / "configs/toy.json").read_text())
    (base / "configs/toy.json").write_text(json.dumps(dict(cfg, model=model)))
    (base / "traffic/toy-epoch.json").write_text(json.dumps(
        {"kind": "train_epoch", "train_share": 0.7, "check_steps": 3, "trace_seconds": 1}))
    (base / "traffic/toy-loop.json").write_text(json.dumps(
        {"kind": "closed_loop", "request_clips": 2, "pool_requests": 3, "warmup_requests": 1,
         "check_requests": 2, "trace_seconds": 1}))
    for cell, limits in TOY_LIMITS.items():
        (base / "limits" / f"{cell}.json").write_text(json.dumps({"limits": limits}))
    (base / "metrics/new_metric.py").write_text(
        "def read(trace):\n    return None if trace.units == 0 else 2.0 * trace.units\n")
    added = {"configs": [{"name": "toy", "source": "a test", "file": "configs/toy.json",
                          "reduced": [], "why": "a test"}],
             "workloads": [{"name": c, "config": "toy", "traffic": t, "chips": 1, "why": "a test"}
                           for c, t in TOY_CELLS.items()],
             "end_to_end": TOY_END_TO_END + list(end_to_end),
             "per_layer": TOY_PER_LAYER + list(per_layer)}
    bench = dict(BENCH, **{k: BENCH[k] + v for k, v in added.items()})
    (base / "BENCHMARK.json").write_text(json.dumps(bench))
    return base / "BENCHMARK.json"


def _harness_untouched(base: Path) -> None:
    """The layout's BENCHMARK.json holds the harness's entries as they are,
    before the toy's, and every file copied from the harness is unchanged."""
    bench = json.loads((base / "BENCHMARK.json").read_text())
    for key, value in BENCH.items():
        assert bench[key][:len(value)] == value if isinstance(value, list) else bench[key] == value
    for sub in HARNESS_DATA:
        for f in (ROOT / "portbench" / sub).glob("*"):
            assert (base / sub / f.name).read_bytes() == f.read_bytes(), f


def test_new_files_are_found_by_name(tmp_path):
    """A configuration, its model (reference, adapter, comparison, counts),
    a traffic mix, a cell's limits and metrics, added as files and entries
    of their own: found by the names BENCHMARK.json and the configuration
    give, with no edit to any file or entry there. The toy's metrics are
    read by the harness's readers of the quantities they name; the model's
    parts are the same modules however they are reached."""
    cell = spec.Cell("toy-serve", _layout(tmp_path), tmp_path)
    _harness_untouched(tmp_path)
    assert cell.config["model"] == "toy_linear" and cell.traffic["request_clips"] == 2
    assert cell.limits == TOY_LIMITS["toy-serve"]
    assert cell.model.compare.OUTPUTS == {"host": ("pitch_hz", "amplitudes"), "device": ("x_hat",)}
    assert cell.model.reference.n_params(cell.config) == 5 * 256 + 5
    assert program.adapter(cell).__module__ == "portbench.adapters.toy_linear"
    assert counts.of(cell.config) is cell.model.counts
    assert cell.model.compare.ref is cell.model.reference is spec.load_part("reference", "toy_linear")
    assert [m["name"] for m in cell.end_to_end] == [
        "setup_s", "serve_clips_per_s.toy", "serve_p95_ms.toy"]
    assert [spec.quantity(m["name"], load.ClosedLoop.REPORTS + ("setup_s",))
            for m in cell.end_to_end] == ["setup_s", "serve_clips_per_s", "serve_p95_ms"]
    assert sorted(cell.readers) == sorted(m["name"] for m in TOY_PER_LAYER
                                          if m["workloads"] == ["toy-serve"])
    for name, read in cell.readers.items():
        want = name if name == "new_metric" else name[:-len(".toy")]
        assert read.__code__.co_filename == str(tmp_path / "metrics" / f"{want}.py")
    tr = trace_lib.Trace([{"ph": "X", "cat": "user_annotation", "name": trace_lib.WINDOW,
                           "ts": 0.0, "dur": 10.0}], "serve", 3, 8, cell.config)
    assert cell.readers["new_metric"](tr) == 6.0


@pytest.mark.parametrize("workload", ["toy-train", "toy-serve"])
@pytest.mark.parametrize("seed", [1, 2147483659])
def test_a_new_model_runs_correct(tmp_path, workload, seed):
    """The toy model's cells, a train and a serve cell, run to correct on
    the CPU through the harness as it stands, and report the toy's own
    end-to-end metrics, read from the quantities they name."""
    cell = spec.Cell(workload, _layout(tmp_path), tmp_path)
    result = run.run_cell(cell, seed, 0.1, False, "cpu", program.adapter(cell),
                          time.perf_counter())
    assert result["correct"], result["compared"]
    assert result["attempted"] > 0 and result["failed"] == 0
    want = {"toy-train": {"setup_s", "train_frames_per_s.toy"},
            "toy-serve": {"setup_s", "serve_clips_per_s.toy", "serve_p95_ms.toy"}}[workload]
    assert set(result["metrics"]) == want
    assert all(v["value"] > 0 for v in result["metrics"].values())
    _harness_untouched(tmp_path)


@pytest.mark.parametrize("workload", ["toy-train", "toy-serve"])
def test_a_new_model_is_read_by_the_harness_readers(tmp_path, workload):
    """A traced run of each toy cell on the CPU: correct, and its ``mfu.*``
    read by the harness's reader from the toy's own counts (the readers of
    device time read nothing, as the CPU run has no device events)."""
    cell = spec.Cell(workload, _layout(tmp_path), tmp_path)
    result = run.run_cell(cell, 5, 0.1, True, "cpu", program.adapter(cell), time.perf_counter())
    assert result["correct"], result["compared"]
    kind = "train" if workload == "toy-train" else "serve"
    mfu = result["metrics"].pop(f"mfu.{kind}.toy")["value"]
    toy = cell.model.counts
    clips = cell.config["batch_size"] if kind == "train" else cell.traffic["request_clips"]
    flops = (toy.train_step_flops if kind == "train" else toy.forward_flops)(cell.config, clips)
    assert mfu == pytest.approx(100.0 * flops * result["attempted"]
                                / result["device"]["window_s"] / counts.PEAK_FLOPS)
    assert set(result["metrics"]) == ({"new_metric"} if kind == "serve" else set())


@pytest.mark.parametrize("workload", ["toy-train", "toy-serve"])
def test_a_fault_in_a_new_model_is_not_correct(tmp_path, workload):
    """The toy program's output doubled where it is produced."""
    cell = spec.Cell(workload, _layout(tmp_path), tmp_path)

    class Doubled(program.adapter(cell)):
        def render(self, amps, pitch_hz):
            return 2.0 * super().render(amps, pitch_hz)

    result = run.run_cell(cell, 3, 0.1, False, "cpu", Doubled, time.perf_counter())
    assert not result["correct"], result["compared"]


def test_an_unknown_model_fails_at_setup(tmp_path):
    """A configuration naming a model that has no files: the cell is not
    set up, and the error names the files looked for."""
    bench = _layout(tmp_path, model="toy_misspelt")
    with pytest.raises(SystemExit) as err:
        spec.Cell("toy-train", bench, tmp_path)
    for sub in spec.MODEL_PARTS:
        assert str(tmp_path / sub / "toy_misspelt.py") in str(err.value)


def test_a_configuration_without_a_model_fails_at_setup(tmp_path):
    bench = _layout(tmp_path)
    cfg = json.loads((tmp_path / "configs/toy.json").read_text())
    del cfg["model"]
    (tmp_path / "configs/toy.json").write_text(json.dumps(cfg))
    with pytest.raises(SystemExit, match="names no model"):
        spec.Cell("toy-train", bench, tmp_path)


@pytest.mark.parametrize("part", ["end_to_end", "per_layer"])
def test_a_metric_that_names_nothing_measured_fails_at_setup(tmp_path, part):
    """A toy metric whose name is no quantity the cell measures (end to
    end) or has no reader (per layer): the cell stops before its set-up,
    naming what it looked for."""
    metric = {"name": "frames_per_s.toy", "unit": "ms", "better": "lower",
              "source": "device_trace", "workloads": ["toy-train"]}
    if part == "end_to_end":
        bench = _layout(tmp_path, end_to_end=[dict(metric, bound=0.1, source="host_clock")])
        cell = spec.Cell("toy-train", bench, tmp_path)
        with pytest.raises(SystemExit, match=r"none of \['frames_per_s.toy', 'frames_per_s'\]"):
            run.run_cell(cell, 1, 0.1, False, "cpu", program.adapter(cell), time.perf_counter())
    else:
        bench = _layout(tmp_path, per_layer=[dict(metric, layer="toy",
                                                  moves="train_frames_per_s.toy")])
        with pytest.raises(SystemExit) as err:
            spec.Cell("toy-train", bench, tmp_path)
        for name in ("frames_per_s.toy.py", "frames_per_s.py"):
            assert str(tmp_path / "metrics" / name) in str(err.value)


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
        assert spec.reader_path(m["name"]).is_file()
        for w in m.get("workloads", cells):
            assert w in cells and w in e2e[m["moves"]].get("workloads", cells)
    for w in cells:
        reports = [m for m in BENCH["end_to_end"] if w in m.get("workloads", cells)]
        traffic = json.loads((ROOT / "portbench/traffic" / f"{cells[w]['traffic']}.json").read_text())
        for m in reports:
            spec.quantity(m["name"], load.KINDS[traffic["kind"]].REPORTS + ("setup_s",))
        assert len(reports) >= 2 and any(m["name"] == "setup_s" for m in reports)
        assert any(w in m.get("workloads", cells) for m in BENCH["per_layer"])
    assert len(json.dumps(BENCH)) <= 64 * 1024
