"""The port's paper table (``sot_tpu_torch/eval_paper.py``) against
``sot_tpu/eval_paper.py`` on the CPU.

  * ``rename_metrics``, ``aggregate`` and ``format_paper_table`` equal to
    JAX's on numpy-seeded rows (n = 1, 1 < n < 5 and n = 5 cells, OD ranked
    by |mean|, the higher-better columns)
  * ``evaluate_run`` and ``main`` on one SOT-2048 run of 40 clips (a 4-clip
    test split) at full width: JAX's run dir holds a symlink to the
    committed Orbax checkpoint ``results/checkpoints/best/SOT-2048-42``, the
    port's a run checkpoint of the same weights (the predict golden's),
    both with ``train_config.json`` ``{"name": "SOT-2048", "dataset_size":
    40}``. The metrics agree within ``chip_smoke.eval_metrics_check``'s
    limits (LSD, MSE, MSS and the loss terms within 1e-3 relative, the
    frame-wise metrics within one frame: 1/64 of the 4 x 16 frames); the
    files carry JAX's names and keys, and JAX's ``format_paper_table`` of
    the port's JSON rows is the port's CSV
  * the two places where a literal transcription of JAX's ``main`` fails
    the port: the port's ``best-lsd`` is a file (JAX's ``main`` keeps a run
    only when it is a directory, so it would skip every port run), and a
    run directory belongs to a family only when its name is exactly
    ``<EXPERIMENT>-<digits>`` (JAX's ``glob(f"{exp}-*")`` also puts
    ``SOT-2048-SS-42`` in SOT-2048's row); a run without a readable
    ``best-lsd`` is named on stdout
  * ``chip_smoke.py``'s [paper-table] phase at a tiny size
"""

from __future__ import annotations

import glob
import json
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from sot_tpu import eval_paper as jeval  # noqa: E402
from sot_tpu_torch import eval_paper as teval  # noqa: E402
from sot_tpu_torch.cli import _save_resolved_config  # noqa: E402
from sot_tpu_torch.configs import get_experiment  # noqa: E402
from sot_tpu_torch.convert import flax_tree_from_flat, params_from_flax  # noqa: E402
from sot_tpu_torch.training import checkpoint as ckpt_lib  # noqa: E402
from sot_tpu_torch.training import trainer as ttrainer  # noqa: E402
from tests import _torch_golden  # noqa: E402

CPU = ["--device", "cpu"]
RUN_CONFIG = {"name": "SOT-2048", "dataset_size": 40}
TINY_KW = dict(n_samples=1024, cqt_fmin=261.6, batch_size=8, transform_n_fft=512,
               transform_hop=128)


def _seeded_rows(n: int, seed: int):
    rng = np.random.default_rng(seed)
    return [{"log_spectral_distance": float(rng.uniform(20, 80)), "mse": float(rng.uniform(0, 1)),
             "mss": float(rng.uniform(5, 10)), "octave_difference": float(rng.uniform(-2, 2)),
             "raw_pitch_accuracy": float(rng.uniform(0, 1)),
             "raw_chroma_accuracy": float(rng.uniform(0, 1)), "loss/total": 1.0}
            for _ in range(n)]


def test_constants_equal_jax():
    assert teval.RENAME == jeval.RENAME
    assert teval.HIGHER_BETTER == jeval.HIGHER_BETTER


def test_rename_aggregate_and_table_equal_jax():
    table_j, table_t = {}, {}
    for i, (exp, n) in enumerate([("SOT-2048", 5), ("SOT-512", 1), ("MSS-Lin", 3),
                                  ("SOT-NoCut", 2), ("MSS-LogLin", 4)]):
        rows = _seeded_rows(n, seed=i)
        renamed_j = [jeval.rename_metrics(r) for r in rows]
        renamed_t = [teval.rename_metrics(r) for r in rows]
        assert renamed_t == renamed_j
        assert list(renamed_t[0]) == ["LSD", "MSE", "MSS", "OD", "RPA", "RCA"]
        table_j[exp], table_t[exp] = jeval.aggregate(renamed_j), teval.aggregate(renamed_t)
        assert table_t[exp] == table_j[exp]
    lines = teval.format_paper_table(table_t)
    assert lines == jeval.format_paper_table(table_j)
    assert teval.format_paper_table({}) == jeval.format_paper_table({}) == []
    cells = dict(line.split(",", 1) for line in lines[1:])
    assert "(n=1)" in cells["SOT-512"] and "[n=3]" in cells["MSS-Lin"]
    assert "[n=" not in cells["SOT-2048"]
    # OD: the mean closest to zero is best, not the largest or smallest
    od = {e: table_t[e]["OD"]["mean"] for e in table_t}
    best = min(od, key=lambda e: abs(od[e]))
    assert cells[best].split(",")[3].startswith("\\textbf{")


def _port_weights():
    with np.load(_torch_golden.GOLDEN) as z:
        return params_from_flax(flax_tree_from_flat({k: z[k] for k in z.files
                                                     if k.startswith("params/")}))


def _write_config(run: str, cfg=RUN_CONFIG) -> None:
    os.makedirs(run, exist_ok=True)
    with open(os.path.join(run, "train_config.json"), "w") as fh:
        json.dump(cfg, fh)


def _port_run(run: str, cfg_json=RUN_CONFIG, weights=None, **overrides) -> None:
    """A port run: ``train_config.json`` and a run checkpoint at
    ``checkpoints/best-lsd``."""
    _write_config(run, cfg_json)
    mod = ttrainer.build_modules(get_experiment(cfg_json["name"], **overrides), device="cpu",
                                 generator=torch.Generator().manual_seed(0))
    if weights is not None:
        mod.encoder.load_state_dict(weights)
    ckpt_lib.save(os.path.join(run, "checkpoints"), mod, ttrainer.init_state(mod), 1,
                  tag="best-lsd")


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """JAX's and the port's ``main`` on one SOT-2048 run each, with the
    full metrics of each ``evaluate_run`` recorded."""
    root = tmp_path_factory.mktemp("paper")
    runs_j, runs_t = str(root / "runs_jax"), str(root / "runs_port")
    _write_config(os.path.join(runs_j, "SOT-2048-42"))
    os.makedirs(os.path.join(runs_j, "SOT-2048-42", "checkpoints"))
    os.symlink(_torch_golden.CKPT, os.path.join(runs_j, "SOT-2048-42", "checkpoints",
                                                "best-lsd"))
    _port_run(os.path.join(runs_t, "SOT-2048-42"), weights=_port_weights())
    metrics = {}

    def spy(module, key):
        real = module.evaluate_run

        def run(*args, **kw):
            metrics[key] = real(*args, **kw)
            return metrics[key]
        return run

    out = {}
    for key, module, runs, extra in (("jax", jeval, runs_j, []), ("port", teval, runs_t, CPU)):
        out[key] = str(root / f"out_{key}")
        mp = pytest.MonkeyPatch()
        mp.setattr(module, "evaluate_run", spy(module, key))
        try:
            assert module.main(["--runs-dir", runs, "--out", out[key], "--experiments",
                                "SOT-2048"] + extra) == 0
        finally:
            mp.undo()
    return {"metrics": metrics, "out": out, "runs_port": runs_t}


def test_evaluate_run_matches_jax(both):
    import chip_smoke

    got, ref = both["metrics"]["port"], both["metrics"]["jax"]
    frame = chip_smoke.split_frame_weight(4, 64, 16)
    assert frame == 1.0 / 64
    chip_smoke.eval_metrics_check("eval_paper", got, ref, frame=frame)


def test_main_writes_jax_files_and_keys(both):
    out_j, out_t = both["out"]["jax"], both["out"]["port"]
    assert sorted(os.listdir(out_t)) == sorted(os.listdir(out_j)) == sorted(teval.FILES)
    loaded = {}
    for key, out in (("jax", out_j), ("port", out_t)):
        with open(os.path.join(out, "synthetic_results_best-lsd.json")) as fh:
            per_run = json.load(fh)
        with open(os.path.join(out, "synthetic_results_paper_best-lsd.json")) as fh:
            table = json.load(fh)
        with open(os.path.join(out, "synthetic_results_paper_best-lsd.csv")) as fh:
            csv_text = fh.read()
        loaded[key] = (per_run, table, csv_text)
    (pr_j, tab_j, csv_j), (pr_t, tab_t, csv_t) = loaded["jax"], loaded["port"]
    assert [list(r) for r in pr_t] == [list(r) for r in pr_j]
    assert [(r["experiment"], r["run"]) for r in pr_t] == [("SOT-2048", "SOT-2048-42")]
    assert {e: {m: list(c) for m, c in row.items()} for e, row in tab_t.items()} == \
        {e: {m: list(c) for m, c in row.items()} for e, row in tab_j.items()}
    assert csv_t == "\n".join(jeval.format_paper_table(tab_t)) + "\n"
    assert csv_t.splitlines()[0] == csv_j.splitlines()[0]
    for col in ("LSD", "MSE", "MSS"):
        assert tab_t["SOT-2048"][col]["mean"] == pytest.approx(tab_j["SOT-2048"][col]["mean"],
                                                               rel=1e-3)


def test_jax_main_skips_every_port_run(both, tmp_path):
    """The first trap: JAX's ``main`` on the port's runs dir finds no
    ``best-lsd`` directory and writes an empty table without a word; the
    port's found the file (``test_main_writes_jax_files_and_keys``)."""
    assert jeval.main(["--runs-dir", both["runs_port"], "--out", str(tmp_path),
                       "--experiments", "SOT-2048"]) == 0
    with open(tmp_path / "synthetic_results_paper_best-lsd.json") as fh:
        assert json.load(fh) == {}


def test_family_runs_take_exact_names(tmp_path):
    """The second trap: JAX's glob puts other families' runs in a row."""
    names = ["SOT-2048-42", "SOT-2048-7", "SOT-2048-SS-42", "SOT-2048-Anneal-42",
             "SOT-2048-SS-Probes-42", "SOT-512-42", "SOT-512-LogF-42", "SOT-2048-x",
             "SOT-2048-"]
    for name in names:
        os.makedirs(tmp_path / name)
    (tmp_path / "SOT-2048-9").write_text("a file, not a run directory")
    base = lambda paths: sorted(os.path.basename(p) for p in paths)  # noqa: E731
    assert base(teval.family_runs(str(tmp_path), "SOT-2048")) == ["SOT-2048-42", "SOT-2048-7"]
    assert base(teval.family_runs(str(tmp_path), "SOT-2048-SS")) == ["SOT-2048-SS-42"]
    assert base(teval.family_runs(str(tmp_path), "SOT-512")) == ["SOT-512-42"]
    assert base(teval.family_runs(str(tmp_path), "MSS-Lin")) == []
    assert teval.family_runs(str(tmp_path / "missing"), "SOT-2048") == []
    jax_rows = base(glob.glob(os.path.join(str(tmp_path), "SOT-2048-*")))
    assert {"SOT-2048-SS-42", "SOT-2048-Anneal-42", "SOT-2048-SS-Probes-42"} <= set(jax_rows)
    assert "SOT-512-LogF-42" in base(glob.glob(os.path.join(str(tmp_path), "SOT-512-*")))


def test_a_run_counts_in_its_own_row_only(tmp_path, capsys):
    runs = str(tmp_path / "runs")
    for exp in ("SOT-2048", "SOT-2048-SS"):
        run = os.path.join(runs, f"{exp}-42")
        _port_run(run, {"name": exp}, **TINY_KW)
        _save_resolved_config(get_experiment(exp, dataset_size=24, **TINY_KW), run)
    out = str(tmp_path / "out")
    assert teval.main(["--runs-dir", runs, "--out", out, "--experiments", "SOT-2048",
                       "SOT-2048-SS"] + CPU) == 0
    with open(os.path.join(out, "synthetic_results_paper_best-lsd.json")) as fh:
        table = json.load(fh)
    assert {e: table[e]["LSD"]["n"] for e in table} == {"SOT-2048": 1, "SOT-2048-SS": 1}
    with open(os.path.join(out, "synthetic_results_best-lsd.json")) as fh:
        assert [(r["experiment"], r["run"]) for r in json.load(fh)] == [
            ("SOT-2048", "SOT-2048-42"), ("SOT-2048-SS", "SOT-2048-SS-42")]
    assert "experiment" in capsys.readouterr().out  # the console table


def test_runs_without_a_readable_best_lsd_are_named(tmp_path, capsys):
    runs = tmp_path / "runs"
    (runs / "MSS-Lin-1").mkdir(parents=True)                      # no checkpoint
    (runs / "MSS-Lin-2" / "checkpoints" / "best-lsd").mkdir(parents=True)  # JAX's layout
    (runs / "MSS-Lin-3" / "checkpoints").mkdir(parents=True)
    (runs / "MSS-Lin-3" / "checkpoints" / "best-lsd").write_bytes(b"not a checkpoint")
    (runs / "MSS-Lin-4" / "checkpoints").mkdir(parents=True)
    (runs / "MSS-Lin-4" / "checkpoints" / "best-lsd").write_bytes(b"")
    out = tmp_path / "out"
    assert teval.main(["--runs-dir", str(runs), "--out", str(out), "--experiments", "MSS-Lin",
                       "SOT-2048"] + CPU) == 0
    text = capsys.readouterr().out
    for run, why in (("MSS-Lin-1", "no checkpoints/best-lsd"), ("MSS-Lin-2", "directory"),
                     ("MSS-Lin-3", "not readable"), ("MSS-Lin-4", "not readable")):
        line = next(line for line in text.splitlines() if run in line)
        assert line.startswith("MSS-Lin: skipped") and why in line, line
    assert "MSS-Lin: 4 run(s), none with a readable checkpoints/best-lsd; no row" in text
    assert "SOT-2048" not in text  # a family with no runs at all says nothing
    with open(out / "synthetic_results_paper_best-lsd.json") as fh:
        assert json.load(fh) == {}
    assert (out / "synthetic_results_paper_best-lsd.csv").read_text() == "\n"


def test_main_without_device_or_cuda_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        teval.main(["--runs-dir", str(tmp_path), "--out", str(tmp_path / "out")])


def test_chip_smoke_paper_table_phase_on_cpu():
    """``chip_smoke.py``'s [paper-table] phase at a tiny size on the CPU
    (seeded weights in place of the golden's, whose rows it skips)."""
    import chip_smoke

    chip_smoke.check_paper_table(torch.device("cpu"), TINY_KW, 32)
