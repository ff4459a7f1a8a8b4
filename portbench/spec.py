"""What a run needs, found by name: the cell in ``BENCHMARK.json``, its
configuration file (``configs/<config>.json``), the model that file names
under ``"model"`` (``Model``: ``reference/<model>.py``,
``adapters/<model>.py``, ``compare/<model>.py``, ``counts/<model>.py``),
its traffic mix (``traffic/<traffic>.json``), the limits of its comparison
(``limits/<workload>.json``) and the readers of its per-layer metrics
(``metrics/<metric>.py``). A later cell, mix, configuration, model or
metric is a new file of its own; nothing here names one.

A cell reports the metrics of ``BENCHMARK.json`` whose ``workloads`` name
it (or that have none), so a new model's cell brings metrics of its own,
as new entries: a metric named ``<quantity>.<qualifier>`` reports what
``<quantity>`` does where nothing is named ``<quantity>.<qualifier>``
itself (``train_frames_per_s.ddsp`` the train window's frames a second,
``mfu.train.ddsp`` read by ``metrics/mfu.train.py``).
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, Iterable, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

# the directories of a model's files: its plain reference (which imports
# nothing of the program), its program adapter (the program built from a
# configuration file, the only file of a model that imports the program),
# its comparison (the readings of a train and a serve check) and its counts
MODEL_PARTS = ("reference", "adapters", "compare", "counts")


class Model:
    """The files of the model ``name`` under ``base``: ``reference``,
    ``compare`` and ``counts`` loaded; the adapter is the program's to load
    (``program.adapter``)."""

    def __init__(self, name: str, base: Path = HERE):
        if not name.isidentifier():
            raise SystemExit(f"model {name!r}: a model's name is a Python identifier")
        self.name, self.base = name, Path(base)
        files = [self.base / sub / f"{name}.py" for sub in MODEL_PARTS]
        missing = [str(f) for f in files if not f.is_file()]
        if missing:
            raise SystemExit(f"model {name!r}: looked for {[str(f) for f in files]}; "
                             f"missing {missing}")
        self.reference = load_part("reference", name, base)
        self.compare = load_part("compare", name, base)
        self.counts = load_part("counts", name, base)


class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""

    def __init__(self, name: str, bench_path: Path = ROOT / "BENCHMARK.json",
                 base: Path = HERE):
        bench = json.loads(Path(bench_path).read_text())
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
        self.name = name
        self.entry = cells[name]
        self.chips = int(self.entry["chips"])
        self.config = json.loads((base / "configs" / f"{self.entry['config']}.json").read_text())
        self.model = Model(model_name(self.config), base)
        self.traffic = json.loads((base / "traffic" / f"{self.entry['traffic']}.json").read_text())
        self.limits: Dict[str, float] = json.loads(
            (base / "limits" / f"{name}.json").read_text())["limits"]

        def reports(metric: dict) -> bool:
            return name in metric.get("workloads", [name])

        self.end_to_end = [m for m in bench["end_to_end"] if reports(m)]
        self.per_layer = [m for m in bench["per_layer"] if reports(m)]
        self.readers = {m["name"]: load_reader(m["name"], base) for m in self.per_layer}


def model_name(cfg: dict) -> str:
    """The model a configuration file names."""
    if "model" not in cfg:
        raise SystemExit("the configuration names no model (its \"model\" key)")
    return cfg["model"]


def load_part(sub: str, name: str, base: Optional[Path] = None) -> ModuleType:
    """``<base>/<sub>/<name>.py``, loaded from its file as the module
    ``portbench.<sub>.<name>`` and kept in ``sys.modules`` under that name,
    so that a cell, its metric readers (``counts.of``) and an import of
    the harness's own package all get the one module. Without ``base``:
    the one already loaded (a cell loads its model's first), else the
    harness's own."""
    key = f"portbench.{sub}.{name}"
    loaded = sys.modules.get(key)
    if base is None:
        if loaded is not None:
            return loaded
        base = HERE
    path = (Path(base) / sub / f"{name}.py").resolve()
    if loaded is not None and Path(loaded.__file__).resolve() == path:
        return loaded
    return _from_path(path, key, keep=True)


def prefixes(name: str) -> List[str]:
    """``a.b.c``, ``a.b``, ``a``: a metric's name and the quantities it may
    report, the nearest first."""
    parts = name.split(".")
    return [".".join(parts[:i]) for i in range(len(parts), 0, -1)]


def quantity(metric: str, known: Iterable[str]) -> str:
    """The quantity among ``known`` that the end-to-end metric ``metric``
    reports: its longest dotted prefix there."""
    known = set(known)
    for q in prefixes(metric):
        if q in known:
            return q
    raise SystemExit(f"end-to-end metric {metric!r}: this cell measures {sorted(known)}, "
                     f"none of {prefixes(metric)}")


def reader_path(metric: str, base: Path = HERE) -> Path:
    """``metrics/<name>.py`` for the per-layer metric's name or, where
    there is none, for its longest dotted prefix that has one."""
    tried = [Path(base) / "metrics" / f"{q}.py" for q in prefixes(metric)]
    for path in tried:
        if path.is_file():
            return path
    raise SystemExit(f"per-layer metric {metric!r}: no reader among {[str(p) for p in tried]}")


def load_reader(metric: str, base: Path = HERE) -> Callable[..., Optional[float]]:
    """``read(trace)`` of the metric's reader (``reader_path``): the
    metric's value, or None where the trace holds nothing for it."""
    return _from_path(reader_path(metric, base),
                      f"portbench_metric_{metric}".replace(".", "_")).read


def _from_path(path: Path, name: str, keep: bool = False) -> ModuleType:
    """The module of the file ``path`` under ``name``, executed; with
    ``keep`` held in ``sys.modules`` under that name (set before it runs,
    as an import does)."""
    spec = importlib.util.spec_from_file_location(name, path)
    module: ModuleType = importlib.util.module_from_spec(spec)
    if keep:
        sys.modules[name] = module
    try:
        spec.loader.exec_module(module)
    except BaseException:
        if keep:
            sys.modules.pop(name, None)
        raise
    return module
