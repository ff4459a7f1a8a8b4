"""What a run needs, found by name: the cell in ``BENCHMARK.json``, its
configuration file (``configs/<config>.json``), its traffic mix
(``traffic/<traffic>.json``), the limits of its comparison
(``limits/<workload>.json``) and the readers of its per-layer metrics
(``metrics/<metric>.py``). A later cell, mix, configuration or metric is a
new file of its own; nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


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
        self.traffic = json.loads((base / "traffic" / f"{self.entry['traffic']}.json").read_text())
        self.limits: Dict[str, float] = json.loads(
            (base / "limits" / f"{name}.json").read_text())["limits"]

        def reports(metric: dict) -> bool:
            return name in metric.get("workloads", [name])

        self.end_to_end = [m for m in bench["end_to_end"] if reports(m)]
        self.per_layer = [m for m in bench["per_layer"] if reports(m)]
        self.readers = {m["name"]: load_reader(m["name"], base) for m in self.per_layer}


def load_reader(metric: str, base: Path = HERE) -> Callable[..., Optional[float]]:
    """``read(trace)`` of ``metrics/<metric>.py``: the metric's value, or
    None where the trace holds nothing for it."""
    path = base / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location("portbench_metric_" + metric.replace(".", "_"),
                                                  path)
    module: ModuleType = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
