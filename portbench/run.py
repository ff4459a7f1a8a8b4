"""Run one cell of the benchmark once and print its result line.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up (counted in ``setup_s``, from the start of this process to the
first timed step or request): the program's CUDA sources built into its
fixed build directory inside the checkout (only a checkout's first run
compiles), the clips and the weights made on the card from ``--seed``, the
program's model built by the adapter of the model that the cell's
configuration names, the cell's graph captured and warmed up. Then the
window: ``--seconds`` of the cell's work on the host clock (``--trace 0``,
the end-to-end metrics), or up to the traffic file's ``trace_seconds`` of
it under the profiler (``--trace 1``, the per-layer metrics). Then the
device's memory peak is read, the program's state freed, and the plain
reference judges what the timed path produced.

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, ``breakdown`` when
traced, and ``compared`` last: each number compared with its limit); the
numbers compared also close standard error. Without a CUDA device, with
fewer devices than the cell asks for, or with JAX or the JAX package loaded
once the window has closed, the run exits non-zero and prints no result.
"""

from __future__ import annotations

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# every build and kernel cache at a fixed place inside the checkout (the
# program's own CUDA sources build into sot_tpu_torch/_build there)
CACHE = ROOT / ".portbench_cache"

FORBIDDEN = ("jax", "jaxlib", "flax", "sot_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is JAX's,
    Flax's or the JAX package's, compared whole."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.run", description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def run_cell(cell, seed: int, seconds: float, traced: bool, device, program_cls,
             start: float) -> dict:
    """Set-up, window, comparison; the result object (without the checks
    on the device and the loaded modules, which ``main`` makes)."""
    import torch

    from portbench import check, load, spec
    from portbench import trace as trace_lib

    dev = torch.device(device)
    cls = load.KINDS[cell.traffic["kind"]]
    # each end-to-end metric and the quantity it reports (a name that
    # reports nothing this kind of traffic measures stops the cell here)
    quantities = {m["name"]: spec.quantity(m["name"], cls.REPORTS + ("setup_s",))
                  for m in cell.end_to_end}
    work = cls(cell, seed, dev, program_cls)
    work.setup()
    setup_s = time.perf_counter() - start
    print("portbench: set-up " + " ".join(f"{k} {v:.3f}s" for k, v in work.phases.items())
          + f", {setup_s:.3f}s in all", file=sys.stderr)

    result: dict = {}
    if traced:
        events = work.traced(min(seconds, cell.traffic["trace_seconds"]))
        values, device_times, breakdown = trace_lib.reduce(
            events, work.kind, work.units, work.clips_per_unit, cell.config, cell.readers)
        units = {m["name"]: m["unit"] for m in cell.per_layer}
        result["metrics"] = {k: {"value": v, "unit": units[k]} for k, v in values.items()}
        result["breakdown"] = breakdown
    else:
        window_s = work.window(seconds)
        values = dict(work.metrics(window_s), setup_s=setup_s)
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        result["metrics"] = {k: {"value": values[quantities[k]], "unit": units[k]}
                             for k in units}
        device_times = {}
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    result["attempted"], result["failed"] = work.units, work.failed
    work.release()
    readings = work.check()
    result["correct"] = check.verdict(readings, cell.limits) and work.failed == 0
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    result["device"] = {"platform": "gpu" if dev.type == "cuda" else "cpu", "kind": name,
                        "count": cell.chips, "memory_peak_bytes": int(peak), **device_times}
    result["readings"] = readings
    result["compared"] = {k: {"value": readings[k], "limit": v} for k, v in cell.limits.items()}
    return result


def main(argv=None) -> int:
    args = parse(argv)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv_compute")):
        os.environ[var] = str(CACHE / sub)
    from portbench import spec

    cell = spec.Cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: the cell needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    from portbench import program

    program_cls = program.adapter(cell)
    program.set_policy()
    t0 = time.perf_counter()
    torch.zeros(1, device="cuda")
    t1 = time.perf_counter()
    program.build_kernels()
    print(f"portbench: imports {t0 - PROCESS_START:.3f}s, CUDA context {t1 - t0:.3f}s, "
          f"kernel build {time.perf_counter() - t1:.3f}s", file=sys.stderr)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", program_cls,
                      PROCESS_START)
    found = forbidden_modules()
    if found:
        print(f"portbench: loaded after the window: {found}", file=sys.stderr)
        return 3
    order = ("correct", "attempted", "failed", "metrics", "device", "breakdown", "compared")
    line = {k: result[k] for k in order if k in result}
    print("portbench: read, not compared: " + ", ".join(
        f"{k} {v!r}" for k, v in result["readings"].items() if k not in result["compared"]),
        file=sys.stderr)
    for k, v in result["compared"].items():
        print(f"{k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
