"""``sot_tpu_torch/training/profiling.py`` (the port of the JAX package's
profiling module on ``torch.profiler``) and ``cli train --profile``:

  * the summaries on a Chrome trace this test writes, with kernels of each
    origin (the port's ``csrc/``, cuDNN/cuBLAS/cuFFT, PyTorch's own),
    copies and sets, and events that are not device work (host ops, runtime
    calls, GPU annotations, which would count twice);
  * a real ``trace()`` of 2 tiny train steps on the CPU: a gzipped trace
    the summaries read, with no device events, so the table says "not
    measured" and prints no zero;
  * ``cli train --profile`` on the CPU: the trace under ``<out>/trace``,
    the table, and the run going on to train as without the flag;
  * the table of the port's spans (``summarize_spans``) on a written trace,
    with and without device events.
"""

from __future__ import annotations

import glob
import gzip
import json
import os

import numpy as np
import pytest
import torch

from sot_tpu_torch import cli
from sot_tpu_torch import data as tdata
from sot_tpu_torch.configs import get_experiment
from sot_tpu_torch.training import profiling
from sot_tpu_torch.training import trainer

TINY_KW = dict(n_samples=1024, cqt_fmin=261.6, batch_size=8, transform_n_fft=512,
               transform_hop=128)
TINY = [a for k, v in TINY_KW.items() for a in ("--set", f"{k}={v}")] + ["--dataset-size", "32"]

EVENTS = [
    # (cat, name, dur us)
    ("kernel", "void cqt_tile_kernel<(int)4>(float const*, float*)", 300.0),
    ("kernel", "void cqt_tile_kernel<(int)4>(float const*, float*)", 300.0),
    ("kernel", "synth_bwd_kernel(float const*, double*)", 80.0),
    ("kernel", "sm90_xmma_fprop_implicit_gemm_f32f32_tf32f32_f32_nhwckrsc_nchw", 120.0),
    ("kernel", "void regular_fft<(unsigned int)512>(float2*)", 40.0),
    ("kernel", "void at::native::vectorized_elementwise_kernel<4, at::native::AddFunctor<float>>",
     20.0),
    ("kernel", "some_unknown_kernel", 2.0),
    ("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 6.0),
    ("gpu_memset", "Memset (Device)", 4.0),
    ("cpu_op", "aten::add", 500.0),
    ("cuda_runtime", "cudaGraphLaunch", 50.0),
    ("gpu_user_annotation", "train step", 900.0),
]


def _write_trace(log_dir, events, gz=True):
    os.makedirs(log_dir, exist_ok=True)
    doc = {"traceEvents": [{"ph": "X", "cat": c, "name": n, "pid": 0, "tid": 7, "ts": i,
                            "dur": d} for i, (c, n, d) in enumerate(events)]
           + [{"ph": "M", "name": "process_name", "pid": 0, "args": {"name": "GPU 0"}}]}
    path = os.path.join(log_dir, "host.1.pt.trace.json" + (".gz" if gz else ""))
    with (gzip.open if gz else open)(path, "wt") as fh:
        json.dump(doc, fh)
    return path


def test_handwritten_kernels_are_read_from_the_sources():
    names = profiling.handwritten_kernels()
    sources = glob.glob(os.path.join(os.path.dirname(os.path.dirname(profiling.__file__)),
                                     "csrc", "*.cu"))
    assert len(sources) == 7 and len(names) >= 11
    assert {"cqt_tile_kernel", "conv_dw_reduce_kernel"} <= set(names)
    assert profiling.kernel_origin("void cqt_tile_kernel<(int)4>(float const*)") == \
        "csrc (hand-written)"
    assert profiling.kernel_origin("void cudnn::winograd_nonfused::x(float)") == \
        "cuDNN/cuBLAS/cuFFT"
    assert profiling.kernel_origin("void at::native::reduce_kernel<512, 1>") == "PyTorch"
    assert profiling.kernel_origin("mystery") == "other"


@pytest.mark.parametrize("gz", [True, False])
def test_summaries_of_a_written_trace(tmp_path, gz):
    log_dir = str(tmp_path / "trace")
    _write_trace(log_dir, EVENTS, gz=gz)
    steps = 2
    by_cat = dict(profiling.summarize_trace_by_category(log_dir, steps=steps))
    assert by_cat == pytest.approx({"kernel: csrc (hand-written)": 0.34,
                                    "kernel: cuDNN/cuBLAS/cuFFT": 0.08,
                                    "kernel: PyTorch": 0.01, "kernel: other": 0.001,
                                    "gpu_memcpy": 0.003, "gpu_memset": 0.002})
    top = profiling.summarize_trace(log_dir, top=3, steps=steps)
    assert [name for name, _ in top] == [
        "[kernel: csrc (hand-written)] void cqt_tile_kernel<(int)4>(float const*, float*)",
        "[kernel: cuDNN/cuBLAS/cuFFT] sm90_xmma_fprop_implicit_gemm_f32f32_tf32f32_f32_"
        "nhwckrsc_nchw",
        "[kernel: csrc (hand-written)] synth_bwd_kernel(float const*, double*)"]
    assert [ms for _, ms in top] == pytest.approx([0.3, 0.06, 0.04])
    assert len(profiling.summarize_trace(log_dir, steps=steps)) == 8


def test_print_trace_summary_layout(tmp_path, capsys):
    log_dir = str(tmp_path / "trace")
    _write_trace(log_dir, EVENTS)
    profiling.print_trace_summary(log_dir, steps=2, top=4)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "# by device category:"
    assert lines[1] == "   0.340 ms/step  kernel: csrc (hand-written)"
    cut = lines.index("# top ops:")
    # categories under 0.005 ms/step are left out, as JAX leaves them
    assert len(lines[1:cut]) == 3
    assert lines[cut + 1].startswith("   0.300 ms/step  [kernel: csrc (hand-written)] void cqt")
    assert len(lines) - cut - 1 == 4
    assert not any(line.lstrip().startswith("0.000") for line in lines)


SPAN_EVENTS = [
    # (cat, name, ts us, dur us): a chunk of 2 steps, its upload partly
    # drained into, its replays over one long kernel
    ("user_annotation", "sot.train.chunk", 0.0, 1000.0),
    ("user_annotation", "sot.train.upload", 0.0, 100.0),
    ("user_annotation", "sot.train.replays", 100.0, 900.0),
    ("user_annotation", "not.a.program.span", 0.0, 500.0),
    ("gpu_user_annotation", "sot.train.replays", 150.0, 800.0),
    ("cpu_op", "aten::copy_", 10.0, 80.0),
    ("kernel", "step", 50.0, 30.0),
    ("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 60.0, 10.0),
    ("kernel", "step", 150.0, 800.0),
]


@pytest.mark.parametrize("device", [True, False])
def test_program_spans_of_a_written_trace(tmp_path, capsys, device):
    """The ``# program spans`` table: count, host ms and device-idle ms a
    step inside each of the port's spans (the device's intervals unioned
    within the span); "not measured" where the trace saw no device."""
    log_dir = str(tmp_path / "trace")
    events = [e for e in SPAN_EVENTS if device or e[0] not in profiling.DEVICE_CATEGORIES]
    os.makedirs(log_dir)
    with gzip.open(os.path.join(log_dir, "host.1.pt.trace.json.gz"), "wt") as fh:
        json.dump({"traceEvents": [{"ph": "X", "cat": c, "name": n, "pid": 0, "tid": 7,
                                    "ts": ts, "dur": d} for c, n, ts, d in events]}, fh)
    rows = profiling.summarize_spans(log_dir, steps=2)
    assert [r[:2] for r in rows] == [("sot.train.chunk", 1), ("sot.train.upload", 1),
                                     ("sot.train.replays", 1)]
    assert [r[2] for r in rows] == pytest.approx([0.5, 0.05, 0.45])
    if device:
        assert [r[3] for r in rows] == pytest.approx([0.085, 0.035, 0.05])
    else:
        assert [r[3] for r in rows] == [None] * 3
    profiling.print_trace_summary(log_dir, steps=2)
    lines = capsys.readouterr().out.splitlines()
    cut = lines.index("# program spans (count, host ms/step, device-idle ms/step inside):")
    idle = ["0.085", "0.035", "0.050"] if device else ["not measured"] * 3
    assert lines[cut + 1:] == [
        f"{1:6d} {host:8.3f} {gap:>12}  {name}" for (name, _, host, _), gap in zip(rows, idle)]
    assert (lines[0] == "# by device category:") == device


def test_no_trace_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="no .pt.trace.json"):
        profiling.summarize_trace(str(tmp_path))


def test_trace_of_two_cpu_steps(tmp_path, capsys):
    cfg = get_experiment("SOT-2048", **TINY_KW, dataset_size=32)
    x_all = torch.as_tensor(tdata.peak_normalize(
        tdata.dataset_from_config(cfg, device="cpu")["train"].x))
    mod = trainer.build_modules(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    state = trainer.init_state(mod)
    log_dir = str(tmp_path / "trace")
    with profiling.trace(log_dir):
        trainer.train_steps(mod, state, x_all, [0, 8])
    files = glob.glob(os.path.join(log_dir, "*.pt.trace.json.gz"))
    assert len(files) == 1
    with gzip.open(files[0], "rt") as fh:
        events = json.load(fh)["traceEvents"]
    assert any(e.get("cat") == "cpu_op" and e.get("name") == "aten::conv1d" for e in events)
    assert profiling.summarize_trace(log_dir, steps=2) == []
    assert profiling.summarize_trace_by_category(log_dir, steps=2) == []
    profiling.print_trace_summary(log_dir, steps=2)
    assert capsys.readouterr().out == \
        "# the trace holds no device events: device time not measured\n"


def test_cli_train_profile_on_cpu(tmp_path, capsys):
    out = str(tmp_path / "run")
    assert cli.main(["train", "--experiment", "SOT-2048", "--profile", "--steps", "2",
                     "--eval-every", "2", "--out", out, "--device", "cpu"] + TINY) == 0
    text = capsys.readouterr().out
    trace_dir = os.path.join(out, "trace")
    assert f"# device trace -> {trace_dir} (top ops, ms/step):" in text
    assert "device time not measured" in text
    assert len(glob.glob(os.path.join(trace_dir, "*.pt.trace.json.gz"))) == 1
    with open(os.path.join(out, "log.jsonl")) as fh:
        records = [json.loads(line) for line in fh]
    assert [r["split"] for r in records] == ["train", "val"]
    assert np.isfinite(records[0]["loss/total"])
