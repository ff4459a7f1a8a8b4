"""The general generator: one class per ``kind`` of traffic file, each
reading its parameters from the file. A new mix of an existing kind is a
new data file.

``train_epoch``: the configuration's train split (``train_share`` of the
dataset) made on the device from the seed and kept there, walked in epochs
of ``n_train // batch`` batches,
each epoch in a permutation drawn from the seed, through the program's
compiled train step (``train()``'s own call). Set-up drives the first
``check_steps`` updates one at a time, reading what the comparison needs,
and then the rest of the first epoch; the window runs whole epochs.

``closed_loop``: one client sends back-to-back requests of
``request_clips`` host clips each (float32 numpy, peak-normalised), taken in
turn from a pool of ``pool_requests`` distinct batches made at set-up from
the seed, through the program's ``predict``; a request ends when the
outputs that the model's comparison names (``OUTPUTS["host"]``) are in
host memory.

What belongs to the cell's model is found through ``cell.model``: the
weights' draw (its reference), a clip's frames (its counts), and a
request's outputs and the readings of the check (its comparison).

Each kind names the end-to-end quantities it measures (``REPORTS``); a
cell's end-to-end metrics are found among them by name
(``spec.quantity``).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench import inputs, trace

class Load:
    """Set-up, the window, the traced window and the comparison of a cell."""

    kind = ""
    REPORTS: tuple = ()
    clips_per_unit = 1

    def __init__(self, cell, seed: int, device: torch.device, program_cls):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.cfg, self.traffic, self.model = cell.config, cell.traffic, cell.model
        self.program_cls = program_cls
        self.program = None
        self.units = 0
        self.failed = 0
        self.phases: Dict[str, float] = {}
        self._mark = time.perf_counter()

    def mark(self, phase: str) -> None:
        """Record the seconds since the last mark under ``phase``."""
        self.sync()
        now = time.perf_counter()
        self.phases[phase] = now - self._mark
        self._mark = now

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def traced(self, seconds: float) -> List[dict]:
        """The traced window: the cell's work for ``seconds`` under the
        profiler; returns the trace's events (``units`` counts its work)."""
        self.sync()
        with trace.profiled() as result:
            with trace.span(trace.WINDOW):
                self.window(seconds, spans=True)
                self.sync()
        return result["events"]

    def release(self) -> None:
        self.program.close()
        self.program = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


class TrainEpoch(Load):
    kind = "train"
    REPORTS = ("train_frames_per_s",)

    def setup(self) -> None:
        cfg, dev = self.cfg, self.device
        self.batch = cfg["batch_size"]
        self.clips_per_unit = self.batch
        n_train = int(round(cfg["generator"]["dataset_size"] * self.traffic["train_share"]))
        self.x_all = inputs.clips(cfg, n_train, self.seed, "train", dev)
        self.steps_per_epoch = n_train // self.batch
        self.order = np.random.default_rng(inputs.sub_seed(self.seed, "order"))
        self.weights0 = inputs.weights(self.model.reference, cfg, self.seed, dev)
        self.dropout_seed = inputs.sub_seed(self.seed, "dropout")
        self.mark("inputs")
        self.program = self.program_cls(cfg, self.weights0, dev)
        self.program.start_training(self.x_all, self.dropout_seed)
        self.mark("model")

        # the first updates one at a time, through the window's own call
        epoch = self.order.permutation(self.steps_per_epoch) * self.batch
        k = self.traffic["check_steps"]
        self.check_offsets = [int(o) for o in epoch[:k]]
        self.losses: List[Dict[str, float]] = []
        self.first_moments = None
        for i, off in enumerate(self.check_offsets):
            logs = self.program.train([off])
            self.losses.append(self.program.loss_terms(logs))
            if i == 0:
                self.first_moments = self.program.adam_first_moments()
        self.params_after = self.program.params()
        self.mark("capture_and_first_steps")
        self.program.train(epoch[k:])
        self.mark("rest_of_epoch")

    def window(self, seconds: float, spans: bool = False) -> float:
        """Whole epochs until ``seconds`` have passed; at most one epoch is
        queued ahead of the one running. Returns the host-clock seconds."""
        self.sync()
        t0 = time.perf_counter()
        pending: Optional[torch.cuda.Event] = None
        while True:
            epoch = self.order.permutation(self.steps_per_epoch) * self.batch
            if spans:
                with trace.span(trace.UNIT):
                    self.program.train(epoch)
            else:
                self.program.train(epoch)
            self.units += len(epoch)
            if self.device.type == "cuda":
                done = torch.cuda.Event()
                done.record()
                if pending is not None:
                    pending.synchronize()
                pending = done
            if time.perf_counter() - t0 >= seconds:
                break
        self.sync()
        return time.perf_counter() - t0

    def metrics(self, seconds: float) -> Dict[str, float]:
        frames = self.units * self.batch * self.frames_per_clip()
        return {"train_frames_per_s": frames / seconds}

    def frames_per_clip(self) -> int:
        return self.model.counts.frames_per_clip(self.cfg)

    def check_batches(self) -> List[torch.Tensor]:
        return [self.x_all[o:o + self.batch] for o in self.check_offsets]

    def check(self) -> Dict[str, float]:
        # Adam's first moment after one update is (1 - beta1) times the gradient
        prog_grad = {k: v / 0.1 for k, v in self.first_moments.items()}
        return self.model.compare.train_readings(self.cfg, self.device, self.weights0,
                                                 self.check_batches(), self.dropout_seed,
                                                 self.losses, prog_grad, self.params_after)


class ClosedLoop(Load):
    kind = "serve"
    REPORTS = ("serve_clips_per_s", "serve_p95_ms")

    def setup(self) -> None:
        cfg, dev = self.cfg, self.device
        self.clips_per_unit = self.traffic["request_clips"]
        n = self.clips_per_unit * self.traffic["pool_requests"]
        x = inputs.clips(cfg, n, self.seed, "serve", dev)
        self.pool = [np.ascontiguousarray(b) for b in
                     x.cpu().numpy().reshape(-1, self.clips_per_unit, cfg["n_samples"])]
        del x
        self.weights0 = inputs.weights(self.model.reference, cfg, self.seed, dev)
        self.host_outputs = self.model.compare.OUTPUTS["host"]
        self.device_outputs = self.model.compare.OUTPUTS["device"]
        self.mark("inputs")
        self.program = self.program_cls(cfg, self.weights0, dev)
        self.mark("model")
        self.latencies: List[float] = []
        self.latest: Dict[int, Dict[str, object]] = {}
        for i in range(self.traffic["warmup_requests"]):
            self.request(i % len(self.pool))
            if i == 0:
                self.mark("capture")
        self.mark("warmup")
        self.latencies.clear()
        self.units = 0
        self.failed = 0

    def request(self, i: int) -> None:
        t0 = time.perf_counter()
        out = self.program.predict(self.pool[i])
        host = {k: out[k].cpu().numpy() for k in self.host_outputs}
        self.latencies.append(time.perf_counter() - t0)
        self.units += 1
        if not all(np.isfinite(v).all() for v in host.values()):
            self.failed += 1
        self.latest[i] = {**host, **{k: out[k] for k in self.device_outputs}}

    def window(self, seconds: float, spans: bool = False) -> float:
        self.sync()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            i = self.units % len(self.pool)
            if spans:
                with trace.span(trace.UNIT):
                    self.request(i)
            else:
                self.request(i)
        return time.perf_counter() - t0

    def metrics(self, seconds: float) -> Dict[str, float]:
        lat = np.asarray(self.latencies) * 1e3
        return {"serve_clips_per_s": self.units * self.clips_per_unit / seconds,
                "serve_p95_ms": float(np.percentile(lat, 95))}

    def sample(self) -> List[int]:
        """Pool batches to compare, drawn from the seed among those served."""
        served = sorted(self.latest)
        rng = np.random.default_rng(inputs.sub_seed(self.seed, "sample"))
        k = min(self.traffic["check_requests"], len(served))
        return sorted(rng.choice(served, size=k, replace=False).tolist())

    def check(self) -> Dict[str, float]:
        picks = self.sample()
        return self.model.compare.serve_readings(self.cfg, self.device, self.weights0,
                                                 [self.pool[i] for i in picks],
                                                 [self.latest[i] for i in picks])


KINDS = {"train_epoch": TrainEpoch, "closed_loop": ClosedLoop}
