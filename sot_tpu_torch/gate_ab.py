"""On-card A/Bs of the gated kernels, written for ``kernel_gates.auto_gates``
(the port's ``scripts/bench_{sot,refgrad,conv,mss}_ab.py``):

    python -m sot_tpu_torch.gate_ab [--out DIR] [--device cpu] [--iters 8]

writes six files into ``--out`` (default ``kernel_gates.ADOPTION_DIR``) in
the JAX package's schema (``device``, the shape keys, ``k``, ``iters``,
``{variant: {fwd_ms, grad_ms}}``, ``parity: {max_rel, ok}`` where the JAX
script has one, ``complete``):

  * ``sot_ab.json`` / ``sot_ab_512.json`` — the same-grid W2 loss of the
    SOT-2048 / SOT-512 train step (1024 rows x 1025 / 257 bins; u the
    spectra of other random clips, v the target's): ``plane`` (kernels
    B6 + B7) against ``merge`` (``full``: B4 + B8), ``hybrid`` (B4 + B7)
    recorded too;
  * ``refgrad_ab.json`` / ``refgrad_ab_512.json`` — ``hybrid`` (B4 + B7)
    against ``ref`` (B4 + B5), with the gradient parity of the two on one
    slice (max|d| / max|hybrid| < 1e-4, the JAX script's limit);
  * ``conv_ab.json`` — the PESTO encoder's forward and its gradient to the
    input and every parameter on [1024, 285] frames: ``xla`` (the default
    encoder: on the card the f32 conv kernels of ``csrc/conv_f32.cu`` for
    the k = 15 convs, cuDNN f32 with TF32 off for the 1x1 convs; the
    committed file was measured when cuDNN ran them all) against ``pallas``
    (kernels B10/B11, ``conv_dtype=float32``, 3xTF32), ``pallas_bf16``
    beside it for information;
  * ``mss_ab.json`` — the six-scale MSS loss on 64 x 4096 clips and its
    gradient to the estimate: ``fft`` (cuFFT) against ``dft_matmul``,
    ``pallas`` (kernel B9) and ``pallas+dft``.

Each variant's K calls on K distinct inputs (the JAX scripts scan K slices
in one jitted call) are captured in one CUDA graph, its K gradient calls
in another; each graph is replayed ``iters`` times between CUDA events and
the median divided by K. ``device`` holds the card's name and power limit
(``nvidia-smi``). Runs on the GPU unless ``--device cpu`` asks for the CPU
(host-clock times of the plain kernels, for checking the files' form); a
CPU run is refused into ``ADOPTION_DIR``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence

import torch

from sot_tpu_torch.device import card_line
from sot_tpu_torch.kernel_gates import ADOPTION_DIR, KernelGates

SOT_VARIANTS = {"plane": KernelGates(), "merge": KernelGates(w2_merge="full"),
                "hybrid": KernelGates(w2_merge="hybrid"), "ref": KernelGates(w2_merge="ref")}
CONV_VARIANTS = {"xla": None, "pallas": torch.float32, "pallas_bf16": torch.bfloat16}
MSS_VARIANTS = {"fft": KernelGates(), "dft_matmul": KernelGates(dft_matmul=True),
                "pallas": KernelGates(stft_frontend=True),
                "pallas+dft": KernelGates(stft_frontend=True, dft_matmul=True)}
REFGRAD_PARITY_LIMIT = 1e-4   # the JAX script's: the conventions are identical
# (file, what it times, n_fft of the loss STFT, K)
AB_FILES = (("sot_ab.json", "sot", 2048, 16), ("sot_ab_512.json", "sot", 512, 16),
            ("refgrad_ab.json", "refgrad", 2048, 16), ("refgrad_ab_512.json", "refgrad", 512, 16),
            ("conv_ab.json", "conv", None, 8), ("mss_ab.json", "mss", None, 8))
CONV_BINS, CONV_CHANNELS, CONV_KERNEL = 285, 40, 15


def graph_ms(fn: Callable, inputs: Sequence, iters: int, device: torch.device) -> float:
    """ms per call of ``fn`` over the distinct ``inputs``: on the GPU the K
    calls captured as one CUDA graph (after two eager passes on a side
    stream, which build the kernels and fill the host caches), the graph
    replayed ``iters`` times between CUDA events, the median over K; on the
    CPU the median host-clock pass over K."""
    times: List[float] = []
    if device.type != "cuda":
        for _ in range(iters):
            t0 = time.perf_counter()
            for x in inputs:
                fn(x)
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times) / len(inputs)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            for x in inputs:
                fn(x)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outputs = [fn(x) for x in inputs]
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(iters):
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    del outputs  # the replays wrote them; the graph keeps its pool
    return statistics.median(times) / len(inputs)


def sot_data(device: torch.device, k: int, n_fft: int, clips: int):
    """(grid, [u_1..u_K], v): the loss STFT's spectra, rows of clips x
    frames, of K random datasets (seeds 100 + i) and of the target's (seed
    0), as ``scripts/bench_sot_ab.py:build_data`` makes them."""
    from sot_tpu_torch import data as data_lib
    from sot_tpu_torch.ops.stft import stft_magnitude

    def spectra(seed: int) -> torch.Tensor:
        signals, _, _ = data_lib.generate_sinusoid_dataset(
            seed=seed, size=clips, n_samples=4096, render_batch=clips, device=device)
        x = torch.as_tensor(data_lib.peak_normalize(signals), device=device)
        s = stft_magnitude(x, size=n_fft, overlap=1 - 256 / n_fft, window="flattop")
        return s.reshape(-1, s.shape[-1]).contiguous()

    v = spectra(0)
    us = [spectra(100 + i) for i in range(k)]
    return torch.linspace(0.0, 1.0, v.shape[-1], device=device), us, v


def sot_fns(grid: torch.Tensor, v: torch.Tensor, gates: KernelGates):
    """The training loss's rows (constant target first), as a forward sum
    and as its gradient to the estimate."""
    from sot_tpu_torch.ops.wasserstein import wasserstein_same_grid

    def rows(u):
        return wasserstein_same_grid(grid, v, u, p=2.0, limit_quantile_range=True,
                                     target_constant=True, kernels=gates)

    def fwd(u):
        return torch.sum(rows(u))

    def grad(u):
        u = u.detach().requires_grad_(True)
        return torch.autograd.grad(torch.sum(rows(u)), u)[0]

    return fwd, grad


def refgrad_parity(grid: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> Dict[str, object]:
    """``ref``'s gradient against ``hybrid``'s on one slice, kinks included:
    max|d| / max|hybrid| (``scripts/bench_refgrad_ab.py``)."""
    g_ref = sot_fns(grid, v, SOT_VARIANTS["ref"])[1](u)
    g_hyb = sot_fns(grid, v, SOT_VARIANTS["hybrid"])[1](u)
    scale = float(g_hyb.abs().max()) + 1e-12
    max_rel = float((g_ref - g_hyb).abs().max()) / scale
    return {"max_rel": max_rel, "ok": max_rel < REFGRAD_PARITY_LIMIT}


def encoder(device: torch.device, conv_dtype):
    """The PESTO encoder on [rows, 285] frames in eval mode, weights from
    seed 0 whatever ``conv_dtype`` (None: the default encoder, whose k = 15
    convs take the f32 kernels on the GPU; else kernels B10/B11 with that
    operand type)."""
    from sot_tpu_torch.models.encoder import PESTOEncoder

    return PESTOEncoder(n_bins_in=CONV_BINS, output_size=CONV_BINS,
                        generator=torch.Generator().manual_seed(0),
                        conv_dtype=conv_dtype).to(device).eval()


def conv_fns(device: torch.device, conv_dtype):
    """The sum of the encoder's outputs, and its gradient to the input and
    every parameter."""
    enc = encoder(device, conv_dtype)
    params = list(enc.parameters())

    def head(x):
        return sum(torch.sum(o) for o in enc(x).values())

    def grad(x):
        x = x.detach().requires_grad_(True)
        return torch.autograd.grad(head(x), [x] + params)

    return head, grad


def mss_fns(gates: KernelGates):
    """The six-scale MSS loss (mag and log-mag weight 1) of a (target,
    estimate) pair, and its gradient to the estimate."""
    from sot_tpu_torch.losses import MSSLoss

    loss = MSSLoss(mag_weight=1.0, logmag_weight=1.0, kernels=gates)

    def fwd(pair):
        return loss(*pair)

    def grad(pair):
        y = pair[1].detach().requires_grad_(True)
        return torch.autograd.grad(loss(pair[0], y), y)[0]

    return fwd, grad


def measure(kind: str, device: torch.device, n_fft=None, k: int = 16, iters: int = 8,
            clips: int = 64) -> Dict[str, object]:
    """One A/B file's contents (without ``complete``)."""
    gen = torch.Generator(device="cpu").manual_seed(1)
    res: Dict[str, object] = {"device": card_line(device)}

    def timed(fwd, grad, inputs):
        return {"fwd_ms": graph_ms(fwd, inputs, iters, device),
                "grad_ms": graph_ms(grad, inputs, iters, device)}

    if kind in ("sot", "refgrad"):
        grid, us, v = sot_data(device, k, n_fft, clips)
        res.update(rows=int(v.shape[0]), bins=int(v.shape[1]), k=k, iters=iters)
        if kind == "refgrad":
            res["parity"] = refgrad_parity(grid, us[0], v)
        for name in ("plane", "merge", "hybrid") if kind == "sot" else ("hybrid", "ref"):
            res[name] = timed(*sot_fns(grid, v, SOT_VARIANTS[name]), us)
    elif kind == "conv":
        rows = clips * 16
        xs = [torch.randn(rows, CONV_BINS, generator=gen).to(device) for _ in range(k)]
        res.update(rows=rows, bins=CONV_BINS, channels=CONV_CHANNELS, kernel_size=CONV_KERNEL,
                   k=k, iters=iters)
        for name in CONV_VARIANTS:
            res[name] = timed(*conv_fns(device, CONV_VARIANTS[name]), xs)
    elif kind == "mss":
        pairs = [(torch.randn(clips, 4096, generator=gen).to(device),
                  torch.randn(clips, 4096, generator=gen).to(device)) for _ in range(k)]
        res.update(batch=clips, samples=4096, k=k, iters=iters)
        for name in MSS_VARIANTS:
            res[name] = timed(*mss_fns(MSS_VARIANTS[name]), pairs)
    else:
        raise ValueError(f"unknown A/B kind {kind!r}")
    return res


def write(out_dir: str, name: str, res: Dict[str, object]) -> None:
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, name), "w") as fh:
        json.dump(res, fh, indent=1)


def run(out_dir: str, device: torch.device, iters: int = 8, clips: int = 64,
        k: Optional[int] = None) -> Dict[str, Dict[str, object]]:
    """Every A/B file into ``out_dir``, with ``k`` distinct inputs (default:
    each file's); each is written once with ``complete: true`` after all its
    variants ran."""
    if device.type != "cuda" and os.path.realpath(out_dir) == os.path.realpath(ADOPTION_DIR):
        raise SystemExit(f"a CPU run is not written into {ADOPTION_DIR}; pass --out")
    out = {}
    for name, kind, n_fft, k_file in AB_FILES:
        res = measure(kind, device, n_fft=n_fft, k=k or k_file, iters=iters, clips=clips)
        res["complete"] = True
        write(out_dir, name, res)
        print(f"{name}: {json.dumps(res)}", flush=True)
        out[name] = res
    return out


def main(argv=None) -> int:
    from sot_tpu_torch.device import resolve_device, set_precision_policy

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=ADOPTION_DIR)
    ap.add_argument("--device", default=None, help="'cuda' (default; fails without a GPU) or 'cpu'")
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--clips", type=int, default=64,
                    help="clips a slice (64: the train step's batch; rows = clips x 16)")
    ap.add_argument("--k", type=int, default=None,
                    help="distinct inputs a variant (default: 16 SOT, 8 conv and MSS)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        set_precision_policy()
    run(args.out, device, iters=args.iters, clips=args.clips, k=args.k)
    return 0


if __name__ == "__main__":
    sys.exit(main())
