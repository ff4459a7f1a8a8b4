"""The served model as a CUDA graph: ``trainer.predict`` replays one
``PredictGraph`` per (input shape, octave_correction) on the GPU, and runs
the same body (``trainer._predict_body``) eagerly on the CPU.

On the CPU: ``predict`` equals the body called directly, bit for bit, with
and without each correction, and captures nothing; an in-place
``load_state_dict`` keeps the weights' addresses, which is what lets a
graph read reloaded weights, and a replaced parameter changes them. The
tests marked ``cuda`` need the card (``python -m pytest
tests/test_torch_serve_graph.py -m cuda --noconftest``): replays bit-equal
to the body under ``cudnn.deterministic`` on the three served routes,
outputs not aliased across requests, reloaded and replaced weights read by
the next replay, one capture per (shape, flag), and a dropped ``Modules``
freeing its graphs.
"""

from __future__ import annotations

import gc
import weakref

import numpy as np
import pytest
import torch

from sot_tpu_torch import data as tdata
from sot_tpu_torch.configs import get_experiment
from sot_tpu_torch.kernel_gates import KernelGates
from sot_tpu_torch.training import trainer

TINY = dict(n_samples=1024, cqt_fmin=261.6, transform_n_fft=512, transform_hop=128)
CORRECTIONS = {"none": {}, "octave": {"inference_octave_correction": True},
               "comb": {"inference_comb_correction": True}}
KEYS = ("pitch_hz", "pitch_unit", "weights", "x_hat", "frequency_logits")


def _clips(cfg, n: int, seed: int, device="cpu") -> np.ndarray:
    sig, _, _ = tdata.generate_sinusoid_dataset(seed=seed, size=n, n_samples=cfg.n_samples,
                                                render_batch=n, device=device)
    return tdata.peak_normalize(sig).astype(np.float32)


def _body(mod, x, octave_correction):
    with torch.inference_mode():
        return trainer._predict_body(mod, torch.as_tensor(x, device=mod.device),
                                     octave_correction)


def _equal(got, want) -> bool:
    return set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want)


@pytest.mark.parametrize("name", list(CORRECTIONS))
def test_predict_is_the_body_on_cpu(name):
    cfg = get_experiment("SOT-2048", **TINY, **CORRECTIONS[name])
    mod = trainer.build_modules(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    x = _clips(cfg, 6, seed=2)
    got = trainer.predict(mod, x)
    assert set(KEYS) <= set(got)
    assert _equal(got, _body(mod, x, cfg.inference_octave_correction))
    # the explicit flag, either way
    for flag in (False, True):
        assert _equal(trainer.predict(mod, torch.from_numpy(x), octave_correction=flag),
                      _body(mod, x, flag))
    assert mod.serve_graphs == {}


def test_predict_graph_needs_the_gpu():
    mod = trainer.build_modules(get_experiment("SOT-2048", **TINY), device="cpu")
    with pytest.raises(ValueError, match="needs the model on the GPU"):
        trainer.PredictGraph(mod, torch.zeros((2, 1024)), False)


def test_weight_addresses_follow_replacement_not_reloads():
    mod = trainer.build_modules(get_experiment("SOT-2048", **TINY), device="cpu")
    before = trainer._weight_addresses(mod)
    other = trainer.build_modules(get_experiment("SOT-2048", **TINY), device="cpu",
                                  generator=torch.Generator().manual_seed(5))
    mod.encoder.load_state_dict(other.encoder.state_dict())  # in place
    assert trainer._weight_addresses(mod) == before
    mod.encoder.load_state_dict(other.encoder.state_dict(), assign=True)  # new tensors
    assert trainer._weight_addresses(mod) != before
    # a Modules copy made by dataclasses.replace starts with no graphs of its own
    mod.serve_graphs[((1, 1), False)] = object()
    assert trainer.dataclasses.replace(mod).serve_graphs == {}


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

GATED = KernelGates(w2_merge="full", conv=True, stft_frontend=True)
# the SOT routes of the JAX package's committed gates (its ``auto``): ref
# above 512 bins, hybrid at or below; named so that what is held against
# JAX's records does not move with the port's adoption files
JAX_AUTO = KernelGates(w2_merge="ref", w2_merge_small="hybrid")
ROUTES = {"auto": (JAX_AUTO, {}),
          "auto-comb": (JAX_AUTO, {"inference_comb_correction": True}),
          "gated-octave": (GATED, {"inference_octave_correction": True})}


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA graph has no CPU mode)")


@pytest.fixture()
def deterministic():
    from sot_tpu_torch.device import set_precision_policy

    set_precision_policy()
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = old


def _served(route="auto"):
    """The route's Modules on the card with the SOT-2048 golden weights."""
    import chip_smoke

    kernels, override = ROUTES[route]
    mod = trainer.build_modules(get_experiment("SOT-2048", **override), device="cuda",
                                kernels=kernels)
    chip_smoke.load_golden_weights(mod)
    return mod


@pytest.mark.cuda
@pytest.mark.parametrize("route", list(ROUTES))
def test_replays_equal_the_body_on_card(route, deterministic):
    _need_cuda()
    mod = _served(route)
    for i in range(4):
        x = _clips(mod.config, 64, seed=100 + i, device="cuda")
        got = trainer.predict(mod, x)
        assert _equal(got, _body(mod, x, mod.config.inference_octave_correction)), i
    assert len(mod.serve_graphs) == 1


@pytest.mark.cuda
def test_outputs_are_not_aliased_on_card(deterministic):
    _need_cuda()
    mod = _served()
    xs = [_clips(mod.config, 64, seed=s, device="cuda") for s in (7, 8)]
    first = trainer.predict(mod, xs[0])
    second = trainer.predict(mod, torch.from_numpy(xs[1]).cuda())  # device-to-device
    for k in KEYS:
        assert first[k].data_ptr() != second[k].data_ptr(), k
    assert not torch.equal(first["pitch_hz"], second["pitch_hz"])
    assert _equal(first, _body(mod, xs[0], False)) and _equal(second, _body(mod, xs[1], False))


@pytest.mark.cuda
def test_reloaded_and_replaced_weights_are_read_on_card(deterministic):
    _need_cuda()
    import chip_smoke

    mod = _served()
    x = _clips(mod.config, 64, seed=9, device="cuda")
    before = trainer.predict(mod, x)
    graph = mod.serve_graphs[((64, mod.config.n_samples), False)]
    chip_smoke.load_golden_weights(mod, chip_smoke.GOLDEN_512)  # in place
    after = trainer.predict(mod, x)
    assert mod.serve_graphs[((64, mod.config.n_samples), False)] is graph
    assert not torch.equal(after["pitch_hz"], before["pitch_hz"])
    assert _equal(after, _body(mod, x, False))
    # a parameter replaced by a new tensor: the graph is dropped and captured again
    with torch.no_grad():
        mod.encoder.conv2.weight = torch.nn.Parameter(mod.encoder.conv2.weight * 0.5)
    replaced = trainer.predict(mod, x)
    assert mod.serve_graphs[((64, mod.config.n_samples), False)] is not graph
    assert _equal(replaced, _body(mod, x, False))


@pytest.mark.cuda
def test_one_capture_per_shape_and_flag_on_card(monkeypatch):
    _need_cuda()
    captures = []

    class Counting(trainer.PredictGraph):
        def __init__(self, mod, x, octave_correction):
            captures.append((tuple(x.shape), octave_correction))
            super().__init__(mod, x, octave_correction)

    monkeypatch.setattr(trainer, "PredictGraph", Counting)
    mod = _served()
    x64, x32 = (_clips(mod.config, n, seed=n, device="cuda") for n in (64, 32))
    for x, flag in ((x64, None), (x64, None), (x32, None), (x64, True), (x32, None),
                    (x64, False), (x64, True)):
        trainer.predict(mod, x, octave_correction=flag)
    t = mod.config.n_samples
    assert captures == [((64, t), False), ((32, t), False), ((64, t), True)]
    assert set(mod.serve_graphs) == set(captures)
    # Modules that differ only in config hold graphs of their own
    other = _served("auto-comb")
    trainer.predict(other, x64)
    assert captures[-1] == ((64, t), False) and len(captures) == 4
    assert other.serve_graphs[((64, t), False)] is not mod.serve_graphs[((64, t), False)]


@pytest.mark.cuda
def test_dropped_modules_free_their_graphs_on_card():
    _need_cuda()
    mod = _served()
    trainer.predict(mod, _clips(mod.config, 64, seed=1, device="cuda"))
    refs = [weakref.ref(mod)] + [weakref.ref(g) for g in mod.serve_graphs.values()]
    assert len(refs) == 2
    del mod
    gc.collect()
    assert [r() for r in refs] == [None, None]
