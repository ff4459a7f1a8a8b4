"""The gated train step as a whole: ``KernelGates`` and the SOT-2048 step
with the ``full`` merge route (kernel B8), the STFT frontend (B9) and the
conv kernels (B10/B11, bf16 operands) against the JAX package's step with
the matching env gates, in interpret mode.

  * the gates: presets, validation, and the route each gives
  * ``tests/test_kernel_gate_train_step.py``'s tiny setup (hop 128, T =
    1024, so the frontend engages): compute_loss in eval mode (dropout
    cannot draw JAX's masks), its loss terms and each term's gradient per
    parameter leaf against JAX's; one train step in train mode runs
  * the golden ``sot2048_seed42_trainstep_gated.npz`` (full size, the
    committed seed-42 weights, 16 clips) against the port on the CPU, with
    the limits of ``chip_smoke.py``'s [train-golden-gated] phase (stated
    there: one SOT row's quantile cap moves between the two packages' CDF
    sums, and the full route's gradient of that row with it)

Tolerances: losses rel <= 1e-4; gradients max|d|/max per leaf. With f32
conv operands, 2e-2 for every term (``tests/test_torch_train.py``'s SOT
bound; measured at most 6.2e-3 at the tiny setup). With bf16 operands (the
JAX package's default) both packages round the same operands the same way,
but their f32 sums run in another order, so an activation within an ulp of
a bf16 rounding boundary rounds to its neighbour in one package and not
the other; the MSS term, an L1 distance whose gradient sign flips wherever
target and estimate agree to within rounding, amplifies those flips
(measured 1.64e-1 on conv4b's 3-element bias at the tiny setup, 5.3e-3
with f32 operands; the same leaf moves by 1.8e-2 when only the port's own
bf16 convs sum their channels in reverse order), so there the MSS limit is
2.5e-1 and the SOT term and the total keep 2e-2.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from sot_tpu.configs import get_experiment as jax_get_experiment  # noqa: E402
from sot_tpu.training import trainer as jtrainer  # noqa: E402
from sot_tpu_torch.configs import get_experiment  # noqa: E402
from sot_tpu_torch.convert import flat_from_tree, params_to_flax  # noqa: E402
from sot_tpu_torch.kernel_gates import PRESETS, KernelGates, auto_gates, resolve_gates  # noqa: E402
from sot_tpu_torch.models.encoder import F32Conv1d, KernelConv1d  # noqa: E402
from sot_tpu_torch.ops import wasserstein as tw  # noqa: E402
from sot_tpu_torch.ops.kernels import conv as kconv  # noqa: E402
from sot_tpu_torch.ops.kernels import merge as kmerge  # noqa: E402
from sot_tpu_torch.ops.kernels import stft as kstft  # noqa: E402
from sot_tpu_torch.training import trainer as ttrainer  # noqa: E402
from tests import _torch_golden_gated  # noqa: E402
from test_torch_train import JAX_AUTO, TERMS, _check_terms, _port_term_grads  # noqa: E402

GATED = KernelGates(w2_merge="full", conv=True, stft_frontend=True)
JAX_GATES = {k: v for k, v in _torch_golden_gated.GATES.items() if k != "SOT_TPU_MERGE_ROWS"}
LIMITS = {torch.float32: {"w1d": 2e-2, "mss": 2e-2, "total": 2e-2},
          torch.bfloat16: {"w1d": 2e-2, "mss": 2.5e-1, "total": 2e-2}}


def test_kernel_gates_presets_and_routes():
    assert resolve_gates("default") == KernelGates() == PRESETS["default"]
    assert resolve_gates("auto") == auto_gates() == PRESETS["auto"]
    assert resolve_gates(GATED) is GATED
    for gates, small, large in ((JAX_AUTO, "hybrid", "ref"), ("default", "plane", "plane"),
                                (GATED, "full", "full"),
                                (KernelGates(w2_merge="off", w2_merge_small="full"), "full",
                                 "plane")):
        assert (tw.w2_route(257, gates), tw.w2_route(1025, gates)) == (small, large)
    assert GATED.conv_dtype == torch.bfloat16 and not JAX_AUTO.conv
    with pytest.raises(ValueError, match="kernels must be"):
        resolve_gates("full")
    with pytest.raises(ValueError, match="w2_merge"):
        KernelGates(w2_merge="on")
    with pytest.raises(ValueError, match="w2_merge_small"):
        KernelGates(w2_merge_small="off ")
    with pytest.raises(ValueError, match="conv_dtype"):
        KernelGates(conv_dtype=torch.float16)


def test_build_modules_threads_the_gates():
    """Every gate reaches its module, and the default build keeps the
    encoder's parameters: its k = 15 convs are the f32 route's
    ``F32Conv1d`` (an ``nn.Conv1d``)."""
    cfg = get_experiment("SOT-2048")
    mod = ttrainer.build_modules(cfg, device="cpu", kernels=GATED)
    assert mod.kernels is GATED
    assert isinstance(mod.encoder.conv1, KernelConv1d) and mod.encoder.conv1.compute_dtype \
        == torch.bfloat16
    assert mod.transform.kernels is GATED
    assert all(fn.kernels is GATED for _, fn, _ in mod.loss_fns)
    plain = ttrainer.build_modules(cfg, device="cpu")
    assert plain.kernels == PRESETS["auto"]
    assert isinstance(plain.encoder.conv1, KernelConv1d) is PRESETS["auto"].conv
    conv1 = ttrainer.build_modules(cfg, device="cpu", kernels="default").encoder.conv1
    assert type(conv1) is F32Conv1d and isinstance(conv1, torch.nn.Conv1d)
    assert plain.encoder.state_dict().keys() == mod.encoder.state_dict().keys()


def _tiny_cfg(get):
    cfg = get("SOT-2048", batch_size=16, cqt_fmin=261.6, transform_n_fft=512,
              transform_hop=128, n_samples=1024)
    return cfg.replace(losses=tuple(
        dataclasses.replace(lc, fft_sizes=(512, 256)) if lc.kind == "mss" else lc
        for lc in cfg.losses))


def _tiny_audio(batch=16, t=1024, seed=0):
    """Peak-normalised harmonic tones with random f0 and amplitudes."""
    rng = np.random.default_rng(seed)
    f0 = rng.uniform(280.0, 1500.0, (batch, 1, 1))
    amps = rng.uniform(0.0, 1.0, (batch, 5, 1)) * (rng.random((batch, 5, 1)) < 0.7)
    k = np.arange(1, 6)[None, :, None]
    tt = np.arange(t)[None, None, :] / 16000.0
    x = np.sum(amps * np.sin(2 * np.pi * f0 * k * tt), axis=1)
    x /= np.abs(x).max(-1, keepdims=True) + 1e-9
    return x.astype(np.float32)


def _set_jax_gates(monkeypatch, conv_dtype):
    for k in ("SOT_TPU_W2_MERGE_SMALL", "SOT_TPU_CQT_PALLAS", "SOT_TPU_CONV_BF16",
              "SOT_TPU_DFT_MATMUL", "SOT_TPU_MERGE_ROWS"):
        monkeypatch.delenv(k, raising=False)
    for k, v in JAX_GATES.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("SOT_TPU_CONV_DTYPE", str(conv_dtype).replace("torch.", ""))


@pytest.mark.parametrize("conv_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_gated_step_matches_jax_at_the_tiny_setup(monkeypatch, conv_dtype):
    """The gated compute_loss (eval mode) against JAX's gated one, each
    kernel of the path engaged; then one gated train step in train mode."""
    _set_jax_gates(monkeypatch, conv_dtype)
    cfg = _tiny_cfg(get_experiment)
    x = _tiny_audio()
    gates = dataclasses.replace(GATED, conv_dtype=conv_dtype)
    mod = ttrainer.build_modules(cfg, device="cpu", generator=torch.Generator().manual_seed(0),
                                 kernels=gates)
    params = params_to_flax(mod.encoder.state_dict())
    port, _ = _port_term_grads(mod, x)

    jmod = jtrainer.build_modules(_tiny_cfg(jax_get_experiment))

    @jax.jit
    def jax_terms(p):
        def term(name):
            def fn(pp):
                _, (logs, _) = jtrainer.compute_loss(jmod, pp, jnp.asarray(x), train=False)
                return logs[name]
            return fn
        return {tag: jax.value_and_grad(term(name))(p) for tag, name in TERMS.items()}

    ref = {tag: (float(v), flat_from_tree(jax.tree.map(np.asarray, g)["params"]))
           for tag, (v, g) in jax_terms(jax.tree.map(jnp.asarray, params)).items()}
    _check_terms(port, ref, LIMITS[conv_dtype])

    # the same step on the port's path: one train step with every gate on
    state = ttrainer.init_state(mod)
    before = [p.detach().clone() for p in mod.encoder.parameters()]
    logs = ttrainer.train_steps(mod, state, torch.from_numpy(x), [0])
    assert all(bool(torch.isfinite(v)) for v in logs.values())
    assert any(not torch.equal(p, q) for p, q in zip(mod.encoder.parameters(), before))


def test_gated_path_reaches_every_kernel_wrapper(monkeypatch):
    """On the CPU the wrappers run their plain versions; counted here
    through the wrappers' entry points: the conv forward and weight
    gradient, the frontend and the coupling gradient each run in a gated
    step, and not in a JAX_AUTO step."""
    calls = {"conv": 0, "dw": 0, "stft": 0, "b8": 0}

    def counted(name, fn):
        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapper

    monkeypatch.setattr(kconv, "conv1d_forward", counted("conv", kconv.conv1d_forward))
    monkeypatch.setattr(kconv, "conv1d_weight", counted("dw", kconv.conv1d_weight))
    monkeypatch.setattr(kstft, "stft_frontend_kernel", counted("stft", kstft.stft_frontend_kernel))
    monkeypatch.setattr(tw, "coupling_grads", counted("b8", kmerge.coupling_grads))
    cfg = _tiny_cfg(get_experiment)
    x = torch.from_numpy(_tiny_audio(batch=2, seed=1))
    for kernels, expect in ((JAX_AUTO, {"conv": 0, "dw": 0, "stft": 0, "b8": 0}),
                            # conv1 + prefilt forward and dx; their dW; the loss
                            # STFT and MSS 512/128 of x and x_hat; one coupling
                            (GATED, {"conv": 4, "dw": 2, "stft": 4, "b8": 1})):
        calls.update(dict.fromkeys(calls, 0))
        mod = ttrainer.build_modules(cfg, device="cpu", kernels=kernels)
        ttrainer.compute_loss(mod, x)[0].backward()
        assert calls == expect, (kernels, calls)


def test_port_matches_the_gated_golden_on_cpu():
    """Batch 16 at full size against ``sot2048_seed42_trainstep_gated.npz``
    (JAX with the gates of this path in interpret mode): ``chip_smoke.py``'s
    [train-golden-gated] phase on the CPU, with its limits. Kernel 8 on the
    golden's 128 real rows against JAX's merge-gradient kernel (its last,
    shaved column exactly 0); the full route end to end on JAX's own spectra
    per row wherever the quantile cap agrees; the loss and both terms within
    1e-4; each term's gradient per leaf within GRAD_LIMITS_GATED and
    LEAF_COSINE_GATED; and every wrong-gradient control rejected."""
    import chip_smoke

    with np.load(_torch_golden_gated.GOLDEN) as z:
        assert "SOT_TPU_W2_MERGE=1" in str(z["gates"]) and "SOT_TPU_CONV_PALLAS=1" in str(z["gates"])
    chip_smoke.check_train_golden(
        get_experiment("SOT-2048"), torch.device("cpu"), chip_smoke.GOLDEN_GATED,
        chip_smoke.GOLDEN, (chip_smoke.GRAD_LIMITS_GATED, chip_smoke.LEAF_COSINE_GATED),
        "train-golden-gated", GATED)
