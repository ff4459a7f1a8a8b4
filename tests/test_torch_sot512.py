"""The SOT-512 family slice as a whole: ``compute_loss`` and its gradients
for SOT-512 and SOT-512-LogF, the SOT-512 golden, evaluation and the
log-mapped loss grid, of the port against ``sot_tpu``.

Loss and gradient parity run in eval mode with the committed SOT-512 seed-42
weights (``sot_tpu_torch/golden/sot512_seed42_trainstep.npz``). JAX runs its
default CPU path (no kernel gates: the dense XLA form, whose autodiff is
the plane convention), the port its ``auto`` route (``hybrid``: the merge
forward and the plane backward's plain versions). Tolerances are
``tests/test_torch_train.py``'s: losses rel <= 1e-4, the SOT term's
<= 3e-4 (at two clips a quantile cap that lands on another CDF value
between JAX's blocked f32 CDF sums and the port's float64 ones moves the
mean by 1.0e-4, ``tests/test_torch_sot.py``); gradients max|d|/max
per parameter leaf <= 3e-2 for the SOT term (the CPU reads up to 2.1e-2 on
the golden's frequency head) and <= 1.5e-1 for the MSS term and the total
(an L1 distance whose sign flips where target and estimate agree to within
rounding).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
from sot_tpu.configs import get_experiment as jax_get_experiment  # noqa: E402
from sot_tpu.training import trainer as jtrainer  # noqa: E402
from sot_tpu_torch import data as tdata  # noqa: E402
from sot_tpu_torch.configs import get_experiment  # noqa: E402
from sot_tpu_torch.convert import (flat_from_tree, flax_tree_from_flat,  # noqa: E402
                                   params_from_flax)
from sot_tpu_torch.kernel_gates import resolve_gates  # noqa: E402
from sot_tpu_torch.training import trainer as ttrainer  # noqa: E402
from tests import _torch_golden_sot512  # noqa: E402
from test_torch_train import JAX_AUTO, TERMS, _max_rel, _port, _port_term_grads  # noqa: E402

GRAD_LIMITS = {"w1d": 3e-2, "mss": 1.5e-1, "total": 1.5e-1}
LOSS_LIMITS = {"w1d": 3e-4, "mss": 1e-4, "total": 1e-4}


def _golden():
    with np.load(_torch_golden_sot512.GOLDEN) as z:
        return {k: z[k] for k in z.files}


def _params(g):
    return flax_tree_from_flat({k: v for k, v in g.items() if k.startswith("params/")})


@pytest.fixture(autouse=True)
def _no_gates(monkeypatch):
    for k in ("SOT_TPU_W2_MERGE", "SOT_TPU_W2_MERGE_SMALL", "SOT_TPU_SYNTH_PALLAS",
              "SOT_TPU_CQT_PALLAS", "SOT_TPU_CONV_BF16", "SOT_TPU_PALLAS_INTERPRET"):
        monkeypatch.delenv(k, raising=False)


@pytest.mark.parametrize("name", ["SOT-512", "SOT-512-LogF"])
def test_compute_loss_matches_jax(name):
    """Batch 2 of the golden's clips, the trained SOT-512 weights."""
    g = _golden()
    x = g["x"][:2]
    params = _params(g)
    mod = _port(params, get_experiment(name))
    assert mod.kernels == JAX_AUTO and len(mod.x_pos) == 257
    port, _ = _port_term_grads(mod, x)
    jmod = jtrainer.build_modules(jax_get_experiment(name))
    names = list(TERMS.values())

    def terms(p):
        _, (jlogs, _) = jtrainer.compute_loss(jmod, p, jnp.asarray(x))
        return jnp.stack([jlogs[t] for t in names])

    values, jac = jax.jit(lambda p: (terms(p), jax.jacrev(terms)(p)))(
        jax.tree.map(jnp.asarray, params))
    for i, tag in enumerate(TERMS):
        loss, grads = port[tag]
        ref_grads = flat_from_tree(jax.tree.map(lambda a, i=i: a[i], jac)["params"])
        assert abs(loss - float(values[i])) <= LOSS_LIMITS[tag] * abs(float(values[i])), tag
        errs = _max_rel(grads, ref_grads)
        worst = max(errs, key=errs.get)
        print(f"{name} {tag}: worst gradient {worst} {errs[worst]:.3e}")
        assert errs[worst] <= GRAD_LIMITS[tag], (tag, worst, errs)


def test_routes_give_one_loss_and_gradient():
    """JAX_AUTO (hybrid: merge forward) and ``default`` (plane: the plane
    forward) give the same SOT-512 loss within 1e-5 and the same gradient
    within 1e-5 of its max: the two forwards compute one function, the two
    backwards are one kernel."""
    g = _golden()
    x = g["x"][:2]
    state = params_from_flax(_params(g))
    out = {}
    for name, kernels in (("auto", JAX_AUTO), ("default", "default")):
        mod = ttrainer.build_modules(get_experiment("SOT-512"), device="cpu", kernels=kernels)
        mod.encoder.load_state_dict(state)
        sot = [fn for kind, fn, _ in mod.loss_fns if kind == "wasserstein"]
        gates = resolve_gates(kernels)
        assert mod.kernels == gates and [fn.kernels for fn in sot] == [gates]
        out[name] = _port_term_grads(mod, x)[0]["w1d"]
    (la, ga), (ld, gd) = out["auto"], out["default"]
    assert abs(la - ld) <= 1e-5 * abs(ld)
    assert max(_max_rel(ga, gd).values()) <= 1e-5


def test_chip_smoke_train_golden_512_phase_on_cpu():
    """``chip_smoke.py``'s [train-golden-512] phase on the CPU: the hybrid
    route's kernels on JAX's rows (kernel 7's plain version bit-equal to
    ``_pallas_bwd`` there), the losses, each term's gradient per leaf within
    the phase's limits, the composed check, and every control rejected."""
    cfg = get_experiment("SOT-512")
    chip_smoke.check_train_golden(cfg, torch.device("cpu"), chip_smoke.GOLDEN_512,
                                  chip_smoke.GOLDEN_512,
                                  (chip_smoke.GRAD_LIMITS_512, chip_smoke.LEAF_COSINE_512),
                                  "train-golden-512")


def test_chip_smoke_eval_512_phase_on_cpu():
    """``evaluate`` on the predict golden's 64 clips against JAX's
    ``evaluate`` (``chip_smoke.py`` [eval-512])."""
    chip_smoke.check_eval_512(get_experiment("SOT-512"), torch.device("cpu"))


def test_eval_all_is_the_mean_of_the_eval_steps():
    g = _golden()
    mod = _port(_params(g), get_experiment("SOT-512"))
    with np.load(chip_smoke.GOLDEN) as z:
        x, f0 = z["x"][:8], z["f0"][:8]
    xs, f0s = torch.from_numpy(x).reshape(2, 4, -1), torch.from_numpy(f0).reshape(2, 4, 1)
    step = ttrainer.make_eval_step(mod)
    steps = [step(a, b) for a, b in zip(xs, f0s)]
    both = ttrainer.make_eval_all(mod)(xs, f0s)
    assert set(both) == set(steps[0]) >= {"mse", "log_spectral_distance", "loss/total"}
    for k, v in both.items():
        assert float(v) == pytest.approx((float(steps[0][k]) + float(steps[1][k])) / 2, rel=1e-6)
    split = tdata.SplitArrays(x, f0, np.zeros((8, 1), np.float32))
    ev = ttrainer.evaluate(mod, step, split, batch_size=3)  # batches of 3, 3 and 2 clips
    assert set(ev) == set(both) and all(np.isfinite(v) for v in ev.values())
    # the corrections are ported (ROADMAP A1): the corrected eval step gives
    # the same metrics, its loss terms unchanged
    octcorr = ttrainer.build_modules(get_experiment("SOT-512", eval_octave_correction=True),
                                     device="cpu", kernels=JAX_AUTO)
    octcorr.encoder.load_state_dict(mod.encoder.state_dict())
    corrected = ttrainer.make_eval_step(octcorr)(xs[0], f0s[0])
    assert set(corrected) == set(steps[0])
    for k in ("loss/total", "mse", "log_spectral_distance"):
        assert float(corrected[k]) == float(steps[0][k])


def test_logf_grid_within_two_ulp_of_jax():
    """SOT-512-LogF's loss positions: the port's float32 ``log`` is
    correctly rounded, XLA's CPU ``log`` is 1 ulp off on 2 of the 256 rfft
    bins (812.5 and 3625 Hz), and the unit map carries that to 3 and 1 ulp
    of the positions there (1.79e-07). No ``log`` in PyTorch (float32,
    float64 rounded once, ``log2``) reproduces XLA's polynomial, so the
    positions are held within 2 ulp of 1.0, the top of their range, and
    stay sorted."""
    mod = ttrainer.build_modules(get_experiment("SOT-512-LogF"), device="cpu")
    ref = jtrainer.build_modules(jax_get_experiment("SOT-512-LogF")).x_pos
    assert np.max(np.abs(mod.x_pos - ref)) <= 2 * np.spacing(np.float32(1.0))
    assert np.count_nonzero(mod.x_pos != ref) <= 4
    assert np.all(np.diff(mod.x_pos) >= 0) and np.all(np.diff(ref) >= 0)
