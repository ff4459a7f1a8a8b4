"""The train-step slice as a whole: ``compute_loss`` and its gradients, the
optimizer and schedules, the train step and the data helpers of the port
against ``sot_tpu``.

Loss and gradient parity run in eval mode (dropout cannot draw JAX's masks;
``tests/test_e2e_parity.py`` does the same). Tolerances:
  * losses: rel <= 1e-4 (f32 forward through two frameworks' FFTs and
    sums, and the quantile cap's CDF rounding, ``tests/test_torch_sot.py``)
  * gradients, max|d|/max per parameter leaf: the SOT term <= 2e-2 (the
    cross-framework bound of ``tests/test_e2e_parity.py``); the MSS term
    and the total <= 1.5e-1, because the MSS term is an L1 distance whose
    gradient sign differs between any two implementations wherever target
    and estimate agree to within rounding (most bins of a trained model's
    spectra); the values measured are printed
  * Adam: the parameters' change over 3 updates from identical gradients
    within 1e-4 of its max (the two libraries round the moment arithmetic
    in other orders, and each update rounds to the parameter's ulp)
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from sot_tpu import data as jdata  # noqa: E402
from sot_tpu.configs import get_experiment as jax_get_experiment  # noqa: E402
from sot_tpu.training import trainer as jtrainer  # noqa: E402
from sot_tpu_torch import data as tdata  # noqa: E402
from sot_tpu_torch.configs import get_experiment  # noqa: E402
from sot_tpu_torch.convert import (flat_from_tree, flax_tree_from_flat,  # noqa: E402
                                   grads_to_flax, params_from_flax, params_to_flax)
from sot_tpu_torch.kernel_gates import KernelGates  # noqa: E402
from sot_tpu_torch.training import trainer as ttrainer  # noqa: E402
from tests import _torch_golden, _torch_golden_train  # noqa: E402

# the SOT routes of the JAX package's committed gates (its ``auto``): ref
# above 512 bins, hybrid at or below; named so that what is held against
# JAX's records does not move with the port's adoption files
JAX_AUTO = KernelGates(w2_merge="ref", w2_merge_small="hybrid")
GRAD_LIMITS = {"w1d": 2e-2, "mss": 1.5e-1, "total": 1.5e-1}
TERMS = {"total": "loss/total", "mss": "loss/MSSLoss", "w1d": "loss/Wasserstein1D"}


def _golden_params():
    with np.load(_torch_golden.GOLDEN) as z:
        return flax_tree_from_flat({k: z[k] for k in z.files})


def _port(params, cfg, kernels=None):
    """The port's modules for ``cfg`` on the CPU with JAX's ``params``, on
    ``kernels`` (default: JAX_AUTO)."""
    mod = ttrainer.build_modules(cfg, device="cpu", kernels=kernels or JAX_AUTO)
    mod.encoder.load_state_dict(params_from_flax(params))
    return mod


def _port_term_grads(mod, x, **kw):
    """({tag: (loss, {flax leaf path: gradient})}, logs) of the port's
    compute_loss."""
    _, (logs, _) = ttrainer.compute_loss(mod, torch.from_numpy(x), **kw)
    names, params = zip(*mod.encoder.named_parameters())
    out = {}
    for tag, term in TERMS.items():
        grads = torch.autograd.grad(logs[term], params, retain_graph=True)
        out[tag] = (float(logs[term].detach()),
                    flat_from_tree(params_to_flax(dict(zip(names, grads)))["params"]))
    return out, logs


def _max_rel(got, ref):
    return {k: float(np.abs(got[k] - ref[k]).max() / (np.abs(ref[k]).max() + 1e-30))
            for k in ref}


def _check_terms(port, ref, limits=GRAD_LIMITS):
    """port, ref: {tag: (loss, {leaf: grad})}; assert the loss within 1e-4
    and each leaf's max|d|/max within ``limits[tag]`` (the module's)."""
    for tag, (loss, grads) in port.items():
        ref_loss, ref_grads = ref[tag]
        assert abs(loss - ref_loss) <= 1e-4 * abs(ref_loss), (tag, loss, ref_loss)
        errs = _max_rel(grads, ref_grads)
        worst = max(errs, key=errs.get)
        print(f"{tag}: loss rel {abs(loss - ref_loss) / abs(ref_loss):.2e}, "
              f"worst gradient {worst} {errs[worst]:.3e}")
        assert errs[worst] <= limits[tag], (tag, worst, errs)


def test_compute_loss_matches_jax(monkeypatch):
    """Batch 2, trained weights, eval mode, the odd-ratio prior on: JAX's
    default CPU path (no kernel gates) against the port on the CPU."""
    for k in ("SOT_TPU_W2_MERGE", "SOT_TPU_SYNTH_PALLAS", "SOT_TPU_CQT_PALLAS",
              "SOT_TPU_CONV_BF16"):
        monkeypatch.delenv(k, raising=False)
    params = _golden_params()
    with np.load(_torch_golden_train.GOLDEN) as z:
        x = z["x"][:2]
    kw = dict(odd_ratio_prior_weight=0.1)
    port, logs = _port_term_grads(_port(params, get_experiment("SOT-2048", **kw)), x)
    jmod = jtrainer.build_modules(jax_get_experiment("SOT-2048", **kw))

    names = [*TERMS.values(), "loss/OddRatioPrior"]

    def terms(p):
        _, (jlogs, _) = jtrainer.compute_loss(jmod, p, jnp.asarray(x))
        return jnp.stack([jlogs[t] for t in names])

    # jit: one compiled program instead of thousands of eager dispatches
    values, jac = jax.jit(lambda p: (terms(p), jax.jacrev(terms)(p)))(
        jax.tree.map(jnp.asarray, params))
    ref = {tag: (float(values[i]),
                 flat_from_tree(jax.tree.map(lambda a, i=i: a[i], jac)["params"]))
           for i, tag in enumerate(TERMS)}
    _check_terms(port, ref)
    np.testing.assert_allclose(float(logs["loss/OddRatioPrior"].detach()), float(values[-1]),
                               rtol=1e-5)


def test_port_matches_the_train_step_golden_on_cpu():
    """Batch 16 against ``sot2048_seed42_trainstep.npz``: JAX with the
    shipped kernel gates in interpret mode (the chip smoke's train-golden
    phase, run here on the CPU)."""
    with np.load(_torch_golden_train.GOLDEN) as z:
        g = {k: z[k] for k in z.files}
    mod = _port(_golden_params(), get_experiment("SOT-2048"))
    port, _ = _port_term_grads(mod, g["x"], train=False)
    ref = {tag: (float(g[f"loss_{tag}"]),
                 {k[len(f"grad_{tag}/"):]: v for k, v in g.items()
                  if k.startswith(f"grad_{tag}/")})
           for tag in TERMS}
    _check_terms(port, ref)
    assert int(g["cap_rows"]) == 1024
    assert 0 <= int(g["cap_rows_jump"]) <= int(g["cap_rows_differ"]) <= 1024


def test_chip_smoke_train_golden_phase_on_cpu():
    """``chip_smoke.py``'s [train-golden] phase on the CPU: the SOT kernels on
    JAX's own rows, the losses, each term's gradient per leaf, the composed
    check, and every control rejected by one of those gates."""
    import chip_smoke

    chip_smoke.check_train_golden(get_experiment("SOT-2048"), torch.device("cpu"))


def test_build_modules_matches_jax():
    for name in ("SOT-2048", "SOT-512-LogF", "MSS-Lin"):
        mod = ttrainer.build_modules(get_experiment(name), device="cpu")
        jmod = jtrainer.build_modules(jax_get_experiment(name))
        if jmod.x_pos is None:
            assert mod.x_pos is None
        else:
            np.testing.assert_allclose(mod.x_pos, jmod.x_pos, rtol=1e-6, atol=1e-7)
            assert bool(np.all(np.diff(mod.x_pos) >= 0)) == bool(np.all(np.diff(jmod.x_pos) >= 0))
        assert [(k, type(f).__name__, w) for k, f, w in mod.loss_fns] == \
            [(k, type(f).__name__, w) for k, f, w in jmod.loss_fns]
        assert type(mod.transform).__name__ == type(jmod.transform).__name__
        for (_, f, _), (_, jf, _) in zip(mod.loss_fns, jmod.loss_fns):
            if type(f).__name__ == "Wasserstein1D":
                assert f.target_constant and jf.target_constant
                assert (f.p, f.square_dist, f.dont_normalize, f.limit_quantile_range) == \
                    (jf.p, jf.square_dist, jf.dont_normalize, jf.limit_quantile_range)


@pytest.mark.parametrize("warmup,decay", [(0, "constant"), (2, "cosine"), (1, "constant")])
def test_adam_and_schedule_match_optax(warmup, decay):
    """Three updates from identical gradients: torch.optim.Adam with coupled
    L2 + the LambdaLR schedule against the JAX package's optax chain."""
    kw = dict(lr_warmup_steps=warmup, lr_decay=decay, max_steps=5, learning_rate=1e-2,
              weight_decay=1e-2)
    rng = np.random.default_rng(0)
    p0 = {"a": rng.standard_normal((3, 4)).astype(np.float32),
          "b": rng.standard_normal((5,)).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32) for k, v in p0.items()}
             for _ in range(3)]
    opt = jtrainer.make_optimizer(jax_get_experiment("SOT-2048", **kw))
    jp = jax.tree.map(jnp.asarray, p0)
    st = opt.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    topt, sched = ttrainer.make_optimizer(get_experiment("SOT-2048", **kw), list(tp.values()))
    for g in grads:
        upd, st = opt.update(jax.tree.map(jnp.asarray, g), st, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        topt.step()
        sched.step()
    for k in p0:
        moved, ref = tp[k].detach().numpy() - p0[k], np.asarray(jp[k]) - p0[k]
        assert np.abs(ref).max() > 1e-3
        np.testing.assert_allclose(moved, ref, rtol=0, atol=1e-4 * np.abs(ref).max())


def test_schedules_match_jax():
    cfg_kw = dict(temperature_schedule=(1.0, 0.1, 100), lr_warmup_steps=10,
                  lr_decay="cosine", max_steps=50, odd_ratio_prior_weight=0.1,
                  odd_ratio_prior_start=20)
    cfg = get_experiment("SOT-2048", **cfg_kw)
    jcfg = jax_get_experiment("SOT-2048", **cfg_kw)
    sched = optax.join_schedules(
        [optax.linear_schedule(0.0, 1.0, 10), optax.cosine_decay_schedule(1.0, 40)], [10])
    for step in (0, 1, 5, 9, 10, 11, 30, 50, 60, 99, 100, 150):
        np.testing.assert_allclose(ttrainer.temperature_at(cfg, step),
                                   float(jtrainer.temperature_at(jcfg, jnp.int32(step))),
                                   rtol=1e-6)
        assert ttrainer.prior_scale_at(cfg, step) == float(
            jtrainer.prior_scale_at(jcfg, jnp.int32(step)))
        np.testing.assert_allclose(ttrainer.lr_multiplier(cfg, step), float(sched(step)),
                                   rtol=1e-6, atol=1e-7)
    plain = get_experiment("SOT-2048")
    assert ttrainer.temperature_at(plain, 7) == plain.temperature
    assert ttrainer.prior_scale_at(plain, 7) is None
    assert ttrainer.lr_multiplier(plain, 7) == 1.0


def _tiny_cfg(**kw):
    return get_experiment("SOT-2048", batch_size=2, dataset_size=12, **kw)


def _train(seed, steps=2):
    cfg = _tiny_cfg(seed=seed)
    mod = ttrainer.build_modules(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    splits = tdata.dataset_from_config(cfg, device="cpu")
    x_all = torch.from_numpy(tdata.peak_normalize(splits["train"].x))
    state = ttrainer.init_state(mod)
    logs = ttrainer.train_steps(mod, state, x_all, np.arange(steps) * cfg.batch_size)
    return mod, state, logs


def test_train_steps_reproduce_under_one_seed():
    """Two runs from one seed agree bit for bit (dropout masks from the
    state's generator); another dropout seed gives another loss. One CPU
    thread: the BLAS and FFT libraries may pick their thread count by the
    machine's load, and with it their summation order."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _check_reproducible()
    finally:
        torch.set_num_threads(threads)


def _check_reproducible():
    mod_a, state_a, logs_a = _train(seed=42)
    mod_b, _, logs_b = _train(seed=42)
    _, _, logs_c = _train(seed=43, steps=1)
    assert state_a.step == 2 and state_a.scheduler.last_epoch == 2
    for k in logs_a:
        assert torch.equal(logs_a[k], logs_b[k]), k
    for p, q in zip(mod_a.encoder.parameters(), mod_b.encoder.parameters()):
        assert torch.equal(p, q)
    _, _, logs_a1 = _train(seed=42, steps=1)
    assert not torch.equal(logs_a1["loss/total"], logs_c["loss/total"])
    assert set(logs_a) == {"loss/MSSLoss", "loss/Wasserstein1D", "loss/total", "grad_norm"}
    assert bool(torch.isfinite(logs_a["grad_norm"])) and float(logs_a["grad_norm"]) > 0


def test_dropout_is_on_in_training_and_off_in_eval():
    mod = ttrainer.build_modules(_tiny_cfg(), device="cpu")
    ttrainer.init_state(mod, seed=0)
    x = torch.from_numpy(np.random.default_rng(0).uniform(-0.5, 0.5, (2, 4096)).astype(np.float32))
    ev1 = ttrainer.forward(mod, x)["weights"]
    ev2 = ttrainer.forward(mod, x)["weights"]
    tr = ttrainer.forward(mod, x, train=True)["weights"]
    assert torch.equal(ev1, ev2) and not torch.equal(ev1, tr)


def test_detach_weights_adds_a_second_render():
    mod = ttrainer.build_modules(_tiny_cfg(detach_weights=True), device="cpu")
    x = torch.from_numpy(np.random.default_rng(1).uniform(-0.5, 0.5, (2, 4096)).astype(np.float32))
    out = ttrainer.forward(mod, x)
    assert out["x_hat_weights_detached"].shape == out["x_hat"].shape
    torch.testing.assert_close(out["x_hat_weights_detached"], out["x_hat"])
    loss, (logs, _) = ttrainer.compute_loss(mod, x)
    assert bool(torch.isfinite(loss))


def test_data_splits_and_batches_match_jax():
    rng = np.random.default_rng(0)
    sig = rng.standard_normal((20, 64)).astype(np.float32)
    f = rng.random((20, 1)).astype(np.float32)
    a = rng.random((20, 8)).astype(np.float32)
    for kw in (dict(), dict(eval_split=0.25, test_split=None, seed=3)):
        ts, js = tdata.random_split(sig, f, a, **kw), jdata.random_split(sig, f, a, **kw)
        assert ts.keys() == js.keys()
        for k in ts:
            for field in ("x", "frequency", "weights"):
                np.testing.assert_array_equal(getattr(ts[k], field), getattr(js[k], field))
        for drop_last in (False, True):
            tb = list(tdata.iterate_batches(ts["train"], 4, drop_last=drop_last))
            jb = list(jdata.iterate_batches(js["train"], 4, drop_last=drop_last))
            assert len(tb) == len(jb)
            for b1, b2 in zip(tb, jb):
                for k in b1:
                    np.testing.assert_array_equal(b1[k], b2[k])


def test_dataset_from_config_draws_match_jax(tmp_path):
    cfg = _tiny_cfg()
    ts = tdata.dataset_from_config(cfg, device="cpu")
    js = jdata.dataset_from_config(jax_get_experiment("SOT-2048", batch_size=2,
                                                      dataset_size=12))
    for k in ("train", "val", "test"):
        np.testing.assert_array_equal(ts[k].frequency, js[k].frequency)
        np.testing.assert_array_equal(ts[k].weights, js[k].weights)
        assert ts[k].x.shape == js[k].x.shape
    # a dataset_path reads the released .pth layout, as the JAX package does
    path = str(tmp_path / "d.pth")
    torch.save({f"{k}_{part}": ({"frequency": torch.from_numpy(js[k].frequency),
                                 "weights": torch.from_numpy(js[k].weights)}
                                if part == "thetas" else torch.from_numpy(js[k].x))
                for k in ("train", "val") for part in ("tensors", "thetas")}, path)
    tp = tdata.dataset_from_config(get_experiment("SOT-2048", dataset_path=path), device="cpu")
    jp = jdata.dataset_from_config(jax_get_experiment("SOT-2048", dataset_path=path))
    assert sorted(tp) == sorted(jp) == ["train", "val"]
    for k in tp:
        for field in ("x", "frequency", "weights"):
            np.testing.assert_array_equal(getattr(tp[k], field), getattr(jp[k], field))


def test_gradients_map_to_the_flax_tree():
    mod = ttrainer.build_modules(_tiny_cfg(), device="cpu")
    x = torch.from_numpy(np.random.default_rng(2).uniform(-0.5, 0.5, (2, 4096)).astype(np.float32))
    ttrainer.compute_loss(mod, x)[0].backward()
    tree = grads_to_flax(mod.encoder)
    ref = jax.tree.map(np.shape, _golden_params())
    assert jax.tree.map(np.shape, tree) == ref
    # the same mapping as the parameters: a gradient equal to the params maps like them
    for p in mod.encoder.parameters():
        p.grad = p.detach().clone()
    same = grads_to_flax(mod.encoder)
    as_params = params_to_flax(mod.encoder.state_dict())
    assert all(np.array_equal(a, b) for a, b in zip(jax.tree.leaves(same),
                                                    jax.tree.leaves(as_params)))
