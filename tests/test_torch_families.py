"""One train-step parity case per experiment family not covered elsewhere
(SOT-2048 and the SOT-512 family have theirs in ``tests/test_torch_train.py``
and ``tests/test_torch_sot512.py``): ``compute_loss`` and each loss term's
gradient per parameter leaf, eval mode, the trained SOT-2048 seed-42 weights,
batch 2, JAX's default CPU path against the port on the CPU, with
``tests/test_torch_train.py``'s limits (loss rel <= 1e-4, ``GRAD_LIMITS``).
SOT-2048-Anneal and SOT-2048-SS-Probes take the temperature of their anneal
at step 700 on both sides.

MSS-LogLin's loss is held within 2e-3 rel instead: its log-magnitude L1
terms take the log of STFT bins at the noise floor, where the synth's
phase rounding (~1e-4 of the audio here) moves the log by O(1). JAX's own
jitted and eager evaluations of this loss on these inputs disagree by
1.3e-3 rel; the test asserts that they disagree by more than 1e-4, and holds
the loss function itself, on the same audio in both packages, within 1e-5.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from sot_tpu.configs import get_experiment as jax_get_experiment  # noqa: E402
from sot_tpu.training import trainer as jtrainer  # noqa: E402
from sot_tpu_torch.configs import get_experiment  # noqa: E402
from sot_tpu_torch.convert import flat_from_tree, params_to_flax  # noqa: E402
from sot_tpu_torch.training import trainer as ttrainer  # noqa: E402
from tests import _torch_golden_train  # noqa: E402
from tests.test_torch_train import GRAD_LIMITS, _golden_params, _max_rel, _port  # noqa: E402

FAMILIES = ("SOT-NoCut", "SOT-2048-SS", "SOT-2048-Anneal", "SOT-2048-SS-Probes", "MSS-Lin",
            "MSS-LogLin")
ANNEAL_STEP = 700
LOSS_REL = {"MSS-LogLin": 2e-3}


@pytest.mark.parametrize("name", FAMILIES)
def test_family_train_step_matches_jax(name, monkeypatch):
    for k in ("SOT_TPU_W2_MERGE", "SOT_TPU_SYNTH_PALLAS", "SOT_TPU_CQT_PALLAS",
              "SOT_TPU_CONV_BF16"):
        monkeypatch.delenv(k, raising=False)
    cfg, jcfg = get_experiment(name), jax_get_experiment(name)
    terms = {"total": "loss/total", "mss": "loss/MSSLoss"}
    if any(lc.kind == "wasserstein" for lc in cfg.losses):
        terms["w1d"] = "loss/Wasserstein1D"
    temperature = None
    if cfg.temperature_schedule is not None:
        temperature = ttrainer.temperature_at(cfg, ANNEAL_STEP)
        assert temperature != cfg.temperature
        np.testing.assert_allclose(
            temperature, float(jtrainer.temperature_at(jcfg, jnp.int32(ANNEAL_STEP))), rtol=1e-6)
    params = _golden_params()
    with np.load(_torch_golden_train.GOLDEN) as z:
        x = z["x"][:2]

    mod = _port(params, cfg)
    _, (logs, out) = ttrainer.compute_loss(mod, torch.from_numpy(x), temperature=temperature)
    names, tparams = zip(*mod.encoder.named_parameters())
    port = {}
    for tag, term in terms.items():
        grads = torch.autograd.grad(logs[term], tparams, retain_graph=True)
        port[tag] = (float(logs[term].detach()),
                     flat_from_tree(params_to_flax(dict(zip(names, grads)))["params"]))

    jmod = jtrainer.build_modules(jcfg)
    jt = None if temperature is None else jnp.float32(temperature)

    def values(p):
        _, (jlogs, _) = jtrainer.compute_loss(jmod, p, jnp.asarray(x), temperature=jt)
        return jnp.stack([jlogs[t] for t in terms.values()])

    jparams = jax.tree.map(jnp.asarray, params)
    v, jac = jax.jit(lambda p: (values(p), jax.jacrev(values)(p)))(jparams)
    ref = {tag: (float(v[i]), flat_from_tree(jax.tree.map(lambda a, i=i: a[i], jac)["params"]))
           for i, tag in enumerate(terms)}
    limit = LOSS_REL.get(name, 1e-4)
    for tag, (loss, grads) in port.items():
        ref_loss, ref_grads = ref[tag]
        errs = _max_rel(grads, ref_grads)
        worst = max(errs, key=errs.get)
        print(f"{name} {tag}: loss rel {abs(loss - ref_loss) / abs(ref_loss):.2e}, "
              f"worst gradient {worst} {errs[worst]:.3e}")
        assert abs(loss - ref_loss) <= limit * abs(ref_loss), (tag, loss, ref_loss)
        assert errs[worst] <= GRAD_LIMITS[tag], (tag, worst, errs)
    if name in LOSS_REL:
        eager = float(values(jparams)[0])
        assert abs(eager - ref["total"][0]) > 1e-4 * abs(ref["total"][0])
        (_, jfn, w), (_, tfn, _) = jmod.loss_fns[0], mod.loss_fns[0]
        x_hat = out["x_hat"].detach()
        same = float(jfn(jnp.asarray(x), jnp.asarray(x_hat.numpy()))) * w
        got = float(tfn(torch.from_numpy(x), x_hat)) * w
        assert abs(got - same) <= 1e-5 * abs(same)
