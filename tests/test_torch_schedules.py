"""The schedules' tensor forms (``trainer.temperature_tensor``,
``prior_scale_tensor``, ``lr_tensor``), which the CUDA graph of the train
step computes from its device step counter, against the JAX package's
``temperature_at`` and ``prior_scale_at`` at a traced int32 step and the
optax schedule its ``make_optimizer`` builds (linear warmup joined to a
cosine decay or a constant, as ``tests/test_torch_train.py`` builds it).

Tolerance: one float32 ulp. Both compute in float32 with the same
operations in the same order; only ``log``, ``cos`` and ``exp`` may round
differently (XLA's CPU functions against PyTorch's). The steps: 0, 1, the
warmup's edges, the anneal's n - 1, n, n + 1, the prior's start and
max_steps (and one past it).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from sot_tpu.configs import get_experiment as jax_get_experiment  # noqa: E402
from sot_tpu.training import trainer as jtrainer  # noqa: E402
from sot_tpu_torch.configs import get_experiment  # noqa: E402
from sot_tpu_torch.training import trainer as ttrainer  # noqa: E402

CONFIGS = {
    # the anneal (1.0 -> 0.1 over 1500 steps), a warmup, a cosine decay and
    # the gated odd-ratio prior, over the preset's 25000 steps
    "SOT-2048-Anneal": ("SOT-2048-Anneal", dict(lr_warmup_steps=100, lr_decay="cosine",
                                                odd_ratio_prior_weight=0.1,
                                                odd_ratio_prior_start=700)),
    # a cosine decay with no warmup, a short run
    "cosine": ("SOT-2048", dict(lr_decay="cosine", max_steps=2000)),
    # a warmup into the constant lr
    "warmup": ("SOT-2048", dict(lr_warmup_steps=10)),
    # the shipped constant lr and temperature
    "SOT-2048": ("SOT-2048", {}),
}


def _optax_schedule(cfg):
    """The schedule of ``sot_tpu/training/trainer.py:make_optimizer``."""
    if cfg.lr_warmup_steps == 0 and cfg.lr_decay == "constant":
        return lambda step: np.float32(cfg.learning_rate)
    schedules, bounds = [], []
    if cfg.lr_warmup_steps > 0:
        schedules.append(optax.linear_schedule(0.0, cfg.learning_rate, cfg.lr_warmup_steps))
        bounds.append(cfg.lr_warmup_steps)
    if cfg.lr_decay == "cosine":
        schedules.append(optax.cosine_decay_schedule(
            cfg.learning_rate, max(cfg.max_steps - cfg.lr_warmup_steps, 1)))
    else:
        schedules.append(optax.constant_schedule(cfg.learning_rate))
    return optax.join_schedules(schedules, bounds) if bounds else schedules[0]


def _steps(cfg):
    steps = {0, 1, cfg.max_steps - 1, cfg.max_steps, cfg.max_steps + 1}
    w = cfg.lr_warmup_steps
    steps |= {w - 1, w, w + 1} if w else set()
    if cfg.temperature_schedule is not None:
        n = cfg.temperature_schedule[2]
        steps |= {n - 1, n, n + 1}
    if cfg.odd_ratio_prior_start > 0:
        s = cfg.odd_ratio_prior_start
        steps |= {s - 1, s, s + 1}
    return sorted(steps)


def _ulps(a, b) -> int:
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(abs(ia - ib))


@pytest.mark.parametrize("key", sorted(CONFIGS))
def test_tensor_schedules_match_jax(key):
    name, kw = CONFIGS[key]
    cfg, jcfg = get_experiment(name, **kw), jax_get_experiment(name, **kw)
    sched = _optax_schedule(jcfg)
    for step in _steps(cfg):
        st = torch.tensor(step)
        temp = ttrainer.temperature_tensor(cfg, st)
        jtemp = jtrainer.temperature_at(jcfg, jnp.int32(step))
        if cfg.temperature_schedule is None:
            assert temp == jtemp == cfg.temperature
        else:
            assert temp.dtype == torch.float32
            assert _ulps(float(temp), float(jtemp)) <= 1, (step, float(temp), float(jtemp))
        prior = ttrainer.prior_scale_tensor(cfg, st)
        jprior = jtrainer.prior_scale_at(jcfg, jnp.int32(step))
        assert (prior is None) == (jprior is None)
        if prior is not None:
            assert float(prior) == float(jprior)
        lr = ttrainer.lr_tensor(cfg, st)
        assert lr.dtype == torch.float32 and lr.shape == ()
        assert _ulps(float(lr), float(sched(jnp.int32(step)))) <= 1, (step, float(lr))
        # the host form the eager path keeps agrees to float32 rounding
        host = cfg.learning_rate * ttrainer.lr_multiplier(cfg, step)
        assert abs(float(lr) - host) <= 2e-7 * cfg.learning_rate, (step, float(lr), host)


def test_tensor_schedules_take_a_batch_of_steps():
    """The forms are elementwise, so the step counter may be any integer
    tensor (the graph's is 0-dim)."""
    name, kw = CONFIGS["SOT-2048-Anneal"]
    cfg = get_experiment(name, **kw)
    steps = torch.tensor([0, 99, 100, 1500, 30000])
    lr = ttrainer.lr_tensor(cfg, steps)
    temp = ttrainer.temperature_tensor(cfg, steps)
    for i, s in enumerate(steps.tolist()):
        assert float(lr[i]) == float(ttrainer.lr_tensor(cfg, torch.tensor(s)))
        assert float(temp[i]) == float(ttrainer.temperature_tensor(cfg, torch.tensor(s)))
    assert float(lr[0]) == 0.0 and float(lr[-1]) == 0.0
    assert float(temp[0]) == 1.0 and abs(float(temp[-1]) - 0.1) < 1e-7
