"""The port's ``train()`` loop against the JAX package's ``train()``, with
each side's train step, evaluation and checkpoint writer replaced by
recorders fed the same scripted val LSDs (dropout masks and inits differ by
design, so the loop's decisions are compared, not parameters): the batch
offsets of each chunk, which init each chunk trains (the probe choice), the
evaluation calls with their full and partial val batches, the record
``split``/``step`` sequence and keys, the scripted metrics, the checkpoint
tags and steps, and the best metrics. No JAX compile: the recorders stand in
for every jitted function.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from sot_tpu import data as jdata  # noqa: E402
from sot_tpu.configs import get_experiment as jax_get_experiment  # noqa: E402
from sot_tpu.training import checkpoint as jckpt  # noqa: E402
from sot_tpu.training import trainer as jtrainer  # noqa: E402
from sot_tpu_torch import data as tdata  # noqa: E402
from sot_tpu_torch.configs import get_experiment  # noqa: E402
from sot_tpu_torch.training import checkpoint as tckpt  # noqa: E402
from sot_tpu_torch.training import trainer as ttrainer  # noqa: E402

TINY = dict(n_samples=1024, cqt_fmin=261.6, transform_n_fft=512, transform_hop=128,
            batch_size=2)
# val LSD of an evaluation that follows the n-th chunk: neither monotone nor
# last-is-best, and in the probe case the middle probe wins
LSD_SCRIPT = (30.0, 20.0, 25.0, 10.0, 9.0, 15.0, 12.0, 50.0, 11.0, 35.0, 8.0, 13.0, 14.0,
              16.0, 7.0, 18.0, 19.0)

CASES = {
    # 5 steps an epoch
    "max_steps_not_a_multiple_of_an_epoch": dict(n_train=10, n_val=4, max_steps=12, every=5),
    "eval_every_not_a_multiple_of_an_epoch": dict(n_train=10, n_val=5, max_steps=15, every=7),
    "val_split_with_a_partial_last_batch": dict(n_train=11, n_val=7, max_steps=9, every=3),
    "val_split_of_one_partial_batch": dict(n_train=10, n_val=1, max_steps=6, every=3),
    "three_probes": dict(n_train=10, n_val=5, max_steps=12, every=5, probes=3, probe_steps=7),
    "resume_from_step_6": dict(n_train=10, n_val=5, max_steps=14, every=4, resume=6),
}


class Recorder:
    """The events of one ``train()`` run: chunk offsets and the init each
    chunk trains (labelled in order of first appearance), eval calls and
    checkpoint saves."""

    def __init__(self):
        self.chunks, self.owners, self.evals, self.saves = [], [], [], []
        self._labels = {}

    def chunk(self, fingerprint: float, offsets) -> None:
        self.chunks.append([int(o) for o in np.asarray(offsets)])
        self.owners.append(self._labels.setdefault(fingerprint, len(self._labels)))

    def metrics(self, kind: str, shape) -> dict:
        self.evals.append((kind, tuple(shape)))
        lsd = LSD_SCRIPT[len(self.chunks) % len(LSD_SCRIPT)]
        return {"log_spectral_distance": lsd, "mse": lsd / 100.0}


def _splits(split_cls, n_train: int, n_val: int):
    rng = np.random.default_rng(0)

    def split(n):
        return split_cls(rng.uniform(-1, 1, (n, 16)).astype(np.float32),
                         rng.uniform(40, 1950, (n, 1)).astype(np.float32),
                         rng.uniform(0, 1, (n, 8)).astype(np.float32))

    return {"train": split(n_train), "val": split(n_val), "test": split(2)}


def _cfg_kw(case):
    return dict(TINY, eval_every_steps=case["every"], n_init_probes=case.get("probes", 1),
                probe_steps=case.get("probe_steps", 0))


def _run_jax(case, tmp_path, monkeypatch):
    rec = Recorder()

    def train_steps(state, x_all, los, rng):
        rec.chunk(float(sum(jnp.sum(jnp.abs(a)) for a in jax.tree.leaves(state.params))), los)
        logs = {"loss/total": jnp.float32(len(rec.chunks)), "grad_norm": jnp.float32(1.0)}
        return state._replace(step=state.step + len(los)), logs

    def eval_all(params, xs, f0s):
        return rec.metrics("all", xs.shape)

    def eval_step(params, x, f0):
        return rec.metrics("step", x.shape)

    def save(checkpoint_dir, state, step, tag="best-lsd"):
        rec.saves.append((tag, int(step)))

    def restore(path, state):
        s = case["resume"]
        return state._replace(step=jnp.asarray(s, jnp.int32)), s

    monkeypatch.setattr(jtrainer, "make_train_steps_scan", lambda mod: train_steps)
    monkeypatch.setattr(jtrainer, "make_eval_all", lambda mod: eval_all)
    monkeypatch.setattr(jtrainer, "make_eval_step", lambda mod: eval_step)
    monkeypatch.setattr(jckpt, "save", save)
    monkeypatch.setattr(jckpt, "restore", restore)
    log = tmp_path / "jax.jsonl"
    _, best = jtrainer.train(
        jax_get_experiment("SOT-2048", **_cfg_kw(case)), max_steps=case["max_steps"],
        checkpoint_dir=str(tmp_path / "jax_ckpt"), log_file=str(log),
        splits=_splits(jdata.SplitArrays, case["n_train"], case["n_val"]),
        resume_from="resume-ckpt" if "resume" in case else None)
    return rec, best, [json.loads(line) for line in open(log)]


def _run_port(case, tmp_path, monkeypatch):
    rec = Recorder()
    cfg = get_experiment("SOT-2048", **_cfg_kw(case))

    def train_steps(mod, state, x_all, offsets):
        rec.chunk(float(sum(p.detach().abs().sum() for p in mod.encoder.parameters())), offsets)
        state.step += len(offsets)
        return {"loss/total": torch.tensor(float(len(rec.chunks))),
                "grad_norm": torch.tensor(1.0)}

    save = tckpt.save

    def spy_save(checkpoint_dir, mod, state, step, tag="best-lsd"):
        rec.saves.append((tag, int(step)))
        return save(checkpoint_dir, mod, state, step, tag=tag)

    monkeypatch.setattr(ttrainer, "train_steps", train_steps)
    monkeypatch.setattr(ttrainer, "make_eval_all",
                        lambda mod: lambda xs, f0s: rec.metrics("all", xs.shape))
    monkeypatch.setattr(ttrainer, "make_eval_step",
                        lambda mod: lambda x, f0: rec.metrics("step", x.shape))
    monkeypatch.setattr(tckpt, "save", spy_save)
    resume = None
    if "resume" in case:
        mod = ttrainer.build_modules(cfg, device="cpu")
        state = ttrainer.init_state(mod)
        state.step = case["resume"]
        resume = save(str(tmp_path / "resume"), mod, state, case["resume"], tag="last")
    log = tmp_path / "port.jsonl"
    mod, state, best = ttrainer.train(
        cfg, max_steps=case["max_steps"], checkpoint_dir=str(tmp_path / "port_ckpt"),
        log_file=str(log), splits=_splits(tdata.SplitArrays, case["n_train"], case["n_val"]),
        resume_from=resume, device="cpu")
    return rec, best, [json.loads(line) for line in open(log)], (mod, state)


@pytest.mark.parametrize("name", list(CASES))
def test_train_loop_matches_jax(name, tmp_path, monkeypatch):
    case = CASES[name]
    jrec, jbest, jlog = _run_jax(case, tmp_path, monkeypatch)
    trec, tbest, tlog, (mod, state) = _run_port(case, tmp_path, monkeypatch)

    assert trec.chunks == jrec.chunks
    assert trec.owners == jrec.owners
    assert trec.evals == jrec.evals
    assert trec.saves == jrec.saves
    assert tbest == jbest

    def strip(records):
        return [{k: v for k, v in r.items() if k != "samples_per_sec"} for r in records]

    assert [sorted(r) for r in tlog] == [sorted(r) for r in jlog]
    assert strip(tlog) == strip(jlog)

    # the case exercises what it is named for
    splits = [r["split"] for r in jlog]
    steps = [int(r["step"]) for r in jlog if r["split"] == "val"]
    assert steps[-1] == case["max_steps"]
    if "probes" in case:
        assert splits.count("probe") == case["probes"]
        assert trec.owners[2 * case["probes"]:] == [1] * (len(trec.owners) - 2 * case["probes"])
    if "resume" in case:
        order = np.random.default_rng(42).permutation(case["n_train"] // 2) * 2
        assert trec.chunks[0] == order[:min(5, case["max_steps"] - case["resume"])].tolist()
        assert int(jlog[0]["step"]) == case["resume"] + 5
    if case["n_val"] % 2:
        assert ("step", (1, 16)) in trec.evals
    # checkpoints on disk under the tags the run saved, at their steps
    for tag, step in dict(trec.saves).items():
        assert tckpt.load(str(tmp_path / "port_ckpt" / tag))["step"] == step
    assert state.step == case["max_steps"]
