"""Run checkpoints, resumes, the optimizer state carried over from the JAX
package, the released-dataset loader and the JSONL log of the port:

  * a checkpoint restored into fresh modules and state equals the state it
    was written from, bit for bit (parameters, Adam's moments and steps,
    LambdaLR, the dropout generator, the step);
  * two resumes from one checkpoint give bit-equal parameters (one CPU
    thread, as ``test_train_steps_reproduce_under_one_seed``);
  * ``convert.optimizer_state_from_flax``: JAX takes 3 Adam updates, its
    ``opt_state`` goes to the port, and the port's 4th update from the same
    gradients is JAX's 4th within 1e-4 of its max (the limit of
    ``tests/test_torch_train.py``'s Adam check);
  * ``data.load_pth_dataset`` on a small ``.pth`` written here gives the
    JAX package's loader's arrays;
  * ``scripts/refgrad_train_verdict.py:loss_trajectory`` reads a port
    ``log.jsonl`` unchanged.
"""

from __future__ import annotations

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from chip_smoke import tree_diff  # noqa: E402
from sot_tpu import data as jdata  # noqa: E402
from sot_tpu.configs import get_experiment as jax_get_experiment  # noqa: E402
from sot_tpu.training import trainer as jtrainer  # noqa: E402
from sot_tpu_torch import data as tdata  # noqa: E402
from sot_tpu_torch.configs import get_experiment  # noqa: E402
from sot_tpu_torch.convert import optimizer_state_from_flax, params_from_flax  # noqa: E402
from sot_tpu_torch.training import checkpoint as ckpt_lib  # noqa: E402
from sot_tpu_torch.training import trainer as ttrainer  # noqa: E402
from sot_tpu_torch.training.logging import JsonlLogger  # noqa: E402
from tests._torch_parity import jax_init_params  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(n_samples=1024, cqt_fmin=261.6, transform_n_fft=512, transform_hop=128,
            batch_size=4, dataset_size=24, eval_every_steps=2)


@pytest.fixture()
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _tiny_run(tmp_path, steps: int = 3):
    cfg = get_experiment("SOT-2048", **TINY)
    splits = tdata.dataset_from_config(cfg, device="cpu")
    mod, state, _ = ttrainer.train(cfg, max_steps=steps, checkpoint_dir=str(tmp_path / "ckpt"),
                                   splits=splits, device="cpu")
    return cfg, splits, mod, state


def test_checkpoint_round_trip_is_bit_equal(tmp_path, one_thread):
    cfg, _, mod, state = _tiny_run(tmp_path)
    last = str(tmp_path / "ckpt" / "last")
    written = ckpt_lib.load(last)
    assert written["step"] == 3 and len(written["optimizer"]["state"]) == len(
        list(mod.encoder.parameters()))
    # the run's state, apart from the parameters train() replaced by the best ones
    in_memory = ckpt_lib.payload(mod, state, state.step)
    assert tree_diff({k: v for k, v in written.items() if k != "encoder"},
                     {k: v for k, v in in_memory.items() if k != "encoder"}) == []

    fresh = ttrainer.build_modules(cfg, device="cpu", generator=torch.Generator().manual_seed(9))
    fresh_state = ttrainer.init_state(fresh, seed=123)
    assert tree_diff(ckpt_lib.payload(fresh, fresh_state, 0), written) != []
    assert ckpt_lib.restore(last, fresh, fresh_state) == 3
    assert tree_diff(ckpt_lib.payload(fresh, fresh_state, fresh_state.step), written) == []
    assert fresh.encoder.dropout.generator is fresh_state.generator
    assert fresh_state.scheduler.last_epoch == 3
    # the encoder-only reader used by evaluate/predict/analyze takes both formats
    assert tree_diff(ckpt_lib.encoder_state(last, fresh.encoder), written["encoder"]) == []
    bare = tmp_path / "encoder.pt"
    torch.save(mod.encoder.state_dict(), bare)
    assert tree_diff(ckpt_lib.encoder_state(str(bare), fresh.encoder),
                     mod.encoder.state_dict()) == []
    with pytest.raises(ValueError, match="not a run checkpoint"):
        ckpt_lib.load(str(bare))


def test_two_resumes_from_one_checkpoint_are_bit_equal(tmp_path, one_thread):
    cfg, splits, _, _ = _tiny_run(tmp_path, steps=2)
    last = str(tmp_path / "ckpt" / "last")
    runs = []
    for i in range(2):
        out = tmp_path / f"resume{i}"
        mod, state, best = ttrainer.train(cfg, max_steps=6, checkpoint_dir=str(out),
                                          splits=splits, resume_from=last, device="cpu")
        runs.append((ckpt_lib.load(str(out / "last")), best))
    assert runs[0][1] == runs[1][1]
    assert tree_diff(runs[0][0], runs[1][0]) == []
    assert runs[0][0]["step"] == 6
    # the resumed steps really moved the parameters away from the checkpoint's
    start = ckpt_lib.load(last)["encoder"]
    assert any(not torch.equal(start[k], runs[0][0]["encoder"][k]) for k in start)


def test_optimizer_state_from_flax_gives_jax_next_update():
    kw = dict(lr_warmup_steps=2, lr_decay="cosine", max_steps=10, learning_rate=1e-2,
              weight_decay=1e-2)
    params = jax_init_params(seed=5)
    rng = np.random.default_rng(0)
    grads = [jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), params)
             for _ in range(4)]
    opt = jtrainer.make_optimizer(jax_get_experiment("SOT-2048", **kw))
    jp = jax.tree.map(jnp.asarray, params)
    st = opt.init(jp)
    for g in grads[:3]:
        upd, st = opt.update(jax.tree.map(jnp.asarray, g), st, jp)
        jp = optax.apply_updates(jp, upd)
    p3 = jax.tree.map(np.asarray, jp)
    upd, _ = opt.update(jax.tree.map(jnp.asarray, grads[3]), st, jp)
    p4 = params_from_flax(jax.tree.map(np.asarray, optax.apply_updates(jp, upd)))

    mod = ttrainer.build_modules(get_experiment("SOT-2048", **kw), device="cpu")
    mod.encoder.load_state_dict(params_from_flax(p3))
    state = ttrainer.init_state(mod)
    optimizer_state_from_flax(jax.tree.map(np.asarray, st), 3, mod, state)
    assert state.step == 3 and state.scheduler.last_epoch == 3
    g4 = params_from_flax(grads[3])
    for name, p in mod.encoder.named_parameters():
        p.grad = g4[name].clone()
    state.optimizer.step()
    state.scheduler.step()
    start = params_from_flax(p3)
    for name, p in mod.encoder.named_parameters():
        moved, ref = p.detach().numpy() - start[name].numpy(), p4[name].numpy() - start[name].numpy()
        assert np.abs(ref).max() > 1e-4, name
        np.testing.assert_allclose(moved, ref, rtol=0, atol=1e-4 * np.abs(ref).max(),
                                   err_msg=name)
    with pytest.raises(ValueError, match="scale_by_adam"):
        optimizer_state_from_flax((), 3, mod, state)


@pytest.mark.parametrize("with_test", [True, False])
def test_load_pth_dataset_matches_jax(tmp_path, with_test):
    rng = np.random.default_rng(4)
    d = {}
    for split, n in (("train", 5), ("val", 3)) + ((("test", 2),) if with_test else ()):
        d[f"{split}_tensors"] = torch.from_numpy(rng.standard_normal((n, 64)).astype(np.float32))
        d[f"{split}_thetas"] = {
            "frequency": torch.from_numpy(rng.uniform(40, 1950, (n, 1)).astype(np.float32)),
            "weights": torch.from_numpy(rng.uniform(0, 1, (n, 8)).astype(np.float32))}
    path = str(tmp_path / "data.pth")
    torch.save(d, path)
    got, ref = tdata.load_pth_dataset(path), jdata.load_pth_dataset(path)
    assert sorted(got) == sorted(ref) == sorted(["train", "val"] + (["test"] if with_test else []))
    for k in ref:
        for field in ("x", "frequency", "weights"):
            a, b = getattr(got[k], field), getattr(ref[k], field)
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)


def test_loss_trajectory_reads_a_port_log(tmp_path):
    spec = importlib.util.spec_from_file_location(
        "refgrad_train_verdict", os.path.join(ROOT, "scripts", "refgrad_train_verdict.py"))
    verdict = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(verdict)
    run = tmp_path / "run"
    run.mkdir()
    logger = JsonlLogger(str(run / "log.jsonl"), echo=False)
    for step, lsd in ((500, 90.0), (1000, 80.5), (3000, torch.tensor(45.25)), (9000, 30.0)):
        logger.write({"split": "train", "step": step, "loss/total": torch.tensor(0.1)})
        logger.write({"split": "val", "step": step, "log_spectral_distance": lsd})
    logger.close()
    records = [json.loads(line) for line in open(run / "log.jsonl")]
    assert all(isinstance(r["step"], float) for r in records)
    assert verdict.loss_trajectory(str(tmp_path), "run", at_steps=(1000, 3000, 10000)) == {
        "1000": 80.5, "3000": 45.25, "10000": 30.0}


def test_encoder_state_reads_three_formats_and_names_the_keys_of_others(tmp_path):
    """``encoder_state`` decides by content: a run checkpoint, a bare port
    state dict and a reference (Lightning) checkpoint, bare or in a
    ``state_dict`` entry; anything else raises, naming the keys it found."""
    from sot_tpu_torch.models.import_torch import import_encoder_state
    from tests._torch_parity import reference_layout

    mod = ttrainer.build_modules(get_experiment("SOT-2048"), device="cpu",
                                 generator=torch.Generator().manual_seed(4))
    own = mod.encoder.state_dict()
    run = ckpt_lib.save(str(tmp_path / "ckpt"), mod, ttrainer.init_state(mod), 0, tag="last")
    bare = str(tmp_path / "encoder.pt")
    torch.save(own, bare)
    for path in (run, bare):
        assert tree_diff(ckpt_lib.encoder_state(path, mod.encoder), own) == []

    ref = {k: torch.from_numpy(v) for k, v in reference_layout(seed=8).items()}
    want = import_encoder_state(mod.encoder, ref)
    # by name, apart from the import's own map
    assert torch.equal(want["conv4b.weight"], ref["conv4.3.weight"])
    assert torch.equal(want["prefilt.0.bias"], ref["prefilt_list.0.0.bias"])
    assert torch.equal(want["frequency.0.weight"], ref["linear.frequency.0.weight"].reshape(-1))
    blobs = {"lightning.ckpt": {"state_dict": {"encoder." + k: v for k, v in ref.items()},
                                "epoch": 7, "global_step": 99},
             "reference.pt": ref}
    for name, blob in blobs.items():
        torch.save(blob, tmp_path / name)
        got = ckpt_lib.encoder_state(str(tmp_path / name), mod.encoder)
        assert tree_diff(got, want) == [], name
        mod.encoder.load_state_dict(got)  # strict

    others = {"other.pt": {"alpha": torch.zeros(2), "beta": torch.ones(1)},
              "short.pt": {k: v for k, v in own.items() if k != "conv1.bias"},
              "tensor.pt": torch.zeros(3)}
    for name, blob in others.items():
        torch.save(blob, tmp_path / name)
        with pytest.raises(ValueError, match="neither a run checkpoint") as exc:
            ckpt_lib.encoder_state(str(tmp_path / name), mod.encoder)
        if name == "other.pt":
            assert "['alpha', 'beta']" in str(exc.value)
        elif name == "short.pt":
            assert "'conv1.weight'" in str(exc.value)
        else:
            assert "Tensor" in str(exc.value)
