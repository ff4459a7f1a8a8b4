"""The compiled training loop: the train step read from the device-resident
dataset by a device offset, with the schedules as tensors
(``trainer.train_step_indexed``), its CUDA graph (``TrainGraph``,
``train_steps_graph``), the scanned evaluation as a graph (``EvalGraph``),
the launch counts of replays, and checkpoints across the two paths.

On the CPU: the indexed step against the eager ``train_step`` (bit for bit
with a learning rate that float32 holds exactly; with the default 1e-4
each parameter within one ulp of itself or 1e-6 of the lr, whichever is
larger, after one step, the only difference being the lr's rounding: the
indexed step hands the CPU's Adam the float32 schedule value, the eager one
the schedule's float64), the capture-safe constants, the launch-count
registry, a checkpoint round trip with a tensor lr. The tests marked
``cuda`` need the card (``python -m pytest tests/test_torch_graph.py -m
cuda --noconftest``): graph replays against eager steps on each route under
``cudnn.deterministic`` (parameters, Adam's state, the generator bit for
bit), launch counts by replay, checkpoints from either path resumed on the
other, the eval graph against the eager loop, and a capture-unsafe step
raising.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from sot_tpu_torch import data as tdata
from sot_tpu_torch.configs import get_experiment
from sot_tpu_torch.device import device_constant
from sot_tpu_torch.kernel_gates import KernelGates
from sot_tpu_torch.ops.kernels import launches as launches_lib
from sot_tpu_torch.training import checkpoint as ckpt_lib
from sot_tpu_torch.training import trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(n_samples=1024, cqt_fmin=261.6, transform_n_fft=512, transform_hop=128,
            batch_size=8, dataset_size=32)
GATED = KernelGates(w2_merge="full", conv=True, stft_frontend=True)
# the SOT routes of the JAX package's committed gates (its ``auto``): ref
# above 512 bins, hybrid at or below; named so that what is held against
# JAX's records does not move with the port's adoption files
JAX_AUTO = KernelGates(w2_merge="ref", w2_merge_small="hybrid")


@pytest.fixture()
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _train_split(cfg, device):
    x = tdata.peak_normalize(tdata.dataset_from_config(cfg, device=device)["train"].x)
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _fresh(cfg, device, kernels=JAX_AUTO):
    mod = trainer.build_modules(cfg, device=device,
                                generator=torch.Generator().manual_seed(cfg.seed),
                                kernels=kernels)
    return mod, trainer.init_state(mod)


def _indexed_steps(mod, state, x_all, offsets):
    """``train_step_indexed`` over ``offsets``, the host step and schedule
    kept as ``TrainGraph`` keeps them."""
    dev = x_all.device
    offs = torch.as_tensor(np.asarray(offsets, np.int64), device=dev)
    index = torch.zeros((), dtype=torch.int64, device=dev)
    step = torch.full((), state.step, dtype=torch.int64, device=dev)
    lr = torch.zeros((), dtype=torch.float32, device=dev)
    for _ in offsets:
        logs = trainer.train_step_indexed(mod, state, x_all, offs, index, step, lr)
        state.step += 1
        state.scheduler.step()
    assert int(step) == state.step and int(index) == len(offsets)
    return logs


def _within(a: torch.Tensor, b: torch.Tensor, floor: float) -> bool:
    """|a - b| <= max(one ulp of a, floor), elementwise."""
    ulp = torch.nextafter(a.abs(), torch.tensor(float("inf"))) - a.abs()
    return bool(((a - b).abs() <= torch.clamp(ulp, min=floor)).all())


@pytest.mark.parametrize("lr,offsets,exact", [(2.0 ** -13, [0, 8, 0], True), (1e-4, [8], False)])
def test_indexed_step_equals_eager_step_on_cpu(one_thread, lr, offsets, exact):
    cfg = get_experiment("SOT-2048", learning_rate=lr, **TINY)
    x_all = _train_split(cfg, "cpu")
    mod_a, st_a = _fresh(cfg, "cpu")
    logs_a = trainer.train_steps(mod_a, st_a, x_all, offsets)
    mod_b, st_b = _fresh(cfg, "cpu")
    logs_b = _indexed_steps(mod_b, st_b, x_all, offsets)
    pa, pb = mod_a.encoder.state_dict(), mod_b.encoder.state_dict()
    assert all(_within(pa[k], pb[k], 0.0 if exact else 1e-6 * lr) for k in pa)
    if exact:
        assert {k: float(v) for k, v in logs_a.items()} == {k: float(v) for k, v in logs_b.items()}
        assert ckpt_lib.payload(mod_a, st_a, st_a.step)["optimizer"]["state"].keys() == \
            ckpt_lib.payload(mod_b, st_b, st_b.step)["optimizer"]["state"].keys()
        for (_, sa), (_, sb) in zip(st_a.optimizer.state.items(), st_b.optimizer.state.items()):
            assert all(torch.equal(sa[k], sb[k]) for k in sa)
        assert torch.equal(st_a.generator.get_state(), st_b.generator.get_state())
    assert st_b.step == st_a.step and st_b.scheduler.last_epoch == st_a.scheduler.last_epoch


def test_graph_needs_the_gpu():
    cfg = get_experiment("SOT-2048", **TINY)
    mod, state = _fresh(cfg, "cpu")
    x_all = _train_split(cfg, "cpu")
    with pytest.raises(ValueError, match="needs the model and the dataset on the GPU"):
        trainer.TrainGraph(mod, state, x_all)
    with pytest.raises(ValueError, match="on the GPU"):
        trainer.EvalGraph(mod, x_all[None, :8], x_all[None, :8, :1])
    # the CPU's make_eval_all is the eager loop
    eval_all = trainer.make_eval_all(mod)
    f0s = torch.full((2, 8, 1), 220.0)
    got = eval_all(x_all[:16].reshape(2, 8, -1), f0s)
    step = trainer.make_eval_step(mod)
    want = [step(x_all[i * 8:(i + 1) * 8], f0s[i]) for i in range(2)]
    assert got == {k: torch.mean(torch.stack([m[k] for m in want])) for k in want[0]}


def test_device_constants_are_made_once():
    a = np.linspace(0.0, 1.0, 7, dtype=np.float32)
    t = device_constant(a, "cpu")
    assert device_constant(a.copy(), "cpu") is t
    assert np.array_equal(t.numpy(), a) and t.dtype == torch.float32
    a[0] = 5.0  # the constant is a copy, not a view of the array
    assert float(t[0]) == 0.0
    with torch.inference_mode():
        u = device_constant(np.arange(3), "cpu", key=("test", 3))
    assert not u.is_inference() and device_constant(None, "cpu", key=("test", 3)) is u
    # a dtype numpy lacks: cast as a Python scalar is, and kept apart from the f64 form
    b = device_constant(np.float64(0.3), "cpu", dtype=torch.bfloat16)
    assert torch.equal(b, torch.tensor([0.3], dtype=torch.bfloat16)) and float(b) == 0.30078125
    assert device_constant(np.float64(0.3), "cpu", dtype=torch.bfloat16) is b
    assert device_constant(np.float64(0.3), "cpu").dtype == torch.float64


def test_launch_registry_reads_writes_and_adds():
    saved = launches_lib.read()
    try:
        launches_lib.reset()
        assert set(launches_lib.read().values()) == {0}
        launches_lib.write({"cqt_project": 2, "conv1d_weight": 1})
        launches_lib.add(launches_lib.delta({k: 0 for k in saved}, launches_lib.read()), 3)
        got = launches_lib.read()
        assert got["cqt_project"] == 8 and got["conv1d_weight"] == 4
        from sot_tpu_torch.ops.kernels import conv, cqt
        assert cqt.launches == 8 and conv.dw_launches == 4
    finally:
        launches_lib.write(saved)


def test_checkpoint_round_trip_with_a_tensor_lr(tmp_path, one_thread):
    """A tensor lr is saved as its value and restored in place (the tensor a
    captured graph reads keeps its address); Adam's steps go where the live
    optimizer keeps them; a restore drops the state's graph."""
    cfg = get_experiment("SOT-2048", **TINY)
    x_all = _train_split(cfg, "cpu")
    mod, state = _fresh(cfg, "cpu")
    trainer.train_steps(mod, state, x_all, [0, 8])
    for g in state.optimizer.param_groups:
        g["lr"] = torch.tensor(g["lr"], dtype=torch.float32)
    path = ckpt_lib.save(str(tmp_path), mod, state, state.step, tag="last")
    written = ckpt_lib.load(path)
    assert isinstance(written["optimizer"]["param_groups"][0]["lr"], torch.Tensor)

    fresh, fresh_state = _fresh(cfg.replace(seed=3), "cpu")
    live = torch.tensor(0.5)
    for g in fresh_state.optimizer.param_groups:
        g["lr"] = live
    fresh_state.graph = object()
    assert ckpt_lib.restore(path, fresh, fresh_state) == 2
    assert fresh_state.graph is None
    assert fresh_state.optimizer.param_groups[0]["lr"] is live
    assert float(live) == float(state.optimizer.param_groups[0]["lr"])
    for (_, sa), (_, sb) in zip(state.optimizer.state.items(),
                                fresh_state.optimizer.state.items()):
        assert sb["step"].device.type == "cpu"
        assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert all(torch.equal(v, fresh.encoder.state_dict()[k])
               for k, v in mod.encoder.state_dict().items())
    assert torch.equal(fresh_state.generator.get_state(), state.generator.get_state())


def test_checkpoint_steps_follow_the_live_optimizer(tmp_path):
    """A capturable Adam's state (device steps, flag on) loaded into the
    CPU's Adam: the flag stays off and the steps come to the CPU; the
    reverse keeps the flag on (the card case, on a CPU parameter here)."""
    p = torch.nn.Parameter(torch.ones(3))
    capt = torch.optim.Adam([p], lr=1e-3)
    capt.param_groups[0]["capturable"] = True
    p.grad = torch.ones(3)
    plain = torch.optim.Adam([torch.nn.Parameter(torch.ones(3))], lr=1e-3)
    plain_state = {"state": {0: {"step": torch.tensor(4.0), "exp_avg": torch.ones(3),
                                 "exp_avg_sq": torch.ones(3)}},
                   "param_groups": [dict(capt.state_dict()["param_groups"][0],
                                         capturable=True)]}
    ckpt_lib.load_optimizer_state(plain, plain_state)
    assert plain.param_groups[0]["capturable"] is False
    assert plain.state[plain.param_groups[0]["params"][0]]["step"].dtype == torch.float32
    ckpt_lib.load_optimizer_state(capt, dict(plain_state, param_groups=[
        dict(plain_state["param_groups"][0], capturable=False)]))
    assert capt.param_groups[0]["capturable"] is True


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

ROUTES = [("SOT-2048", JAX_AUTO), ("SOT-2048", "default"), ("SOT-2048", GATED),
          ("SOT-512", JAX_AUTO)]
ROUTE_IDS = ["sot2048-auto", "sot2048-default", "sot2048-gated", "sot512-auto"]


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


def _state_equal(mod_a, st_a, mod_b, st_b):
    pa, pb = mod_a.encoder.state_dict(), mod_b.encoder.state_dict()
    params = all(torch.equal(pa[k], pb[k]) for k in pa)
    adam = all(torch.equal(sa[k], sb[k])
               for (_, sa), (_, sb) in zip(st_a.optimizer.state.items(),
                                           st_b.optimizer.state.items()) for k in sa)
    gen = torch.equal(st_a.generator.get_state(), st_b.generator.get_state())
    return params, adam, gen


@pytest.mark.cuda
@pytest.mark.parametrize("name,kernels", ROUTES, ids=ROUTE_IDS)
def test_graph_replays_equal_eager_steps_on_card(name, kernels, deterministic):
    _need_cuda()
    cfg = get_experiment(name)
    x_all = _train_split(cfg, "cuda")
    offsets = [0, 64, 128, 192]
    mod_a, st_a = _fresh(cfg, "cuda", kernels)
    logs_a = trainer.train_steps(mod_a, st_a, x_all, offsets)
    mod_b, st_b = _fresh(cfg, "cuda", kernels)
    logs_b = trainer.train_steps_graph(mod_b, st_b, x_all, offsets)
    assert {k: float(v) for k, v in logs_a.items()} == {k: float(v) for k, v in logs_b.items()}
    assert _state_equal(mod_a, st_a, mod_b, st_b) == (True, True, True)
    assert st_b.step == 4 and int(st_b.graph.step) == 4
    assert st_b.scheduler.last_epoch == st_a.scheduler.last_epoch == 4


@pytest.mark.cuda
def test_replays_count_their_launches_on_card():
    _need_cuda()
    cfg = get_experiment("SOT-2048")
    x_all = _train_split(cfg, "cuda")
    mod, state = _fresh(cfg, "cuda")
    launches_lib.reset()
    graph = trainer.TrainGraph(mod, state, x_all)
    warm = launches_lib.read()  # the warm-up's eager steps launched for real
    per = graph.launches
    assert all(per[k] > 0 for k in ("cqt_project", "synth_render", "synth_backward",
                                    "merge_coupling", "ref_grad_beta"))
    assert all(warm[k] == trainer.GRAPH_WARMUP * per[k] for k in per)
    graph([0, 64, 128, 192, 256])
    assert launches_lib.read() == {k: warm[k] + 5 * per[k] for k in per}


@pytest.mark.cuda
def test_checkpoints_resume_across_paths_on_card(tmp_path, deterministic):
    """2 eager steps, a checkpoint, 2 graph replays from it (and the
    reverse) equal 4 unbroken steps bit for bit."""
    _need_cuda()
    cfg = get_experiment("SOT-2048")
    x_all = _train_split(cfg, "cuda")
    offsets = [0, 64, 128, 192]
    mod_u, st_u = _fresh(cfg, "cuda")
    trainer.train_steps_graph(mod_u, st_u, x_all, offsets)
    for first, second in ((trainer.train_steps, trainer.train_steps_graph),
                          (trainer.train_steps_graph, trainer.train_steps)):
        mod, st = _fresh(cfg, "cuda")
        first(mod, st, x_all, offsets[:2])
        path = ckpt_lib.save(str(tmp_path), mod, st, st.step, tag=first.__name__)
        mod_r, st_r = _fresh(cfg.replace(seed=7), "cuda")
        assert ckpt_lib.restore(path, mod_r, st_r) == 2
        second(mod_r, st_r, x_all, offsets[2:])
        assert _state_equal(mod_u, st_u, mod_r, st_r) == (True, True, True), first.__name__


@pytest.mark.cuda
def test_eval_graph_equals_eager_eval_on_card():
    _need_cuda()
    cfg = get_experiment("SOT-2048", eval_comb_correction=True)
    split = tdata.dataset_from_config(cfg, device="cuda")["val"]
    mod, _ = _fresh(cfg, "cuda")
    xs = torch.as_tensor(split.x[:192].reshape(3, 64, -1), device="cuda")
    f0s = torch.as_tensor(split.frequency[:192].reshape(3, 64, 1), device="cuda")
    launches_lib.reset()
    got = trainer.make_eval_all(mod)(xs, f0s)
    assert launches_lib.read()["cqt_project"] > 0
    step = trainer.make_eval_step(mod)
    ms = [step(x, f0) for x, f0 in zip(xs, f0s)]
    want = {k: torch.mean(torch.stack([m[k] for m in ms])) for k in ms[0]}
    assert {k: float(v) for k, v in got.items()} == {k: float(v) for k, v in want.items()}


CAPTURE_UNSAFE = """
import numpy as np, torch
from sot_tpu_torch.configs import get_experiment
from sot_tpu_torch.training import trainer
cfg = get_experiment("SOT-2048")
mod = trainer.build_modules(cfg, device="cuda")
state = trainer.init_state(mod)
x_all = torch.rand((128, cfg.n_samples), device="cuda") - 0.5
real = trainer.compute_loss
def unsafe(mod, x, **kw):  # a host-to-device copy inside the step
    return real(mod, x + torch.as_tensor(np.float32(0.0), device=x.device), **kw)
trainer.compute_loss = unsafe
try:
    trainer.train_steps_graph(mod, state, x_all, [0, 64])
except RuntimeError as exc:
    print("raised:", type(exc).__name__, str(exc).splitlines()[0][:200])
    raise SystemExit(3)
print("captured")
"""


@pytest.mark.cuda
def test_capture_unsafe_step_raises_on_card():
    """A step that copies from the host cannot be captured: the capture
    raises, and nothing falls back to the eager loop (in a child process, so
    the failed capture cannot touch the other tests)."""
    _need_cuda()
    proc = subprocess.run([sys.executable, "-c", CAPTURE_UNSAFE], cwd=ROOT, text=True,
                          capture_output=True, timeout=600)
    assert proc.returncode == 3, proc.stdout + proc.stderr
    assert "raised:" in proc.stdout
