"""``KernelGates.conv_bf16`` against the JAX package's ``SOT_TPU_CONV_BF16``:
the encoder's conv stack in bf16 as Flax's ``nn.Conv(dtype=bfloat16)``
computes it, alone and with the conv kernels (``conv=True`` beside
``SOT_TPU_CONV_PALLAS=1`` in interpret mode), on the same numpy-seeded
features and converted parameters; and the gate's place in
``KernelGates`` and ``build_modules``.

Tolerances, ~2x the readings of a CPU run (max|d|/max of the heads' outputs;
each parameter leaf's gradient of a fixed linear function of the outputs,
and its least cosine):
  * gate alone: outputs 5.9e-05 (frequency) / 1.4e-05 (weights); leaves
    2.4e-02, cosine 0.99984. A handful of bf16 conv outputs round to the
    other neighbour where the two libraries sum in other orders, and the
    backward in bf16 carries those moves on.
  * with the conv kernels: outputs 1.3e-06 / 4.9e-07 (the bf16 stack is the
    1x1 convs only); leaves 1.8e-02, cosine 0.99987.
The ungated port reads 3.3e-03 / 5.1e-04 against JAX's bf16 encoder, so the
output limits also show that the gate computes in bf16. The one rounding
that had to be mirrored: Flax's ``leaky_relu`` multiplies bf16 activations
by the slope rounded to bf16 (0.30078125).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from sot_tpu.models import encoder as jenc  # noqa: E402
from sot_tpu_torch.configs import get_experiment  # noqa: E402
from sot_tpu_torch.convert import grads_to_flax, params_from_flax  # noqa: E402
from sot_tpu_torch.kernel_gates import ADOPTION_DIR, PRESETS, KernelGates  # noqa: E402
from sot_tpu_torch.kernel_gates import _convbf16_gate  # noqa: E402
from sot_tpu_torch.models import encoder as tenc  # noqa: E402
from sot_tpu_torch.training import trainer as ttrainer  # noqa: E402
from tests._torch_parity import jax_init_params, rel_max_err  # noqa: E402

# conv kernels off / on: (frequency, weights) outputs, per-leaf gradient,
# least cosine
LIMITS = {False: (1.2e-4, 3e-5, 5e-2, 0.9997), True: (3e-6, 1e-6, 4e-2, 0.9997)}
ENV = ("SOT_TPU_CONV_BF16", "SOT_TPU_CONV_PALLAS", "SOT_TPU_PALLAS_INTERPRET",
       "SOT_TPU_CONV_DTYPE")


@pytest.fixture(scope="module")
def params():
    return jax_init_params(seed=3)


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("conv", [False, True], ids=["alone", "with-conv-kernels"])
def test_conv_bf16_encoder_matches_jax(monkeypatch, params, conv):
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("SOT_TPU_CONV_BF16", "1")
    if conv:
        monkeypatch.setenv("SOT_TPU_CONV_PALLAS", "1")
        monkeypatch.setenv("SOT_TPU_PALLAS_INTERPRET", "1")
    rng = np.random.default_rng(0)
    feats = np.abs(rng.standard_normal((12, 285))).astype(np.float32)
    cot = {"frequency": rng.standard_normal((12, 285)).astype(np.float32),
           "weights": rng.standard_normal((12, 20)).astype(np.float32)}
    model = jenc.PESTOEncoder(n_bins_in=285, output_size=285, n_modes=20)

    def f(p):
        out = model.apply(p, jnp.asarray(feats), train=False)
        return sum(jnp.sum(out[k] * cot[k]) for k in cot), out

    (_, ref), gref = jax.value_and_grad(f, has_aux=True)(jax.tree.map(jnp.asarray, params))

    enc = tenc.PESTOEncoder(conv_dtype=torch.bfloat16 if conv else None, conv_bf16=True).eval()
    enc.load_state_dict(params_from_flax(params))
    out = enc(torch.from_numpy(feats))
    sum((out[k] * torch.from_numpy(cot[k])).sum() for k in cot).backward()

    lim_f, lim_w, lim_g, lim_cos = LIMITS[conv]
    for key, lim in (("frequency", lim_f), ("weights", lim_w)):
        assert out[key].dtype == torch.float32
        assert rel_max_err(out[key].detach().numpy(), ref[key]) <= lim, key
    gj = _leaves(gref)
    for name, g in _leaves(grads_to_flax(enc)).items():
        r = gj[name]
        assert rel_max_err(g, r) <= lim_g, name
        assert float(np.sum(g * r) / np.linalg.norm(g) / np.linalg.norm(r)) >= lim_cos, name


def test_conv_bf16_modules_activations_and_state_dict():
    """Every conv is a ``Bf16Conv1d`` (the k > 1 ones stay ``KernelConv1d``
    under the conv gate), the activations between them are bf16, the heads
    read f32, and the state dict is the ungated encoder's."""
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((4, 285)).astype(np.float32))
    base = tenc.PESTOEncoder(generator=torch.Generator().manual_seed(1)).eval()
    for conv_dtype in (None, torch.bfloat16):
        enc = tenc.PESTOEncoder(generator=torch.Generator().manual_seed(1), conv_dtype=conv_dtype,
                                conv_bf16=True).eval()
        wide = tenc.KernelConv1d if conv_dtype else tenc.Bf16Conv1d
        assert isinstance(enc.conv1, wide) and isinstance(enc.prefilt[0], wide)
        assert all(type(m) is tenc.Bf16Conv1d
                   for m in (enc.conv2, enc.conv3, enc.conv4a, enc.conv4b))
        sd, bsd = enc.state_dict(), base.state_dict()
        assert list(sd) == list(bsd) and all(torch.equal(sd[k], bsd[k]) for k in sd)
        seen = {}
        for name in ("conv1", "conv2", "conv4b"):
            getattr(enc, name).register_forward_hook(
                lambda m, i, o, name=name: seen.__setitem__(name, o.dtype))
        out = enc(x)
        assert seen == {"conv1": torch.float32 if conv_dtype else torch.bfloat16,
                        "conv2": torch.bfloat16, "conv4b": torch.bfloat16}
        assert all(v.dtype == torch.float32 for v in out.values())


def test_conv_bf16_gate_validated_off_in_presets_and_threaded():
    assert PRESETS["auto"].conv_bf16 == _convbf16_gate(ADOPTION_DIR)
    assert not PRESETS["default"].conv_bf16
    assert not KernelGates(w2_merge="ref", w2_merge_small="hybrid").conv_bf16
    assert not KernelGates().conv_bf16
    with pytest.raises(ValueError, match="conv_bf16"):
        KernelGates(conv_bf16=1)
    cfg = get_experiment("SOT-2048")
    mod = ttrainer.build_modules(cfg, device="cpu", kernels=KernelGates(conv_bf16=True))
    assert type(mod.encoder.conv1) is tenc.Bf16Conv1d
    assert type(mod.encoder.conv2) is tenc.Bf16Conv1d
    auto = ttrainer.build_modules(cfg, device="cpu", kernels="default")
    assert type(auto.encoder.conv2) is torch.nn.Conv1d
