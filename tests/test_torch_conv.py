"""Kernels B10 and B11 (the encoder's k > 1 'same' convs) against
``sot_tpu.ops.pallas.conv``: ``conv1d_same``'s value and both gradients
against the JAX package's ``conv1d_same`` (interpret mode, as
``tests/test_conv_pallas.py`` runs it), in float32 and in the default bf16
operand type, at that file's SHAPES; and the encoder under the conv gate.

The port's layout is NCW with weights [C_out, C_in, k]; the JAX function
takes NWC and [k, C_in, C_out]: the tests transpose between the two.

Tolerances: values and dx within 1e-5 of their max, dW within 1e-5 of its
max, in both operand types: both round the same operands to the same type
(round to nearest even), every product of two bf16 values is exact in f32,
and only the order of the f32 sums differs. The bf16 rounding itself is
checked bit for bit against JAX's.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from sot_tpu.ops.pallas import conv as jconv  # noqa: E402
from sot_tpu_torch.models.encoder import KernelConv1d, PESTOEncoder  # noqa: E402
from sot_tpu_torch.ops.kernels import conv as kconv  # noqa: E402
from test_conv_pallas import SHAPES  # noqa: E402
from test_torch_plane import _assert_close  # noqa: E402

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _case(b, w, cin, cout, k, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, cin, w)).astype(np.float32)
    weight = (rng.standard_normal((cout, cin, k)) / (k * cin)).astype(np.float32)
    dy = rng.standard_normal((b, cout, w)).astype(np.float32)
    return x, weight, dy


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("b,w,cin,cout,k", SHAPES)
def test_conv1d_same_and_its_gradients_match_jax(monkeypatch, b, w, cin, cout, k, dtype):
    monkeypatch.setenv("SOT_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("SOT_TPU_CONV_DTYPE", dtype)
    x, weight, dy = _case(b, w, cin, cout, k, seed=b * 1000 + w + k)
    y_ref, vjp = jax.vjp(lambda xx, kk: jconv.conv1d_same(xx, kk, k),
                         jnp.asarray(x.transpose(0, 2, 1)), jnp.asarray(weight.transpose(2, 1, 0)))
    dx_ref, dk_ref = vjp(jnp.asarray(dy.transpose(0, 2, 1)))

    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(weight).requires_grad_(True)
    y = kconv.conv1d_same(xt, wt, DTYPES[dtype])
    y.backward(torch.from_numpy(dy))
    _assert_close(y.detach().numpy(), np.asarray(y_ref).transpose(0, 2, 1), 1e-5)
    _assert_close(xt.grad.numpy(), np.asarray(dx_ref).transpose(0, 2, 1), 1e-5)
    _assert_close(wt.grad.numpy(), np.asarray(dk_ref).transpose(2, 1, 0), 1e-5)


def test_bf16_rounding_is_jax_rounding():
    """``round_to`` rounds as JAX's cast does (nearest even), ties and
    subnormals included."""
    rng = np.random.default_rng(0)
    v = np.concatenate([rng.standard_normal(4096) * 10.0 ** rng.integers(-40, 38, 4096),
                        # exact ties between two bf16 values: the low 16 bits 0x8000
                        # (finite: the upper half below the exponent 0xff)
                        (rng.integers(0, 0x7f80, 512).astype(np.uint32) << 16 | 0x8000)
                        .view(np.float32)]).astype(np.float32)
    got = kconv.round_to(torch.from_numpy(v), torch.bfloat16).numpy()
    ref = np.asarray(jnp.asarray(v).astype(jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))


def test_encoder_state_dict_is_unchanged_under_the_conv_gate():
    """The conv gate swaps conv1 and the prefilter onto ``KernelConv1d``
    with the same parameters, initialisation and state-dict keys (JAX's
    ``test_encoder_pallas_conv_gate`` asserts the same for its param tree);
    in float32 the outputs are those of ``nn.Conv1d``."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((4, 285)).astype(np.float32))
    base = PESTOEncoder(generator=torch.Generator().manual_seed(1)).eval()
    sd = base.state_dict()
    for dtype in (torch.float32, torch.bfloat16):
        gated = PESTOEncoder(generator=torch.Generator().manual_seed(1), conv_dtype=dtype).eval()
        assert isinstance(gated.conv1, KernelConv1d) and isinstance(gated.prefilt[0], KernelConv1d)
        assert not isinstance(gated.conv2, KernelConv1d)
        gsd = gated.state_dict()
        assert list(gsd) == list(sd)
        assert all(torch.equal(gsd[k], sd[k]) for k in sd)
    gated = PESTOEncoder(conv_dtype=torch.float32).eval()
    gated.load_state_dict(sd)
    got, ref = gated(x), base(x)
    for key in ref:
        _assert_close(got[key].detach().numpy(), ref[key].detach().numpy(), 1e-5)


def test_conv_wrappers_take_plain_version_on_cpu():
    x, weight, dy = (torch.from_numpy(a) for a in _case(3, 33, 2, 4, 5, seed=0))
    before = (kconv.launches, kconv.dw_launches)
    y = kconv.conv1d_forward(x, weight)
    dw = kconv.conv1d_weight(x, dy, 5)
    assert (kconv.launches, kconv.dw_launches) == before
    assert torch.equal(y, kconv.conv1d_same_plain(x, weight))
    assert torch.equal(dw, kconv.conv1d_weight_plain(x, dy, 5))
    meta = x.to("meta")
    with pytest.raises(ValueError, match="conv1d_forward"):
        kconv.conv1d_forward(meta, weight.to("meta"))
    with pytest.raises(ValueError, match="conv1d_weight"):
        kconv.conv1d_weight(meta, dy.to("meta"), 5)
